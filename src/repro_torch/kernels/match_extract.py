"""Fused wildcard match + parameter-span extraction: the CUDA kernel, its
plain torch version, and its launch count.

Replaces the Pallas kernel ``_me_kernel`` behind
``repro.kernels.match_extract.match_extract`` of the JAX package. The
kernel is ``csrc/match_extract.cu``: a block stages a tile of lines and
the templates in shared memory, one thread runs the templates that can
match its line in ascending id as one flat loop until the first hit,
with the DP column as a bit mask, and the tile's spans leave as one
coalesced run (its note says what bounds it on the H100 and how the
design meets that).
``match_extract`` launches it for tensors on a CUDA device and runs
``match_extract_plain`` for tensors on the CPU; there is no other path.

Per line, read at ``lc = min(len, T)``: the lowest template id whose
reachability DP (``core.match``) holds column ``lc`` after
``min(t_len, Tt)`` steps, or -1; ``t_len < 0`` and ``lc < 0`` match
nothing. For that template each star's span ``[start, end)`` comes from
the walk back from ``i = lc``: the start is the largest ``i' <= i-1``
reachable just before the star, so later stars take the shortest span
(``core.match.extract_spans_dp``). The span of the template's s-th star
goes to slot s (s < n_slots); every other slot, and the whole row of a
line that matches nothing, is 0. Lines with ``len > T`` are read at
``T`` here, as in the reference kernel; ``ops.match_extract`` masks them.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.tokenizer import STAR_ID
from . import build
from .wildcard_match import MAX_T  # a column of T+1 bits in at most 8 words, as there

_LAUNCHES = 0


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def _one_template(logs, lc, row: list[int], tl: int, n_slots: int):
    """(hit (R,) bool, spans (R, n_slots, 2)) of one template over lines
    ``logs`` read at ``lc``: the forward DP keeping every column, then the
    walk back (the layout of the reference kernel)."""
    r, t = logs.shape
    dev = logs.device
    pos = torch.arange(t + 1, device=dev)
    col = (pos == 0).expand(r, t + 1).clone()
    cols = [col]
    for tj in row[:tl]:
        if tj == STAR_ID:
            first = col.to(torch.uint8).argmax(dim=1, keepdim=True)
            col = (pos[None, :] > first) & col.any(dim=1, keepdim=True)
        else:
            lit = torch.zeros_like(col)
            lit[:, 1:] = col[:, :-1] & (logs == tj)
            col = lit
        cols.append(col)
    ok = lc >= 0
    hit = ok & torch.gather(col, 1, lc.clamp(0, t)[:, None])[:, 0]
    spans = torch.zeros((r, n_slots, 2), dtype=torch.int32, device=dev)
    i = lc.clamp(min=0)
    star = sum(1 for tj in row[:tl] if tj == STAR_ID)
    for j in range(tl, 0, -1):
        if row[j - 1] != STAR_ID:
            i = i - 1
            continue
        star -= 1
        gate = cols[j - 1] & (pos[None, :] <= (i - 1)[:, None])
        ip = (gate * pos[None, :]).amax(dim=1)
        if star < n_slots:
            spans[:, star, 0] = ip.to(torch.int32)
            spans[:, star, 1] = i.to(torch.int32)
        i = ip
    return hit, spans


def match_extract_plain(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                        t_lens: torch.Tensor, n_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: templates in ascending id, each run over the
    lines no lower template has taken."""
    n, t = logs.shape
    tt = templates.shape[1]
    dev = logs.device
    assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
    spans = torch.zeros((n, n_slots, 2), dtype=torch.int32, device=dev)
    lc = lens.to(torch.int64).clamp(max=t)
    rows_of = templates.tolist()
    for kk, tl in enumerate(t_lens.tolist()):
        if tl < 0:
            continue
        todo = torch.nonzero(assign < 0)[:, 0]
        if todo.numel() == 0:
            break
        hit, sp = _one_template(logs[todo], lc[todo], rows_of[kk], min(tl, tt), n_slots)
        rows = todo[hit]
        assign[rows] = kk
        spans[rows] = sp[hit]
    return assign, spans


def _lib() -> ctypes.CDLL:
    lib = build.load("match_extract")
    fn = lib.match_extract_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def match_extract(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                  t_lens: torch.Tensor, n_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, T), (N,) x (K, Tt), (K,) int32 -> (assign (N,) int32, spans
    (N, n_slots, 2) int32).

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    torch version."""
    if logs.dim() != 2 or templates.dim() != 2:
        raise ValueError(f"logs and templates must be 2-D, got {tuple(logs.shape)} "
                         f"and {tuple(templates.shape)}")
    n, t = logs.shape
    k, tt = templates.shape
    for name, x, shape in (("logs", logs, (n, t)), ("lens", lens, (n,)),
                           ("templates", templates, (k, tt)), ("t_lens", t_lens, (k,))):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != logs.device:
            raise ValueError(f"{name} is on {x.device}, logs on {logs.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    n_slots = int(n_slots)
    if n_slots < 1:
        raise ValueError(f"n_slots must be at least 1, got {n_slots}")
    if logs.device.type == "cpu":
        return match_extract_plain(logs, lens, templates, t_lens, n_slots)
    if logs.device.type != "cuda":
        raise ValueError(f"no match_extract kernel for device {logs.device}")
    if t > MAX_T:
        raise ValueError(f"the match_extract kernel takes lines of at most {MAX_T} tokens, "
                         f"got T={t}")
    if not all(x.is_contiguous() for x in (logs, lens, templates, t_lens)):
        raise ValueError("match_extract takes contiguous tensors")
    dev = logs.device
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    spans = torch.empty((n, n_slots, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return assign, spans
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().match_extract_launch(
            logs.data_ptr(), lens.data_ptr(), templates.data_ptr(), t_lens.data_ptr(),
            assign.data_ptr(), spans.data_ptr(), n, t, k, tt, n_slots, stream)
    if rc:
        raise RuntimeError(f"match_extract kernel launch failed: CUDA error {rc}")
    global _LAUNCHES
    _LAUNCHES += 1
    return assign, spans
