"""Wildcard-template matching: the two CUDA kernels, their plain torch
versions, and their launch counts.

Replaces the Pallas kernel ``_match_kernel`` behind
``repro.kernels.wildcard_match.wildcard_match`` of the JAX package, and
the per-bucket composition around it (``repro.kernels.ops.
match_first_bucketed``). Both kernels are in ``csrc/wildcard_match.cu``
and share one DP, the column held as a bit mask of at most 8 words (its
note says what bounds each on the H100 and how the design meets that):

- ``wildcard_match_first``, the main path (``core.match.match_first``
  through ``ops.match_first_bucketed``): one warp per line walks the
  line's first-token bucket merged with the star-first templates, 32
  candidates at a time, and stops at the first group that holds a hit ->
  (N,) int32 lowest matching id, -1 for none;
- ``wildcard_match``: one thread per (line, template) pair -> the (N, K)
  bool matrix, the function-level counterpart of the Pallas kernel.

Each launches its kernel for tensors on a CUDA device and runs its plain
version for tensors on the CPU; there is no other path.

The DP (``core.match``): literal ``col[i] = prev[i-1] & (log[i-1] ==
t_j)``, star ``col[i] = OR_{i' < i} prev[i']``, read at ``i = len``.
Templates with ``t_len < 0`` and lines with ``len > T`` match nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

PAD_ID = 0
STAR_ID = 1

MAX_T = 255  # the kernel holds a column of T+1 bits in at most 8 words
# rows of lines per step of the plain version, so that its (rows, K, T+1)
# boolean tiles stay near this many elements
_PLAIN_TILE = 1 << 24
_LAUNCHES = 0
_FIRST_LAUNCHES = 0


def launches() -> int:
    """Launches of the (N, K) kernel since the last ``reset_launches``."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def first_launches() -> int:
    """Launches of the first-hit kernel since the last ``reset_first_launches``."""
    return _FIRST_LAUNCHES


def reset_first_launches() -> None:
    global _FIRST_LAUNCHES
    _FIRST_LAUNCHES = 0


def _plain_rows(logs, lens, templates, t_lens) -> torch.Tensor:
    n, t = logs.shape
    k, tt = templates.shape
    pos = torch.arange(t + 1, device=logs.device)
    col = (pos == 0).expand(n, k, t + 1).clone()  # (N, K, T+1) reachability
    for j in range(tt):
        tj = templates[:, j]
        # star: every position strictly after the first reachable one
        first = col.to(torch.uint8).argmax(dim=2, keepdim=True)
        star_col = (pos > first) & col.any(dim=2, keepdim=True)
        # literal: advance one position where the log token equals t_j
        lit_col = torch.zeros_like(col)
        lit_col[:, :, 1:] = col[:, :, :-1] & (logs[:, None, :] == tj[None, :, None])
        new = torch.where((tj == STAR_ID)[None, :, None], star_col, lit_col)
        col = torch.where((j < t_lens)[None, :, None], new, col)
    idx = lens.to(torch.int64).clamp(0, t)[:, None, None].expand(n, k, 1)
    matched = torch.gather(col, 2, idx)[:, :, 0]
    return matched & (lens <= t)[:, None] & (t_lens >= 0)[None, :]


def wildcard_match_plain(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                         t_lens: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the reachability DP (the layout of the JAX
    package's ``ref.wildcard_match_ref``), over row blocks of lines."""
    n, t = logs.shape
    k = templates.shape[0]
    if n == 0 or k == 0:
        return torch.zeros((n, k), dtype=torch.bool, device=logs.device)
    step = max(1, _PLAIN_TILE // (k * (t + 1)))
    return torch.cat([_plain_rows(logs[s:s + step], lens[s:s + step], templates, t_lens)
                      for s in range(0, n, step)], dim=0)


def wildcard_match_first_plain(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                               t_lens: torch.Tensor, line_bucket: torch.Tensor,
                               bucket_ptr: torch.Tensor, bucket_tpl: torch.Tensor,
                               star_tpl: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``wildcard_match_first``: the (N, K) DP of
    ``wildcard_match_plain`` over each bucket's lines and templates and
    over every line and the star-first templates, then any / argmax /
    min of the lowest matching id, as the JAX package's
    ``match_first_bucketed`` composes them on the host."""
    n, k = logs.shape[0], templates.shape[0]
    best = torch.full((n,), k, dtype=torch.int64, device=logs.device)  # k: no match

    def run(rows: torch.Tensor, tidx: torch.Tensor) -> None:
        tidx = tidx.to(torch.int64)
        sub = wildcard_match_plain(logs[rows], lens[rows], templates[tidx], t_lens[tidx])
        hit = sub.any(dim=1)
        # tidx is ascending: the first True is the lowest id of the list
        cand = tidx[sub.to(torch.uint8).argmax(dim=1)]
        best[rows] = torch.where(hit, torch.minimum(best[rows], cand), best[rows])

    ptr = bucket_ptr.tolist()
    for b in torch.unique(line_bucket[line_bucket >= 0]).tolist():
        tidx = bucket_tpl[ptr[b]:ptr[b + 1]]
        if tidx.numel():
            run(torch.nonzero(line_bucket == b).flatten(), tidx)
    if star_tpl.numel() and n:
        run(torch.arange(n, device=logs.device), star_tpl)
    return torch.where(best < k, best, -1).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = build.load("wildcard_match")
    fn = lib.wildcard_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.wildcard_first_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] \
            + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(entry: str, logs: torch.Tensor, named) -> None:
    """Raise on what the kernels do not take: ``named`` holds (name,
    tensor, shape), a shape of None being any 1-D length."""
    for name, x, shape in named:
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != logs.device:
            raise ValueError(f"{name} is on {x.device}, logs on {logs.device}")
        if (x.dim() != 1) if shape is None else (tuple(x.shape) != shape):
            raise ValueError(f"{name} must have shape {shape or '(L,)'}, got {tuple(x.shape)}")
    if logs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {entry} kernel for device {logs.device}")
    if logs.device.type == "cuda":
        if logs.shape[1] > MAX_T:
            raise ValueError(f"the {entry} kernel takes lines of at most {MAX_T} tokens, "
                             f"got T={logs.shape[1]}")
        if not all(x.is_contiguous() for _, x, _ in named):
            raise ValueError(f"{entry} takes contiguous tensors")


def _dims(logs: torch.Tensor, templates: torch.Tensor) -> tuple[int, int, int, int]:
    if logs.dim() != 2 or templates.dim() != 2:
        raise ValueError(f"logs and templates must be 2-D, got {tuple(logs.shape)} "
                         f"and {tuple(templates.shape)}")
    return (*logs.shape, *templates.shape)


def wildcard_match_first(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                         t_lens: torch.Tensor, line_bucket: torch.Tensor,
                         bucket_ptr: torch.Tensor, bucket_tpl: torch.Tensor,
                         star_tpl: torch.Tensor) -> torch.Tensor:
    """(N, T), (N,) x (K, Tt), (K,) int32, each line's first-token bucket
    ``line_bucket`` (N,) (-1: none), the buckets' ascending template ids
    as CSR ``bucket_ptr`` (B+1,) / ``bucket_tpl``, and the ascending
    star-first ids ``star_tpl`` -> (N,) int32: the lowest id among the
    line's bucket and ``star_tpl`` that matches it, -1 for none.

    CUDA tensors launch the first-hit kernel (or raise); CPU tensors run
    the plain torch version. Only shapes, types and devices are checked,
    so that the call needs no host sync."""
    n, t, k, tt = _dims(logs, templates)
    if bucket_ptr.dim() != 1 or bucket_ptr.numel() < 1:
        raise ValueError(f"bucket_ptr must be (B+1,), got {tuple(bucket_ptr.shape)}")
    named = (("logs", logs, (n, t)), ("lens", lens, (n,)), ("templates", templates, (k, tt)),
             ("t_lens", t_lens, (k,)), ("line_bucket", line_bucket, (n,)),
             ("bucket_ptr", bucket_ptr, None), ("bucket_tpl", bucket_tpl, None),
             ("star_tpl", star_tpl, None))
    _check("wildcard_match_first", logs, named)
    if logs.device.type == "cpu":
        return wildcard_match_first_plain(logs, lens, templates, t_lens, line_bucket,
                                          bucket_ptr, bucket_tpl, star_tpl)
    out = torch.empty((n,), dtype=torch.int32, device=logs.device)
    if n == 0:
        return out
    with torch.cuda.device(logs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().wildcard_first_launch(
            logs.data_ptr(), lens.data_ptr(), templates.data_ptr(), t_lens.data_ptr(),
            line_bucket.data_ptr(), bucket_ptr.data_ptr(), bucket_tpl.data_ptr(),
            star_tpl.data_ptr(), bucket_ptr.numel() - 1, star_tpl.numel(), out.data_ptr(),
            n, t, k, tt, stream)
    if rc:
        raise RuntimeError(f"wildcard_match_first kernel launch failed: CUDA error {rc}")
    global _FIRST_LAUNCHES
    _FIRST_LAUNCHES += 1
    return out


def wildcard_match(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                   t_lens: torch.Tensor) -> torch.Tensor:
    """(N, T), (N,) x (K, Tt), (K,) int32 -> (N, K) bool match matrix.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    torch version."""
    n, t, k, tt = _dims(logs, templates)
    _check("wildcard_match", logs, (("logs", logs, (n, t)), ("lens", lens, (n,)),
                                    ("templates", templates, (k, tt)),
                                    ("t_lens", t_lens, (k,))))
    if logs.device.type == "cpu":
        return wildcard_match_plain(logs, lens, templates, t_lens)
    out = torch.empty((n, k), dtype=torch.bool, device=logs.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(logs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().wildcard_match_launch(
            logs.data_ptr(), lens.data_ptr(), templates.data_ptr(), t_lens.data_ptr(),
            out.data_ptr(), n, t, k, tt, stream)
    if rc:
        raise RuntimeError(f"wildcard_match kernel launch failed: CUDA error {rc}")
    global _LAUNCHES
    _LAUNCHES += 1
    return out
