"""Batched wildcard-template matching: the CUDA kernel, its plain torch
version, and its launch count.

Replaces the Pallas kernel ``_match_kernel`` behind
``repro.kernels.wildcard_match.wildcard_match`` of the JAX package. The
kernel is ``csrc/wildcard_match.cu``: one thread per (line, template)
pair, the DP column held as a bit mask of at most 8 words (its note says
what bounds it on the H100 and how the design meets that).
``wildcard_match`` launches it for tensors on a CUDA device and runs
``wildcard_match_plain`` for tensors on the CPU; there is no other path.

The DP (``core.match``): literal ``col[i] = prev[i-1] & (log[i-1] ==
t_j)``, star ``col[i] = OR_{i'<i} prev[i']``, read at ``i = len``.
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


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


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


def _lib() -> ctypes.CDLL:
    lib = build.load("wildcard_match")
    fn = lib.wildcard_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def wildcard_match(logs: torch.Tensor, lens: torch.Tensor, templates: torch.Tensor,
                   t_lens: torch.Tensor) -> torch.Tensor:
    """(N, T), (N,) x (K, Tt), (K,) int32 -> (N, K) bool match matrix.

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
    if logs.device.type == "cpu":
        return wildcard_match_plain(logs, lens, templates, t_lens)
    if logs.device.type != "cuda":
        raise ValueError(f"no wildcard_match kernel for device {logs.device}")
    if t > MAX_T:
        raise ValueError(f"the wildcard_match kernel takes lines of at most {MAX_T} "
                         f"tokens, got T={t}")
    if not all(x.is_contiguous() for x in (logs, lens, templates, t_lens)):
        raise ValueError("wildcard_match takes contiguous tensors")
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
