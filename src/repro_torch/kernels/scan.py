"""Weighted histogram of an inverse index (the compressed-domain scan):
the CUDA kernel, its plain torch version, and its launch count.

Replaces the Pallas kernel ``_distinct_counts_kernel`` behind
``repro.kernels.scan.distinct_counts`` of the JAX package. The kernel is
``csrc/distinct_counts.cu`` (its note says what bounds it on the H100 and
how the design meets that). ``distinct_counts`` launches it for tensors
on a CUDA device and runs ``distinct_counts_plain`` for tensors on the
CPU; there is no other path.

``out[b]`` is the sum of ``weights[i]`` over the rows with ``inv[i] ==
b``, in int32 wraparound arithmetic; rows whose ``inv`` lies outside
``[0, n_bins)`` add nothing. The query engine's aggregations
(``core.query``: count_by_template, top_k, time_histogram) call it once
per chunk on the inverse index of the chunk's distinct values.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .counters import LaunchCount

_LAUNCHES = LaunchCount()


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _LAUNCHES.value()


def reset_launches() -> None:
    _LAUNCHES.reset()


def distinct_counts_plain(inv: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain torch version: int64 sums of the rows in range, reduced mod
    2**32 to int32 (the bits of the int32 wraparound sum)."""
    valid = (inv >= 0) & (inv < n_bins)
    acc = torch.zeros(n_bins, dtype=torch.int64, device=inv.device)
    acc.index_add_(0, inv[valid].to(torch.int64), weights[valid].to(torch.int64))
    acc &= 0xFFFFFFFF
    return (acc - ((acc >> 31) << 32)).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = build.load("distinct_counts")
    fn = lib.distinct_counts_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.distinct_counts_small_rows.argtypes = []
        lib.distinct_counts_small_rows.restype = ctypes.c_longlong
    return lib


def small_rows() -> int:
    """Rows up to which the kernel runs as one thread-block cluster; above
    it, as one cooperative grid. Either is one launch that writes every
    bin. Builds the kernel."""
    return int(_lib().distinct_counts_small_rows())


def distinct_counts(inv: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(N,) int32 inverse index + (N,) int32 weights -> (n_bins,) int32
    weighted bin counts.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    torch version."""
    if inv.dim() != 1 or weights.shape != inv.shape:
        raise ValueError(f"inv and weights must be 1-D of one length, got "
                         f"{tuple(inv.shape)} and {tuple(weights.shape)}")
    for name, x in (("inv", inv), ("weights", weights)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if weights.device != inv.device:
        raise ValueError(f"weights is on {weights.device}, inv on {inv.device}")
    if not 0 <= n_bins < 1 << 31:
        raise ValueError(f"n_bins must be in [0, 2**31), got {n_bins}")
    if inv.device.type == "cpu":
        return distinct_counts_plain(inv, weights, n_bins)
    if inv.device.type != "cuda":
        raise ValueError(f"no distinct_counts kernel for device {inv.device}")
    if not (inv.is_contiguous() and weights.is_contiguous()):
        raise ValueError("distinct_counts takes contiguous tensors")
    if inv.numel() == 0 or n_bins == 0:
        return torch.zeros(n_bins, dtype=torch.int32, device=inv.device)
    out = torch.empty(n_bins, dtype=torch.int32, device=inv.device)  # the launcher writes it all
    with torch.cuda.device(inv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().distinct_counts_launch(inv.data_ptr(), weights.data_ptr(), out.data_ptr(),
                                           inv.numel(), n_bins, stream)
    if rc:
        raise RuntimeError(f"distinct_counts kernel launch failed: CUDA error {rc}")
    _LAUNCHES.add()
    return out
