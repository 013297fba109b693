"""Typed-column integer transform: the CUDA kernel, its plain torch
version, and its launch count.

Replaces the Pallas kernel ``_colcodec_kernel`` behind
``repro.kernels.colcodec.colcodec_transform`` of the JAX package. The
kernel is ``csrc/colcodec.cu`` (its note says what bounds it on the H100
and how the design meets that). ``colcodec_transform`` launches it for
tensors on a CUDA device and runs ``colcodec_transform_plain`` for
tensors on the CPU; there is no other path.

Semantics, per row of an ``(R, C)`` int32 grid with per-row length, mode
and reference: mode 3 ``v - ref``; mode 1 delta with ``d[0] = 0``; any
other mode (2) ``zigzag(d[i] - d[i-1])``; 0 at positions ``>= len``; all
in 32-bit wraparound arithmetic, output uint32. Callers keep magnitudes
below ``coltypes.KERNEL_SAFE`` so the result equals the host transform.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .counters import LaunchCount

# mode ids — must equal the repro_torch.core.coltypes type ids
MONOTONE_INT = 1
TIMESTAMP = 2
NUMERIC = 3

_MASK32 = 0xFFFFFFFF
_LAUNCHES = LaunchCount()


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _LAUNCHES.value()


def reset_launches() -> None:
    _LAUNCHES.reset()


def colcodec_transform_plain(vals: torch.Tensor, lens: torch.Tensor, mode: torch.Tensor,
                             ref: torch.Tensor) -> torch.Tensor:
    """Plain torch version: int64 arithmetic reduced mod 2**32 (torch has
    no uint32 ``>>`` or subtraction on every device), same layout."""
    r, width = vals.shape
    pos = torch.arange(width, device=vals.device)[None, :]
    in_len = pos < lens.to(torch.int64)[:, None]
    vm = torch.where(in_len, vals.to(torch.int64), 0)
    zero = torch.zeros((r, 1), dtype=torch.int64, device=vals.device)
    prev = torch.cat([zero, vm[:, :-1]], dim=1)
    d = torch.where(pos > 0, vm - prev, 0)
    dprev = torch.cat([zero, d[:, :-1]], dim=1)
    dd = (d - dprev) & _MASK32
    dd = dd - ((dd >> 31) << 32)  # as a signed 32-bit value
    zz = (dd << 1) ^ (dd >> 63)
    fo = vm - ref.to(torch.int64)[:, None]
    mode = mode.to(torch.int64)[:, None]
    out = torch.where(mode == NUMERIC, fo, torch.where(mode == MONOTONE_INT, d, zz))
    return (torch.where(in_len, out, 0) & _MASK32).to(torch.uint32)


def _lib() -> ctypes.CDLL:
    lib = build.load("colcodec")
    fn = lib.colcodec_transform_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def colcodec_transform(vals: torch.Tensor, lens: torch.Tensor, mode: torch.Tensor,
                       ref: torch.Tensor) -> torch.Tensor:
    """(R, C) int32 + per-row (R,) int32 len / mode / ref -> (R, C) uint32.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    torch version."""
    if vals.dim() != 2:
        raise ValueError(f"vals must be 2-D (R, C), got shape {tuple(vals.shape)}")
    r, width = vals.shape
    for name, t in (("vals", vals), ("lens", lens), ("mode", mode), ("ref", ref)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
        if name != "vals" and tuple(t.shape) != (r,):
            raise ValueError(f"{name} must have shape ({r},), got {tuple(t.shape)}")
    if vals.device.type == "cpu":
        return colcodec_transform_plain(vals, lens, mode, ref)
    if vals.device.type != "cuda":
        raise ValueError(f"no colcodec_transform kernel for device {vals.device}")
    if not all(t.is_contiguous() for t in (vals, lens, mode, ref)):
        raise ValueError("colcodec_transform takes contiguous tensors")
    out = torch.empty((r, width), dtype=torch.uint32, device=vals.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().colcodec_transform_launch(
            vals.data_ptr(), lens.data_ptr(), mode.data_ptr(), ref.data_ptr(),
            out.data_ptr(), r, width, stream)
    if rc:
        raise RuntimeError(f"colcodec_transform kernel launch failed: CUDA error {rc}")
    _LAUNCHES.add()
    return out
