"""Byte tokenizer and rolling-hash prefix scan: the CUDA kernel, its
plain torch version, and its launch count.

Replaces the Pallas kernel ``_tokenize_kernel`` behind
``repro.kernels.tokenize.tokenize_hash`` of the JAX package. The kernel
is ``csrc/tokenize_hash.cu``: a block takes a tile of whole rows as one
flat run, eight bytes a thread and one segmented scan a chunk, with
16-byte loads and stores through shared memory (its note says what
bounds it on the H100 and how the design meets that). ``tokenize_hash``
launches it for tensors on a CUDA device and runs ``tokenize_hash_plain``
for tensors on the CPU; there is no other path.

Lines arrive as a padded ``(N, B)`` uint8 grid with per-row lengths.
Per byte the outputs are:

- ``mask``   (N, B) int8: 1 on token bytes (in length, not a delimiter);
- ``starts`` (N, B) int8: 1 on the first byte of each token;
- ``pref1`` / ``pref2`` (N, B) uint32: inclusive prefix sums along the
  row of ``(byte+1) * P**pos * mask`` mod 2**32, for ``P1`` and ``P2``.

A token on bytes ``[s, e)`` hashes to ``(pref[e-1] - pref[s-1]) *
P**-s`` in each lane, the same position-independent construction as
``core.textops.SegmentHasher`` in two uint32 lanes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .counters import LaunchCount

# independent odd multipliers for the two uint32 hash lanes
P1 = 0x01000193
P2 = 0x00085EBD

_MASK32 = 0xFFFFFFFF
_LAUNCHES = LaunchCount()


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _LAUNCHES.value()


def reset_launches() -> None:
    _LAUNCHES.reset()


def hash_powers(b: int) -> tuple:
    """Host-side (P**i, P**-i mod 2**32) tables for both lanes, i < b."""
    out = []
    for p in (P1, P2):
        pinv = pow(p, -1, 1 << 32)
        pw = np.empty(b, np.uint64)
        ipw = np.empty(b, np.uint64)
        pw[0] = ipw[0] = 1
        for i in range(1, b):
            pw[i] = (pw[i - 1] * p) & 0xFFFFFFFF
            ipw[i] = (ipw[i - 1] * pinv) & 0xFFFFFFFF
        out.append((pw.astype(np.uint32), ipw.astype(np.uint32)))
    return tuple(out)


def _delim_table(delims, device) -> torch.Tensor:
    table = torch.zeros(256, dtype=torch.bool, device=device)
    if delims:
        table[torch.tensor(sorted(set(delims)), dtype=torch.int64, device=device)] = True
    return table


def tokenize_hash_plain(blocks: torch.Tensor, lens: torch.Tensor, pw1: torch.Tensor,
                        pw2: torch.Tensor, delims) -> tuple[torch.Tensor, ...]:
    """Plain torch version: int64 arithmetic reduced mod 2**32 (torch has
    few uint32 operators), same layout as the kernel."""
    n, width = blocks.shape
    bi = blocks.to(torch.int64)
    pos = torch.arange(width, device=blocks.device)
    in_len = pos[None, :] < lens.to(torch.int64)[:, None]
    tok = in_len & ~_delim_table(delims, blocks.device)[bi]
    prev = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=blocks.device),
                      tok[:, :-1]], dim=1)
    starts = tok & ~prev
    prefs = []
    for pw in (pw1, pw2):
        w = ((bi + 1) * pw.to(torch.int64)[None, :]) & _MASK32  # each term < 2**32
        w = torch.where(tok, w, 0)
        prefs.append((torch.cumsum(w, dim=1) & _MASK32).to(torch.uint32))
    return tok.to(torch.int8), starts.to(torch.int8), prefs[0], prefs[1]


def _lib() -> ctypes.CDLL:
    lib = build.load("tokenize_hash")
    fn = lib.tokenize_hash_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_ulonglong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def tokenize_hash(blocks: torch.Tensor, lens: torch.Tensor, pw1: torch.Tensor,
                  pw2: torch.Tensor, delims) -> tuple[torch.Tensor, ...]:
    """(N, B) uint8 + (N,) int32 lengths + (B,) uint32 power tables ->
    (mask, starts, pref1, pref2); ``delims`` is a collection of byte
    values 0..255.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    torch version."""
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be 2-D (N, B), got shape {tuple(blocks.shape)}")
    n, width = blocks.shape
    for name, x, shape, dtype in (("blocks", blocks, (n, width), torch.uint8),
                                  ("lens", lens, (n,), torch.int32),
                                  ("pw1", pw1, (width,), torch.uint32),
                                  ("pw2", pw2, (width,), torch.uint32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != blocks.device:
            raise ValueError(f"{name} is on {x.device}, blocks on {blocks.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    delims = tuple(int(d) for d in delims)
    if any(not 0 <= d < 256 for d in delims):
        raise ValueError(f"delimiters must be byte values 0..255, got {delims}")
    if blocks.device.type == "cpu":
        return tokenize_hash_plain(blocks, lens, pw1, pw2, delims)
    if blocks.device.type != "cuda":
        raise ValueError(f"no tokenize_hash kernel for device {blocks.device}")
    if width >= 1 << 31:
        raise ValueError(f"the tokenize_hash kernel takes rows of fewer than 2**31 bytes, "
                         f"got B={width}")
    if not all(x.is_contiguous() for x in (blocks, lens, pw1, pw2)):
        raise ValueError("tokenize_hash takes contiguous tensors")
    dev = blocks.device
    outs = (torch.empty((n, width), dtype=torch.int8, device=dev),
            torch.empty((n, width), dtype=torch.int8, device=dev),
            torch.empty((n, width), dtype=torch.uint32, device=dev),
            torch.empty((n, width), dtype=torch.uint32, device=dev))
    if n * width == 0:
        return outs
    words = [0, 0, 0, 0]
    for d in delims:
        words[d >> 6] |= 1 << (d & 63)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tokenize_hash_launch(
            blocks.data_ptr(), lens.data_ptr(), pw1.data_ptr(), pw2.data_ptr(),
            *(o.data_ptr() for o in outs), n, width, *words, stream)
    if rc:
        raise RuntimeError(f"tokenize_hash kernel launch failed: CUDA error {rc}")
    _LAUNCHES.add()
    return outs
