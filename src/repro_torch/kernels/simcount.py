"""Common-token counts (the clustering surrogate φ): the CUDA kernel, its
plain torch version, and its launch count.

Replaces the Pallas kernel ``_simcount_kernel`` behind
``repro.kernels.simcount.simcount`` of the JAX package. The kernel is
``csrc/simcount.cu`` (its note says what bounds it on the H100 and how
the design meets that). ``simcount`` launches it for tensors on a CUDA
device and runs ``simcount_plain`` for tensors on the CPU; there is no
other path.

φ(line n, template k) is the number of log positions whose token is not
PAD (0) or STAR (1) and occurs among the template's tokens that are not
PAD or STAR. A duplicate log token counts once per occurrence, as in
``core.lcs.common_token_count``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.tokenizer import PAD_ID, STAR_ID
from . import build

MAX_TT = 1024  # a tile of 32 template rows is staged in shared memory
# rows of lines per step of the plain version, so that its (rows, K, T)
# boolean tiles stay near this many elements
_PLAIN_TILE = 1 << 24
_LAUNCHES = 0


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def _valid(x: torch.Tensor) -> torch.Tensor:
    return (x != PAD_ID) & (x != STAR_ID)


def _plain_rows(logs: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    present = torch.zeros((logs.shape[0], templates.shape[0], logs.shape[1]),
                          dtype=torch.bool, device=logs.device)
    tv = _valid(templates)
    for j in range(templates.shape[1]):
        tj = templates[:, j]
        present |= (logs[:, None, :] == tj[None, :, None]) & tv[None, :, j, None]
    return (present & _valid(logs)[:, None, :]).sum(dim=2, dtype=torch.int32)


def simcount_plain(logs: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """Plain torch version (the layout of the JAX package's
    ``ref.simcount_ref``), over row blocks of lines."""
    n, t = logs.shape
    k = templates.shape[0]
    if n == 0 or k == 0:
        return torch.zeros((n, k), dtype=torch.int32, device=logs.device)
    step = max(1, _PLAIN_TILE // max(1, k * t))
    return torch.cat([_plain_rows(logs[s:s + step], templates) for s in range(0, n, step)])


def _lib() -> ctypes.CDLL:
    lib = build.load("simcount")
    fn = lib.simcount_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def simcount(logs: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """(N, T) x (K, Tt) int32 -> (N, K) int32 common-token counts.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    torch version."""
    if logs.dim() != 2 or templates.dim() != 2:
        raise ValueError(f"logs and templates must be 2-D, got {tuple(logs.shape)} "
                         f"and {tuple(templates.shape)}")
    n, t = logs.shape
    k, tt = templates.shape
    for name, x in (("logs", logs), ("templates", templates)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if templates.device != logs.device:
        raise ValueError(f"templates is on {templates.device}, logs on {logs.device}")
    if logs.device.type == "cpu":
        return simcount_plain(logs, templates)
    if logs.device.type != "cuda":
        raise ValueError(f"no simcount kernel for device {logs.device}")
    if tt > MAX_TT:
        raise ValueError(f"the simcount kernel takes templates of at most {MAX_TT} slots, "
                         f"got Tt={tt}")
    if k > 65535 * 32:
        raise ValueError(f"the simcount kernel takes at most {65535 * 32} templates, got {k}")
    if not (logs.is_contiguous() and templates.is_contiguous()):
        raise ValueError("simcount takes contiguous tensors")
    out = torch.empty((n, k), dtype=torch.int32, device=logs.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(logs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().simcount_launch(logs.data_ptr(), templates.data_ptr(), out.data_ptr(),
                                    n, t, k, tt, stream)
    if rc:
        raise RuntimeError(f"simcount kernel launch failed: CUDA error {rc}")
    global _LAUNCHES
    _LAUNCHES += 1
    return out
