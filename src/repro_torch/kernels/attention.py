"""Fused attention over a sequence: the CUDA kernels' wrapper (a forward,
and a backward of three launches, FlashAttention-2), their
``torch.autograd.Function``, and their launch counts.

The kernels are ``csrc/attention.cu``; its note says which TPU kernel they
replace (none: the JAX package leaves ``repro.models.layers.attention``, a
``lax.scan`` over KV chunks, to XLA), what bounds them on the H100 and how
the design meets that. The port's plain version, ``models.layers._attention``,
is a Python loop over 1,024-key chunks with fp32 (B, H, Sq, 1024) score
tiles in device memory; ``models.layers.attention`` launches these kernels
for CUDA tensors instead and keeps that loop for CPU tensors.

Arithmetic, which ``_attention`` holds to on CPU tensors up to the
roundings named here: QK^T on operands in the inputs' dtype with fp32
accumulation; the scale applied to the fp32 scores; the running max and
sum in fp32; P rounded to v's dtype before P.V, which accumulates in fp32;
o normalised in fp32 and rounded once. fp32 inputs take true fp32
products (no TF32) and P stays fp32. The backward rounds P and dS to the
operands' dtype for their products, which accumulate in fp32, and uses no
atomics: its gradients are the same bits on every run. Causal masking is
aligned top-left (query i sees keys 0..i, also where Sq != Sk); masked
scores are -1e30 (``layers.NEG_INF``), so a row whose keys are all masked
(``kv_len`` 0) averages v over all ``Sk`` keys, as the plain version does.

Head dims 32, 64 and 128 are taken (every configuration of the registry
and its reduced form), in bf16 or fp32; anything else raises
``ValueError``. The kernels read q, k, v and dO through their strides
where the head dim is contiguous and rows start on 16 bytes; a tensor laid
out otherwise is copied to that layout first.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .counters import LaunchCount

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)

_FWD_LAUNCHES = LaunchCount()
_BWD_LAUNCHES = LaunchCount()


def forward_launches() -> int:
    """Forward kernel launches since the last ``reset_launches``."""
    return _FWD_LAUNCHES.value()


def backward_launches() -> int:
    """Backward passes since the last ``reset_launches``, three kernel
    launches each."""
    return _BWD_LAUNCHES.value()


def reset_launches() -> None:
    _FWD_LAUNCHES.reset()
    _BWD_LAUNCHES.reset()


def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptrs, n_ints in ((lib.attention_forward, 8, 7), (lib.attention_backward, 13, 6)):
        if fn.argtypes is None:
            fn.argtypes = [i32, i32] + [ptr] * n_ptrs + [i32] * n_ints + [ptr]
            fn.restype = i32
    return lib


def _check(q, k, v, kv_len) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: batch and "
                         f"head dim equal, KV heads dividing the query heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims {HEAD_DIMS}, got head dim {hd}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes q, k, v of one dtype among {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the attention kernel takes q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if k.shape[1] == 0:
        raise ValueError("attention over no keys")
    if kv_len is not None and (kv_len.shape != (b,) or kv_len.device != q.device
                               or kv_len.dtype.is_floating_point):
        raise ValueError(f"kv_len must be ({b},) integers on {q.device}, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype} on {kv_len.device}")


def _readable(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels can read it (the head dim contiguous,
    every row on 16 bytes), else a contiguous copy."""
    per = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % per == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(*ts) -> ctypes.Array:
    """The (batch, position, head) strides of each tensor, in elements."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _lens(kv_len):
    return None if kv_len is None else kv_len.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(q, k, v, kv_len, causal: bool, stats: bool):
    """-> (o (B, Sq, H, hd) in q's dtype, and with ``stats`` the rows' max
    and log2 of their sum (B, H, Sq) fp32, else None, None)."""
    q, k, v = (_readable(t) for t in (q, k, v))
    b, sq, h, hd = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    m = lg = None
    if stats:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        lg = torch.empty_like(m)
    lens = _lens(kv_len)
    with torch.cuda.device(q.device):
        rc = _lib().attention_forward(
            q.dtype == torch.float32, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _ptr(lens), _ptr(m), _ptr(lg), _strides(q, k, v, o), b, h, k.shape[2], sq,
            k.shape[1], causal, stats, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"attention forward launch failed: CUDA error {rc}")
    _FWD_LAUNCHES.add()
    return o, m, lg


def _backward(q, k, v, o, m, lg, kv_len, do, causal: bool):
    """-> (dq, dk, dv), each contiguous in its input's shape and dtype."""
    q, k, v, do = (_readable(t) for t in (q, k, v, do))
    b, sq, h, hd = q.shape
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    dd = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lens = _lens(kv_len)
    with torch.cuda.device(q.device):
        rc = _lib().attention_backward(
            q.dtype == torch.float32, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(lens), m.data_ptr(),
            lg.data_ptr(), dd.data_ptr(), _strides(q, k, v, o, do, dq, dk), b, h, k.shape[2],
            sq, k.shape[1], causal, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"attention backward launch failed: CUDA error {rc}")
    _BWD_LAUNCHES.add()
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward, saving q, k, v, o and the row statistics, and
    its backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal):
        o, m, lg = _forward(q, k, v, kv_len, causal, stats=True)
        ctx.save_for_backward(q, k, v, o, m, lg, kv_len)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, lg, kv_len = ctx.saved_tensors
        return (*_backward(q, k, v, o, m, lg, kv_len, do, ctx.causal), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len=None, *,
                    causal: bool) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, KV, hd), H % KV ==
    0, on one CUDA device -> o (B, Sq, H, hd) in q's dtype, contiguous.

    ``kv_len``: optional (B,) count of valid keys a row. ``causal``: query
    i sees keys 0..i. Where grad mode is on and an input requires grad,
    the forward saves what the backward needs; otherwise (serving, under
    ``inference_mode``) it saves nothing. Raises ``ValueError`` on what the
    kernel does not take, a head dim outside ``HEAD_DIMS`` among it."""
    _check(q, k, v, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_len, causal)
    return _forward(q, k, v, kv_len, causal, stats=False)[0]

