"""Core layers: RMSNorm, RoPE, GQA attention over a sequence (a fused
kernel on the card, KV-chunked on the CPU), one-token decode against a
KV cache, dense FFN.

Plain functions on tensors, the arithmetic of ``repro.models.layers``:
compute dtype follows the inputs (bf16 in a bf16 model); softmax and
norm statistics accumulate in fp32. The products are ``torch.matmul``,
except sequence attention on CUDA tensors, whose products run inside the
hand-written kernel ``kernels.attention.flash_attention`` (operands in
the inputs' dtype, fp32 accumulation, P rounded to v's dtype before P.V
as ``decode_attention`` rounds it); on CPU tensors it is the plain
version ``_attention``.

On ``DTensor`` inputs (a model placed on a mesh) attention runs on each
rank's (batch, head) blocks (``act_shard.on_blocks``), and one-token
decode against a cache whose sequence dim is split runs split-K: each
rank scores its own block of the cache, and only the softmax's
statistics and the (B, H, hd) output are reduced across the split.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.act_shard import block_offset, on_blocks, placed
from ..kernels.attention import flash_attention

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """float64 on the host, as the reference computes them; callers cast."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as fp32 on ``device``, uploaded once: an upload from
    pageable host memory waits for the card, and every attention layer of
    every step asks for the same table."""
    with torch.inference_mode(False):
        return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs                    # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by head repetition."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def attention(q, k, v, *, causal: bool, k_chunk: int = 1024, kv_len=None):
    """Multi-head attention over a sequence.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.
    kv_len: optional (B,) valid KV prefix length (decode masking).
    causal: query i sees keys 0..i (aligned top-left, also where Sq != Sk).

    CUDA tensors launch the fused kernel ``kernels.attention.flash_attention``
    (forward and backward; GQA-native, the score tile never in device
    memory), or raise; ``k_chunk`` means nothing to it. Other tensors (the
    CPU, the dry run's "meta") take ``_attention``, a loop over KV chunks
    of ``k_chunk`` keys carrying the running (acc, max, denom) in fp32, so
    the (B, H, Sq, k_chunk) score tile is the largest transient. On
    ``DTensor`` s either runs on each rank's (batch, head) blocks, K/V heads
    repeated to H first so that the blocks of q and k hold the same heads.
    """
    if type(q).__name__ == "DTensor" or type(k).__name__ == "DTensor":
        h, kv = q.shape[2], k.shape[2]
        k, v = _repeat_kv(k, h // kv), _repeat_kv(v, h // kv)
    heads = ("batch", None, "model", None)
    return on_blocks(functools.partial(_attention_local, causal=causal, k_chunk=k_chunk),
                     (q, k, v, kv_len), (heads, heads, heads, ("batch",)), heads)


def _attention_local(q, k, v, kv_len, *, causal: bool, k_chunk: int):
    """``attention`` on plain tensors: the kernel on CUDA tensors, else
    ``_attention`` with the K/V heads repeated to H."""
    if q.is_cuda:
        return flash_attention(q, k, v, kv_len, causal=causal)
    h, kv = q.shape[2], k.shape[2]
    return _attention(q, _repeat_kv(k, h // kv), _repeat_kv(v, h // kv), kv_len,
                      causal=causal, k_chunk=k_chunk)


def _attention(q, k, v, kv_len, *, causal: bool, k_chunk: int):
    """``attention`` on plain tensors, K/V heads already repeated to H: the
    plain version, which the kernel is held to."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = hd ** -0.5

    k_chunk = min(k_chunk, sk)
    while sk % k_chunk:  # largest divisor <= requested (prod shapes are 2^k)
        k_chunk -= 1
    nk = sk // k_chunk

    qf = (q.float() * scale).transpose(1, 2)                    # (B, H, Sq, hd)
    qpos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for ki in range(nk):
        k_blk = k[:, ki * k_chunk:(ki + 1) * k_chunk].float().transpose(1, 2)  # (B, H, kc, hd)
        v_blk = v[:, ki * k_chunk:(ki + 1) * k_chunk].float().transpose(1, 2)
        s = qf @ k_blk.transpose(-1, -2)                         # (B, H, Sq, kc)
        kpos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
        if kv_len is not None:
            mask = kpos[None, :] < kv_len[:, None]
            s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ v_blk
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len):
    """One-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); kv_len: (B,) valid length
    (the new token's K/V must already be written at kv_len - 1).

    GQA-native, as the reference: q is folded to (B, KV, H/KV, hd) and
    contracted straight against the cache, with no KV head repetition;
    scores and output accumulate in fp32, and the probabilities are
    rounded to the cache's dtype before the second product. A ``DTensor``
    cache takes ``_split_k_decode_attention``.
    """
    if type(k_cache).__name__ == "DTensor":
        return _split_k_decode_attention(q, k_cache, v_cache, kv_len)
    return _decode_attention(q, k_cache, v_cache, kv_len)


def _decode_scores(q, k_cache, kv_len, start: int = 0):
    """(B, KV, g, S) fp32 scores of q against the cache's slots ``start``,
    ``start + 1``, ..., those at or past ``kv_len`` masked."""
    b, _, h, hd = q.shape
    s_len, kv = k_cache.shape[1], k_cache.shape[2]
    q2 = q.reshape(b, kv, h // kv, hd).float()
    kc = k_cache.float().permute(0, 2, 3, 1)                     # (B, KV, hd, S)
    s = (q2 @ kc) * hd ** -0.5                                   # (B, KV, g, S)
    mask = start + torch.arange(s_len, device=q.device)[None, :] < kv_len[:, None]
    return torch.where(mask[:, None, None, :], s, NEG_INF)


def _decode_out(p, v_cache):
    """(B, KV, g, hd) fp32: the probabilities, rounded to the cache's
    dtype, times the cache."""
    return p.to(v_cache.dtype).float() @ v_cache.float().transpose(1, 2)


def _decode_attention(q, k_cache, v_cache, kv_len):
    """``decode_attention`` on plain tensors."""
    p = torch.softmax(_decode_scores(q, k_cache, kv_len), dim=-1)
    return _decode_out(p, v_cache).reshape(q.shape).to(q.dtype)


def _split_k_decode_attention(q, k_cache, v_cache, kv_len):
    """``decode_attention`` on ``DTensor`` caches (placed by
    ``cache_pspecs``: batch over the data axes, the sequence over "model")
    without gathering them. q and ``kv_len`` are placed as the cache's
    rows (q's heads whole where the cache's sequence is split); each rank
    scores its own block of slots at its offset, then the softmax's max
    and sum and the (B, KV, g, hd) output are all-reduced across the
    mesh dims that split the sequence (split-K). Where none does, the
    plain arithmetic runs on the local blocks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, cache_pl = k_cache.device_mesh, tuple(k_cache.placements)
    if any(isinstance(p, Partial) for p in cache_pl):
        raise ValueError(f"a cache placed {cache_pl} holds partial sums")
    if v_cache.placements != k_cache.placements:
        raise ValueError(f"k cache placed {cache_pl}, v cache {v_cache.placements}")
    rows = [Replicate() if p == Shard(1) else p for p in cache_pl]
    lens = [p if p == Shard(0) else Replicate() for p in cache_pl]

    ql, ll = placed(q, mesh, rows).to_local(), placed(kv_len, mesh, lens).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    start, split = block_offset(k_cache, 1)
    if not split:
        out = _decode_attention(ql, kl, vl, ll)
    else:
        def reduce(t, op):  # across the sequence's shards
            part = [Partial(op) if i in split else lens[i] for i in range(mesh.ndim)]
            return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
                mesh, lens).to_local()

        s = _decode_scores(ql, kl, ll, start)       # the scores stay split over S
        e = torch.exp(s - reduce(s.amax(dim=-1), "max")[..., None])
        p = e / reduce(e.sum(dim=-1), "sum")[..., None]
        out = reduce(_decode_out(p, vl), "sum").reshape(ql.shape).to(ql.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def ffn(x, params, act: str):
    """Dense FFN. swiglu: w1 (gate), w3 (up), w2 (down); gelu: w1, w2."""
    if act == "swiglu":
        h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    else:
        h = x @ params["w1"]
        if "b1" in params:
            h = h + params["b1"]
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = h @ params["w2"]
    if "b2" in params:
        out = out + params["b2"]
    return out
