"""Prefill + single-token decode with a KV cache: the attention layers of
``repro.models.serving``.

Cache layout (a dict of tensors on the model's device):
    cache = {
      "pos": (B,) int32 — tokens already in cache,
      "blocks": [{"sub<j>": {"k", "v"}} for each block],
    }
    k, v: (B, M, KV, hd) in the model's dtype — M = cache capacity.

``decode_step`` writes the new token's K/V into the cache in place and
returns ``(logits, cache)`` as the reference does. As there, every row
writes at ``pos[0]``, the write's start is clamped to ``M - 1`` (what
``lax.dynamic_update_slice`` does), and row ``b`` attends to its first
``pos[b] + 1`` slots. Only ``cfg.family == "dense"`` is ported.
"""

from __future__ import annotations

import torch

from ..kernels.ops import check_device
from .config import ModelConfig
from .layers import attention, decode_attention, ffn, rms_norm
from .transformer import Transformer, _attn_qkv, _dtype, check_family, embed_inputs


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device="cuda") -> dict:
    """An empty cache: every slot zero, ``pos`` zero."""
    check_family(cfg)
    dev = check_device(device)
    dt = _dtype(cfg)
    shape = (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)

    def sub_state():
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    n_blocks = cfg.n_layers // cfg.block_period
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            "blocks": [{f"sub{j}": sub_state() for j in range(cfg.block_period)}
                       for _ in range(n_blocks)]}


# ------------------------------------------------------------------ prefill

@torch.inference_mode()
def prefill(model: Transformer, batch: dict, max_len: int):
    """Run the prompt, return (last-position logits (B, Vpad), cache)."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of {max_len}")
    blocks = []
    for block in model.blocks:
        caches = {}
        for j in range(cfg.block_period):
            sub = block[f"sub{j}"]
            h = rms_norm(x, sub.ln1, cfg.norm_eps)
            q, k, v = _attn_qkv(h, sub.attn, cfg, positions)
            o = attention(q, k, v, causal=True, k_chunk=cfg.attn_chunk_k)
            x = x + o.reshape(b, s, -1) @ sub.attn["wo"]
            kc = torch.zeros((b, max_len, *k.shape[2:]), dtype=k.dtype, device=k.device)
            vc = torch.zeros_like(kc)
            kc[:, :s] = k
            vc[:, :s] = v
            caches[f"sub{j}"] = {"k": kc, "v": vc}
            h2 = rms_norm(x, sub.ln2, cfg.norm_eps)
            x = x + ffn(h2, sub.ffn, cfg.ffn_act)
        blocks.append(caches)

    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = x[:, -1] @ model.unembedding()
    cache = {"pos": torch.full((b,), s, dtype=torch.int32, device=x.device), "blocks": blocks}
    return logits, cache


# ------------------------------------------------------------- decode step

@torch.inference_mode()
def decode_step(model: Transformer, cache: dict, tokens):
    """One token for every sequence. tokens: (B, 1) -> (logits, new cache)."""
    cfg = model.cfg
    x, _ = embed_inputs(model, {"tokens": tokens})             # (B, 1, d)
    b = x.shape[0]
    pos = cache["pos"]                                          # (B,)
    positions = pos[:, None]
    # every row writes at pos[0], the start clamped into the cache, with no
    # trip to the host: the index stays a device tensor
    max_len = cache["blocks"][0]["sub0"]["k"].shape[1]
    at = pos[:1].long().clamp(0, max_len - 1)
    kv_len = pos + 1
    for block, bc in zip(model.blocks, cache["blocks"]):
        for j in range(cfg.block_period):
            sub, c = block[f"sub{j}"], bc[f"sub{j}"]
            h = rms_norm(x, sub.ln1, cfg.norm_eps)
            q, k, v = _attn_qkv(h, sub.attn, cfg, positions)
            c["k"].index_copy_(1, at, k)
            c["v"].index_copy_(1, at, v)
            o = decode_attention(q, c["k"], c["v"], kv_len)
            x = x + o.reshape(b, 1, -1) @ sub.attn["wo"]
            h2 = rms_norm(x, sub.ln2, cfg.norm_eps)
            x = x + ffn(h2, sub.ffn, cfg.ffn_act)

    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = x[:, -1] @ model.unembedding()
    return logits, {"pos": pos + 1, "blocks": cache["blocks"]}
