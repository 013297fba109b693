"""Prefill + single-token decode with per-family caches
(``repro.models.serving``).

Cache layout (a dict of tensors on the model's device):
    cache = {
      "pos": (B,) int32 — tokens already in cache,
      "blocks": [{"sub<j>": <per-kind state>} for each block],
      ["xattn": [{"k", "v"} for each block] (whisper)],
    }
    attn  state: k/v (B, M, KV, hd) in the model's dtype — M = cache capacity
    mamba state: conv (B, dc-1, di) in the model's dtype, h (B, di, ds) fp32
    rwkv6 state: xt (B, d), s (B, H, hd, hd) fp32, xc (B, d)
    xattn: k/v (B, n_frames, KV, hd), the encoder memory's, read by decode

Each leaf has the shape of the reference's leaf for that block (the
reference stacks them over blocks). ``decode_step`` updates the states in
place and returns ``(logits, cache)`` with ``pos + 1``. As in the reference, every row
writes its K/V at ``pos[0]``, the write's start is clamped to ``M - 1``
(what ``lax.dynamic_update_slice`` does), and row ``b`` attends to its
first ``pos[b] + 1`` slots.

A model placed on a mesh (``DTensor`` parameters) serves a cache placed
by ``distributed.cache_pspecs``: the K/V cache's sequence dim split over
"model". Each rank writes the new token's K/V into its own block of the
cache (only the rank whose block holds the slot writes), attention runs
split-K over the blocks (``layers.decode_attention``), and every state
leaves the step with the placements it came in with. Plain tensors run
in inference mode; ``DTensor`` s under ``no_grad`` with the plain tensors
the step makes counted as replicated (DTensor cannot view a tensor made
outside inference mode inside it).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..distributed.act_shard import block_offset, on_blocks, placed, shard_act
from ..kernels.ops import check_device
from . import mamba, rwkv6
from .config import ModelConfig
from .layers import decode_attention, rms_norm
from .transformer import (
    Sublayer,
    Transformer,
    _attn_qkv,
    _dtype,
    _cross_attn,
    _cross_kv,
    embed_inputs,
    embed_tokens,
    _encoder_forward,
    _ffn_seq,
    _mixer_seq,
    _sharded,
    _sin_pos_on,
)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device="cuda") -> dict:
    """An empty cache: every state zero, ``pos`` zero."""
    dev = check_device(device, meta_ok=True)
    dt = _dtype(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def sub_state(j):
        kind = cfg.layer_kind(j)
        if kind == "attn":
            shape = (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
            return {"k": zeros(*shape), "v": zeros(*shape)}
        if kind == "mamba":
            conv, h = mamba.init_state(batch_size, cfg, dt, dev)
            return {"conv": conv, "h": h}
        xt, s = rwkv6.init_state(batch_size, cfg, dt, dev)
        return {"xt": xt, "s": s, "xc": zeros(batch_size, cfg.d_model)}

    n_blocks = cfg.n_layers // cfg.block_period
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
             "blocks": [{f"sub{j}": sub_state(j) for j in range(cfg.block_period)}
                        for _ in range(n_blocks)]}
    if cfg.n_enc_layers:
        shape = (batch_size, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
        cache["xattn"] = [{"k": zeros(*shape), "v": zeros(*shape)} for _ in range(n_blocks)]
    return cache


@contextlib.contextmanager
def _serving_mode(model: Transformer):
    """Inference mode for a plain model; for a placed one ``no_grad``, the
    plain tensors it makes counted as replicated."""
    if not _sharded(model.embed):
        with torch.inference_mode():
            yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with torch.no_grad(), implicit_replication():
        yield


def _store(state, new) -> None:
    """Write ``new`` into the decode state ``state`` in place; a ``DTensor``
    state keeps its placements (``new`` is placed as it first)."""
    if _sharded(state):
        state.to_local().copy_(placed(new, state.device_mesh, state.placements).to_local())
    else:
        state.copy_(new)


def _write_kv(cache, at, new) -> None:
    """``cache[:, at] = new`` along the sequence dim, in place. A
    ``DTensor`` cache is written through its local block: ``new`` is placed
    as the cache's rows (whole where the cache's sequence is split: the
    heads gathered, as GSPMD does for the reference), and of the ranks
    that split the sequence only the one whose block holds slot ``at``
    writes it, by a masked write on the device (no trip to the host). The
    cache keeps its placements."""
    if not _sharded(cache):
        cache.index_copy_(1, at, new)
        return
    from torch.distributed.tensor import Replicate, Shard

    rows = [Replicate() if p == Shard(1) else p for p in cache.placements]
    row = placed(new, cache.device_mesh, rows).to_local()
    block = cache.to_local()
    start, _ = block_offset(cache, 1)
    i = (at.full_tensor() if _sharded(at) else at) - start
    mine = ((i >= 0) & (i < block.shape[1])).reshape((1,) * block.ndim)
    i = i.clamp(0, block.shape[1] - 1)
    block.index_copy_(1, i, torch.where(mine, row, block.index_select(1, i)))


# ------------------------------------------------------------------ prefill

def prefill_sublayer(x, sub: Sublayer, cfg: ModelConfig, positions, max_len: int):
    """One sub-layer over the prompt -> (x, its cache entry)."""
    b, s, _ = x.shape
    y, state = _mixer_seq(rms_norm(x, sub.ln1, cfg.norm_eps), sub, cfg, positions)
    x = shard_act(x + y, ("batch", None, None))  # summed over "model" before the norm
    if sub.kind == "attn":
        heads = ("batch", None, "model", None)
        for name in ("k", "v"):  # (B, s, KV, hd) -> (B, max_len, KV, hd), zeros after s
            state[name] = on_blocks(lambda t: F.pad(t, (0, 0, 0, 0, 0, max_len - s)),
                                    (state[name],), (heads,), heads)
    y, _, more = _ffn_seq(rms_norm(x, sub.ln2, cfg.norm_eps), sub, cfg)
    state.update(more)
    return x + y, state


def prefill(model: Transformer, batch: dict, max_len: int):
    """Run the prompt (with ``vision`` / ``frames`` where the family takes
    them), return (last-position logits (B, Vpad), cache)."""
    with _serving_mode(model):
        return _prefill(model, batch, max_len)


def _prefill(model: Transformer, batch: dict, max_len: int):
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} positions does not fit a cache of {max_len}")
    memory = _encoder_forward(model, batch["frames"]) if cfg.n_enc_layers else None
    blocks, xattn = [], []
    for i, block in enumerate(model.blocks):
        x = shard_act(x, ("batch", None, None))
        caches = {}
        for j in range(cfg.block_period):
            x, caches[f"sub{j}"] = prefill_sublayer(x, block[f"sub{j}"], cfg, positions,
                                                    max_len)
        blocks.append(caches)
        if memory is not None:
            xp = model.xattn_of_block(i)
            k, v = _cross_kv(memory, xp.xattn, cfg)
            x = x + _cross_attn(rms_norm(x, xp.lnx, cfg.norm_eps), xp.xattn, cfg, k, v)
            xattn.append({"k": k, "v": v})

    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = x[:, -1] @ model.unembedding()
    cache = {"pos": torch.full((b,), s, dtype=torch.int32, device=x.device), "blocks": blocks}
    if memory is not None:
        cache["xattn"] = xattn
    return logits, cache


# ------------------------------------------------------------- decode step

def decode_sublayer(x, sub: Sublayer, c: dict, cfg: ModelConfig, positions, at, kv_len):
    """One sub-layer for one token: x (B, 1, d), its cache entry ``c``
    (updated in place), the K/V write index ``at`` (1,) and the valid
    lengths ``kv_len`` (B,) -> x."""
    b = x.shape[0]
    h = rms_norm(x, sub.ln1, cfg.norm_eps)
    if sub.kind == "attn":
        q, k, v = _attn_qkv(h, sub.attn, cfg, positions)
        _write_kv(c["k"], at, k)
        _write_kv(c["v"], at, v)
        o = decode_attention(q, c["k"], c["v"], kv_len)
        y = o.reshape(b, 1, -1) @ sub.attn["wo"]
    elif sub.kind == "mamba":
        y, (conv, hs) = mamba.mamba_decode(h, sub.mamba, cfg, (c["conv"], c["h"]))
        _store(c["conv"], conv)
        _store(c["h"], hs)
    else:
        y, (xt, s) = rwkv6.rwkv_decode(h, sub.tmix, cfg, (c["xt"], c["s"]))
        _store(c["xt"], xt)
        _store(c["s"], s)
    # summed over "model" before the norm, so that the FFN's products take
    # whole rows (a partial sum would have every rank multiply all of it)
    x = shard_act(x + y, ("batch", None, None))
    h2 = rms_norm(x, sub.ln2, cfg.norm_eps)
    if sub.ffn_kind == "cmix":
        mu = sub.cmix["mu"]
        xm = h2[:, 0] * mu + c["xc"] * (1 - mu)
        y = torch.square(F.relu(xm @ sub.cmix["wk"])) @ sub.cmix["wv"]
        _store(c["xc"], h2[:, 0])
        return x + y[:, None]
    return x + _ffn_seq(h2, sub, cfg)[0]


def _attn_capacity(cfg: ModelConfig, cache: dict):
    """The self-attention cache's capacity M, or None without attention."""
    for j in range(cfg.block_period):
        if cfg.layer_kind(j) == "attn":
            return cache["blocks"][0][f"sub{j}"]["k"].shape[1]
    return None


def decode_step(model: Transformer, cache: dict, tokens):
    """One token for every sequence. tokens: (B, 1) -> (logits, the new
    cache: ``cache``'s states, updated in place, and ``pos + 1``)."""
    with _serving_mode(model):
        return _decode_step(model, cache, tokens)


def _decode_step(model: Transformer, cache: dict, tokens):
    cfg = model.cfg
    # the vocab-parallel rows summed first, as in embed_inputs
    x = shard_act(embed_tokens(model, tokens), ("batch", None, None))   # (B, 1, d)
    b = x.shape[0]
    pos = cache["pos"]                                          # (B,)
    positions = pos[:, None]
    max_len = _attn_capacity(cfg, cache)
    if cfg.family == "audio":
        # the reference gathers row pos of a table of M rows, which JAX
        # clamps into the table; torch would raise, so clamp here
        m = max_len if max_len is not None else 4096
        table = _sin_pos_on(m, cfg.d_model, x.device).to(x.dtype)
        rows = on_blocks(lambda t, i: t[i], (table, pos.long().clamp(0, m - 1)),
                         ((None, None), ("batch",)), ("batch", None))  # each rank its rows
        x = x + rows[:, None]
    # every row writes at pos[0], the start clamped into the cache, with no
    # trip to the host: the index stays a device tensor
    at = pos[:1].long().clamp(0, max_len - 1) if max_len is not None else None
    kv_len = pos + 1
    x_len = None
    if "xattn" in cache:
        x_len = torch.full((b,), cache["xattn"][0]["k"].shape[1], dtype=torch.int32,
                           device=x.device)
    for i, (block, bc) in enumerate(zip(model.blocks, cache["blocks"])):
        x = shard_act(x, ("batch", None, None))
        for j in range(cfg.block_period):
            x = decode_sublayer(x, block[f"sub{j}"], bc[f"sub{j}"], cfg, positions, at, kv_len)
        if x_len is not None:
            xp, xc = model.xattn_of_block(i), cache["xattn"][i]
            h = rms_norm(x, xp.lnx, cfg.norm_eps)
            q = (h @ xp.xattn["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
            o = decode_attention(q, xc["k"], xc["v"], x_len)
            x = x + o.reshape(b, 1, -1) @ xp.xattn["wo"]

    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = x[:, -1] @ model.unembedding()
    return logits, dict(cache, pos=pos + 1)
