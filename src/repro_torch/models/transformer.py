"""The model as a ``torch.nn.Module``: every family of
``repro.models.transformer`` (decoder LMs, dense or MoE; Mamba +
attention hybrids; RWKV6; the Whisper-style encoder-decoder; the VLM's
patch prefix).

Layers are grouped into repeating *blocks* of ``cfg.block_period``
sub-layers, as in the reference; its ``lax.scan`` over stacked blocks is
a Python loop over a ``ModuleList`` here, and the kind of each sub-layer
(``cfg.layer_kind(j)``, ``cfg.layer_is_moe(j)``) is fixed at
construction. Parameter names follow the reference's tree
(``blocks.<i>.sub<j>.attn.wq`` is
``params["blocks"]["sub<j>"]["attn"]["wq"][i]``; ``encoder.<i>.ffn.w1``
and ``xattn.<i>.lnx`` likewise), which is what ``models.weights``
carries across. The reference's ``shard_act`` calls stand at its sites:
no-ops unless a mesh is installed (``distributed.act_shard``), where a
``DTensor`` activation is redistributed to the spec's placements.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..distributed.act_shard import act_spec, shard_act
from ..kernels.ops import check_device
from . import mamba, rwkv6
from .config import ModelConfig
from .layers import apply_rope, attention, ffn, rms_norm
from .moe import moe_ffn


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def tp_pad(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Round head counts up to shard on a ``tp``-way model axis."""
    def up(x):
        return -(-x // tp) * tp

    h = cfg.n_heads if cfg.n_heads % tp == 0 else up(cfg.n_heads)
    kv = cfg.n_kv_heads
    if h != cfg.n_heads and cfg.n_kv_heads == cfg.n_heads:
        kv = h  # MHA stays MHA
    if h == cfg.n_heads and kv == cfg.n_kv_heads:
        return cfg
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv, head_dim=cfg.head_dim)


# ------------------------------------------------------------------ modules

def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _leaves(shapes: dict, dtype, device, fp32=()) -> nn.ParameterDict:
    """Parameters of ``shapes``, in ``dtype`` but the ``fp32`` ones."""
    return nn.ParameterDict({k: _empty(s, torch.float32 if k in fp32 else dtype, device)
                             for k, s in shapes.items()})


def _attn_shapes(cfg: ModelConfig, cross: bool = False) -> dict:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    s = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias and not cross:
        s.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
    if cfg.qk_norm:
        s.update(q_norm=(hd,), k_norm=(hd,))
    return s


def _ffn_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_act == "swiglu":
        return {"w1": (d, f), "w3": (d, f), "w2": (f, d)}
    return {"w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}


def _moe_shapes(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = {"wg": (d, e), "w1": (e, d, f), "w2": (e, f, d)}
    if cfg.ffn_act == "swiglu":
        s["w3"] = (e, d, f)
    return s


def _mamba_shapes(cfg: ModelConfig) -> dict:
    d, di, ds, dr, dc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {"in_proj": (d, 2 * di), "conv_w": (dc, di), "conv_b": (di,),
            "x_proj": (di, dr + 2 * ds), "dt_proj": (dr, di), "dt_bias": (di,),
            "A_log": (di, ds), "D": (di,), "out_proj": (di, d)}


def _tmix_shapes(cfg: ModelConfig) -> dict:
    d, h, hd, lora = cfg.d_model, cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_decay_lora
    s = {f"mu_{c}": (d,) for c in "rkvwg"}
    s.update({f"w_{c}": (d, d) for c in "rkvgo"})
    s.update(w_decay0=(d,), w_decay1=(d, lora), w_decay2=(lora, d), u_bonus=(h, hd),
             ln_scale=(h, hd))
    return s


def _cmix_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": (d,), "wk": (d, f), "wv": (f, d)}


class Sublayer(nn.Module):
    """One sub-layer: ``ln1``, a mixer (``attn``, ``mamba`` or ``tmix``
    by ``kind``), ``ln2`` and an FFN (``cmix`` after ``tmix``, else
    ``moe`` when ``moe``, else ``ffn``). Norms, ``q_norm`` / ``k_norm``,
    the router ``wg`` and the SSMs' ``A_log``, ``D``, ``w_decay0``,
    ``u_bonus`` and ``ln_scale`` are fp32 in every model, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, kind: str = "attn",
                 moe: bool = False):
        super().__init__()
        f32 = torch.float32
        self.kind = kind
        self.ln1 = _empty((cfg.d_model,), f32, device)
        if kind == "attn":
            self.attn = _leaves(_attn_shapes(cfg), dtype, device, ("q_norm", "k_norm"))
        elif kind == "mamba":
            self.mamba = _leaves(_mamba_shapes(cfg), dtype, device, ("A_log", "D"))
        else:
            self.tmix = _leaves(_tmix_shapes(cfg), dtype, device,
                                ("w_decay0", "u_bonus", "ln_scale"))
        self.ln2 = _empty((cfg.d_model,), f32, device)
        if kind == "rwkv6":
            self.ffn_kind = "cmix"
            self.cmix = _leaves(_cmix_shapes(cfg), dtype, device)
        elif moe:
            self.ffn_kind = "moe"
            self.moe = _leaves(_moe_shapes(cfg), dtype, device, ("wg",))
        else:
            self.ffn_kind = "ffn"
            self.ffn = _leaves(_ffn_shapes(cfg), dtype, device)


class CrossAttn(nn.Module):
    """A decoder layer's cross-attention onto the encoder: ``lnx`` and
    ``xattn`` (no biases)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.lnx = _empty((cfg.d_model,), torch.float32, device)
        self.xattn = _leaves(_attn_shapes(cfg, cross=True), dtype, device, ("q_norm", "k_norm"))


class Transformer(nn.Module):
    """Embedding, ``n_layers // block_period`` blocks of ``block_period``
    sub-layers each, final norm and unembedding (the embedding's
    transpose when ``tie_embeddings``); with ``n_enc_layers``, the
    encoder's layers, its final norm ``enc_ln_f`` and one cross-attention
    a decoder layer (``xattn``). Parameters are left uninitialised:
    ``init_params`` draws them, ``weights.from_reference`` copies them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = check_device(device, meta_ok=True)
        period = cfg.block_period
        if cfg.n_layers % period:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the block period "
                             f"{period}")
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.embed = _empty((cfg.padded_vocab, cfg.d_model), dtype, dev)
        self.ln_f = _empty((cfg.d_model,), torch.float32, dev)
        self.unembed = (None if cfg.tie_embeddings
                        else _empty((cfg.d_model, cfg.padded_vocab), dtype, dev))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"sub{j}": Sublayer(cfg, dtype, dev, cfg.layer_kind(j),
                                               cfg.layer_is_moe(j))
                           for j in range(period)})
            for _ in range(cfg.n_layers // period))
        self.encoder = self.enc_ln_f = self.xattn = None
        if cfg.n_enc_layers:
            self.encoder = nn.ModuleList(Sublayer(cfg, dtype, dev)
                                         for _ in range(cfg.n_enc_layers))
            self.enc_ln_f = _empty((cfg.d_model,), torch.float32, dev)
            self.xattn = nn.ModuleList(CrossAttn(cfg, dtype, dev) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembedding(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def xattn_of_block(self, i: int) -> CrossAttn:
        """The cross-attention after block ``i``: its last layer's, as the
        reference's forward takes it."""
        p = self.cfg.block_period
        return self.xattn[i * p + p - 1]

    def forward(self, batch: dict):
        return forward(self, batch)


# --------------------------------------------------------------------- init

_FILL = {"bq": 0.0, "bk": 0.0, "bv": 0.0, "b1": 0.0, "b2": 0.0, "conv_b": 0.0,
         "dt_bias": -2.0, "w_decay0": -1.0, "mu": 0.5, **{f"mu_{c}": 0.5 for c in "rkvwg"},
         **{k: 1.0 for k in ("ln1", "ln2", "lnx", "ln_f", "enc_ln_f", "q_norm", "k_norm",
                             "ln_scale", "D")}}


def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device).mul_(scale)
    return x.to(device=device, dtype=dtype)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> Transformer:
    """A ``Transformer`` with the reference's distributions and scales
    (``repro.models.transformer.init_params`` and the ``init_params`` of
    ``moe``, ``mamba`` and ``rwkv6``), each leaf by its name, drawn in
    fp32 from ``generator`` (a fresh one on ``device`` seeded 0 when
    None) and cast to the leaf's dtype. A matrix is N(0, fan_in ** -0.5)
    with fan_in its second-to-last dimension (an expert's ``d`` or ``f``,
    not ``E``); ``wo`` and ``w2`` (attention, FFN, experts) are divided
    by sqrt(2 n_layers); the embedding is N(0, 0.02), RWKV's ``u_bonus``
    N(0, 0.1). Biases, norms, mixes and decays are constants (``_FILL``);
    ``A_log`` is log(1..d_state) on every row."""
    dev = check_device(device)
    model = Transformer(cfg, dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    deep = np.sqrt(2 * cfg.n_layers)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _FILL:
            p.fill_(_FILL[leaf])
        elif leaf == "A_log":
            row = torch.log(torch.arange(1, p.shape[1] + 1, dtype=torch.float32, device=dev))
            p.copy_(row.expand(p.shape))
        else:
            if leaf == "embed":
                scale = 0.02
            elif leaf == "u_bonus":
                scale = 0.1
            elif leaf in ("wo", "w2"):
                scale = p.shape[-2] ** -0.5 / deep
            else:
                scale = p.shape[-2] ** -0.5
            p.copy_(_normal(gen, tuple(p.shape), scale, p.dtype, dev))
    return model


# ---------------------------------------------------------------- sublayers

def _whole_heads(t, n_heads: int):
    """``t`` (B, S, heads * hd) with its last dim split over "model" only by
    whole heads, so that the reshape to (B, S, heads, hd) can keep the
    split (DTensor may split a product's columns where the heads do not
    divide); a no-op on plain tensors."""
    spec = act_spec((n_heads,), ("model",))
    return shard_act(t, ("batch", None, "model" if spec and spec[0] else None))


def _attn_qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = _whole_heads(q, h), _whole_heads(k, kv), _whole_heads(v, kv)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.family != "audio":  # whisper uses absolute positions, no rope
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_act(q, ("batch", None, "model", None))
    k = shard_act(k, ("batch", None, "model", None))
    v = shard_act(v, ("batch", None, "model", None))
    return q, k, v


def _self_attn_seq(x, p, cfg: ModelConfig, positions, causal: bool = True):
    q, k, v = _attn_qkv(x, p, cfg, positions)
    o = attention(q, k, v, causal=causal, k_chunk=cfg.attn_chunk_k)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"], k, v


def _mixer_seq(h, sub: Sublayer, cfg: ModelConfig, positions):
    """A sub-layer's mixer over a sequence -> (output, its decode state:
    the new ``k`` / ``v`` for attention, ``conv`` / ``h`` for mamba,
    ``xt`` / ``s`` for RWKV)."""
    if sub.kind == "attn":
        y, k, v = _self_attn_seq(h, sub.attn, cfg, positions)
        return y, {"k": k, "v": v}
    if sub.kind == "mamba":
        y, (conv, hst) = mamba.mamba_seq(h, sub.mamba, cfg)
        return y, {"conv": conv, "h": hst}
    y, (xt, s) = rwkv6.rwkv_seq(h, sub.tmix, cfg)
    return y, {"xt": xt, "s": s}


def _ffn_seq(h2, sub: Sublayer, cfg: ModelConfig):
    """A sub-layer's FFN over a sequence -> (output, aux loss or None, its
    decode state: ``xc`` for RWKV's channel mix)."""
    if sub.ffn_kind == "cmix":
        y, xc = rwkv6.cmix_seq(h2, sub.cmix)
        return y, None, {"xc": xc}
    if sub.ffn_kind == "moe":
        y, aux = moe_ffn(h2, sub.moe, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                         act=cfg.ffn_act, impl=cfg.moe_impl)
        return y, aux, {}
    return ffn(h2, sub.ffn, cfg.ffn_act), None, {}


# -------------------------------------------------------------- embeddings

def _sharded(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (a model placed on a mesh)."""
    return type(t).__name__ == "DTensor"


def embed_tokens(model: Transformer, tokens) -> torch.Tensor:
    """The embedding rows of ``tokens``. A plain table is indexed. A
    sharded table has its model dim gathered first (the FSDP all-gather of
    a weight) and takes ``F.embedding``, which DTensor runs vocab-parallel
    over the vocab's shards (indexing's backward sums in another order, so
    the plain table keeps it)."""
    tokens = torch.as_tensor(tokens, device=model.device).long()
    table = model.embed
    if not _sharded(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate

    whole_rows = [Replicate() if p.is_shard(1) else p for p in table.placements]
    if whole_rows != list(table.placements):  # (a no-op one would reduce its gradient)
        table = table.redistribute(table.device_mesh, whole_rows)
    return F.embedding(tokens, table)


def _sin_pos(n: int, d: int) -> np.ndarray:
    """Sine positions (n, d): float64 on the host, as the reference
    computes them, cast to fp32 as it does."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sin_pos_on(n: int, d: int, device: torch.device) -> torch.Tensor:
    """``_sin_pos`` on ``device``, uploaded once."""
    with torch.inference_mode(False):
        return torch.from_numpy(_sin_pos(n, d)).to(device)


def embed_inputs(model: Transformer, batch: dict):
    """tokens (+ the VLM's ``vision`` prefix) -> (x (B, S, d), positions
    (B, S)); the audio family adds sine positions."""
    cfg = model.cfg
    # the vocab-parallel rows summed before anything joins them (DTensor
    # cannot add or concatenate a replicated tensor to a partial sum on "meta")
    x = shard_act(embed_tokens(model, batch["tokens"]), ("batch", None, None))
    if cfg.n_patches and "vision" in batch:
        vision = torch.as_tensor(batch["vision"], device=model.device)
        x = torch.cat([vision.to(x.dtype), x], dim=1)
    if cfg.family == "audio":
        x = x + _sin_pos_on(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


def _encoder_forward(model: Transformer, frames) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, F, d)."""
    cfg = model.cfg
    dt = _dtype(cfg)
    frames = torch.as_tensor(frames, device=model.device)
    x = frames.to(dt) + _sin_pos_on(frames.shape[1], cfg.d_model, model.device).to(dt)[None]
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for layer in model.encoder:
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        x = x + _self_attn_seq(h, layer.attn, cfg, positions, causal=False)[0]
        h = rms_norm(x, layer.ln2, cfg.norm_eps)
        x = x + ffn(h, layer.ffn, cfg.ffn_act)
    return rms_norm(x, model.enc_ln_f, cfg.norm_eps)


def _cross_kv(memory, p, cfg: ModelConfig):
    """The encoder memory's keys and values (B, F, KV, hd) for ``p``."""
    b, f, _ = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return (memory @ p["wk"]).reshape(b, f, kv, hd), (memory @ p["wv"]).reshape(b, f, kv, hd)


def _cross_attn(x, p, cfg: ModelConfig, k, v):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    o = attention(q, k, v, causal=False, k_chunk=cfg.attn_chunk_k)
    return o.reshape(b, s, -1) @ p["wo"]


# ------------------------------------------------------------------ forward

def _block(x, aux, block, xp, model: Transformer, positions, memory):
    """One block's sub-layers (and, with an encoder, the cross-attention
    after them) -> (x, aux)."""
    cfg = model.cfg
    x = shard_act(x, ("batch", None, None))
    for j in range(cfg.block_period):
        sub = block[f"sub{j}"]
        x = x + _mixer_seq(rms_norm(x, sub.ln1, cfg.norm_eps), sub, cfg, positions)[0]
        y, a, _ = _ffn_seq(rms_norm(x, sub.ln2, cfg.norm_eps), sub, cfg)
        x = x + y
        if a is not None:
            aux = aux + a
        x = shard_act(x, ("batch", None, None))
    if memory is not None:
        h = rms_norm(x, xp.lnx, cfg.norm_eps)
        x = x + _cross_attn(h, xp.xattn, cfg, *_cross_kv(memory, xp.xattn, cfg))
    return x, aux


def _forward(model: Transformer, batch: dict, return_hidden: bool = False):
    """The forward of ``forward``, recording the autograd graph where grad
    mode is on (``loss_fn``'s); ``return_hidden`` gives the final normed
    hidden state (B, S, d) in place of the logits (the vocab-chunked
    loss's input). With ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps its inputs and
    recomputes the rest in the backward, as the reference's
    ``jax.checkpoint`` around each block does; the values and gradients
    are the same either way."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    x = shard_act(x, ("batch", None, None))
    memory = _encoder_forward(model, batch["frames"]) if cfg.n_enc_layers else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, block in enumerate(model.blocks):
        xp = model.xattn_of_block(i) if memory is not None else None
        args = (x, aux, block, xp, model, positions, memory)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(_block, *args, use_reentrant=False)
        else:
            x, aux = _block(*args)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    if return_hidden:
        return x, aux
    # gather the FSDP-sharded d dim of the unembedding once (a weight
    # all-gather) instead of reducing the (B, S, V) activations
    unembed = shard_act(model.unembedding(), (None, "model"))
    return shard_act(x @ unembed, ("batch", None, "model")), aux


@torch.inference_mode()
def forward(model: Transformer, batch: dict):
    """Eval forward -> (logits (B, S, padded_vocab), aux loss: the sum of
    the MoE layers' load-balance losses, fp32). It runs in inference mode
    and records no graph; ``loss_fn`` takes the same forward with the
    graph."""
    return _forward(model, batch)


def _label_logit(logits, labels):
    """``logits[..., labels]`` (B, S). Gathered from vocab-sharded logits,
    DTensor holds a masked partial sum; it is reduced (``shard_act``, a
    no-op on plain tensors) while it still has the gather's rank."""
    pick = shard_act(logits.gather(-1, labels[..., None]), ("batch", None, None))
    return pick[..., 0]


def _chunked_lse_ll(x, unembed, labels, chunk: int):
    """(logsumexp, label-logit) over vocab chunks: the (B, S, V) logits
    tensor is never built whole, only (B, S, chunk) tiles. A streaming
    max / sum-exp, exact; the chunk shrinks to the largest divisor of the
    vocab at most ``chunk``, as in the reference."""
    v = unembed.shape[1]
    chunk = min(chunk, v)
    while v % chunk:
        chunk -= 1
    lab = labels.clamp(min=0)
    m = torch.full(x.shape[:-1], -1e30, dtype=torch.float32, device=x.device)
    se = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    ll = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for ci in range(v // chunk):
        lg = (x @ unembed[:, ci * chunk:(ci + 1) * chunk]).float()    # (B, S, c)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        se = se * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(dim=-1)
        local = lab - ci * chunk
        inside = (local >= 0) & (local < chunk)
        pick = _label_logit(lg, local.clamp(0, chunk - 1))
        ll = torch.where(inside, pick, ll)
        m = m_new
    return m + torch.log(torch.clamp(se, min=1e-30)), ll


def loss_fn(model: Transformer, batch: dict):
    """Next-token cross-entropy in fp32 with a z-loss (1e-4 lse^2) and the
    MoE load-balance term (1e-2 aux), labels of -1 ignored; the VLM's
    patch prefix carries label -1 -> (loss, {"nll", "aux"}). Records the
    autograd graph (grad mode on); ``cfg.vocab_chunk`` takes the
    vocab-chunked path."""
    cfg = model.cfg
    labels = torch.as_tensor(batch["labels"], device=model.device).long()
    if cfg.n_patches and "vision" in batch:  # the vision prefix carries no labels
        pad = torch.full((labels.shape[0], cfg.n_patches), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    if cfg.vocab_chunk:
        x, aux = _forward(model, batch, return_hidden=True)
        lse, ll = _chunked_lse_ll(x, model.unembedding(), labels, cfg.vocab_chunk)
    else:
        logits, aux = _forward(model, batch)
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, dim=-1)
        ll = _label_logit(logits32, labels.clamp(min=0))
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    nll = ((lse - ll) * mask).sum() / denom
    zloss = 1e-4 * ((lse * mask) ** 2).sum() / denom
    return nll + zloss + 1e-2 * aux, {"nll": nll, "aux": aux}
