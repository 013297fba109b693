"""The decoder LM as a ``torch.nn.Module``: the dense family of
``repro.models.transformer``.

Layers are grouped into repeating *blocks* of ``cfg.block_period``
sub-layers, as in the reference; its ``lax.scan`` over stacked blocks is
a Python loop over a ``ModuleList`` here. Parameter names follow the
reference's tree (``blocks.<i>.sub<j>.attn.wq`` is
``params["blocks"]["sub<j>"]["attn"]["wq"][i]``), which is what
``models.weights`` carries across. The port has no mesh, so the
reference's ``shard_act`` calls are dropped.

Only ``cfg.family == "dense"`` is ported; every entry point raises
``NotImplementedError`` for the others.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..kernels.ops import check_device
from .config import ModelConfig
from .layers import apply_rope, attention, ffn, rms_norm

# where each family that is not ported yet waits (ROADMAP.md, queue A)
_PENDING = {
    "moe": "ROADMAP queue A item 5b (models/moe.py)",
    "hybrid": "ROADMAP queue A item 5b (models/mamba.py)",
    "ssm": "ROADMAP queue A item 5b (models/rwkv6.py)",
    "vlm": "ROADMAP queue A item 5b (the VLM patch stub)",
    "audio": "ROADMAP queue A item 5b (the audio encoder stub)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run."""
    if cfg.family != "dense":
        where = _PENDING.get(cfg.family, "ROADMAP queue A item 5b")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (only 'dense' is); "
            f"it waits for {where}")


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
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Sublayer(nn.Module):
    """One attention sub-layer: ``ln1``, ``attn``, ``ln2``, ``ffn``. The
    norms (and ``q_norm`` / ``k_norm``) are fp32 in every model."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        h, kv, hd, d, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
        f32 = torch.float32
        self.ln1 = _empty((d,), f32, device)
        attn = {"wq": _empty((d, h * hd), dtype, device),
                "wk": _empty((d, kv * hd), dtype, device),
                "wv": _empty((d, kv * hd), dtype, device),
                "wo": _empty((h * hd, d), dtype, device)}
        if cfg.qkv_bias:
            attn.update(bq=_empty((h * hd,), dtype, device), bk=_empty((kv * hd,), dtype, device),
                        bv=_empty((kv * hd,), dtype, device))
        if cfg.qk_norm:
            attn.update(q_norm=_empty((hd,), f32, device), k_norm=_empty((hd,), f32, device))
        self.attn = nn.ParameterDict(attn)
        self.ln2 = _empty((d,), f32, device)
        if cfg.ffn_act == "swiglu":
            mlp = {"w1": _empty((d, f), dtype, device), "w3": _empty((d, f), dtype, device),
                   "w2": _empty((f, d), dtype, device)}
        else:
            mlp = {"w1": _empty((d, f), dtype, device), "b1": _empty((f,), dtype, device),
                   "w2": _empty((f, d), dtype, device), "b2": _empty((d,), dtype, device)}
        self.ffn = nn.ParameterDict(mlp)


class Transformer(nn.Module):
    """Embedding, ``n_layers // block_period`` blocks of ``block_period``
    sub-layers each, final norm and unembedding (the embedding's
    transpose when ``tie_embeddings``). Parameters are left uninitialised:
    ``init_params`` draws them, ``weights.from_reference`` copies them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        check_family(cfg)
        dev = check_device(device)
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
            nn.ModuleDict({f"sub{j}": Sublayer(cfg, dtype, dev) for j in range(period)})
            for _ in range(cfg.n_layers // period))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembedding(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def forward(self, batch: dict):
        return forward(self, batch)


# --------------------------------------------------------------------- init

def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> Transformer:
    """A ``Transformer`` with the reference's distributions and scales
    (``repro.models.transformer.init_params``), drawn in fp32 from
    ``generator`` (a fresh one on ``device`` seeded 0 when None) and cast
    to the config's dtype. Biases are zero, norm scales one."""
    dev = check_device(device)
    model = Transformer(cfg, dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    deep = np.sqrt(2 * cfg.n_layers)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim == 1:  # norm scales and biases
            p.fill_(0.0 if leaf in ("bq", "bk", "bv", "b1", "b2") else 1.0)
            continue
        fan_in = p.shape[0]
        if leaf == "embed":
            scale = 0.02
        elif leaf == "wo" or leaf == "w2":
            scale = fan_in ** -0.5 / deep
        else:  # wq, wk, wv, w1, w3, unembed
            scale = fan_in ** -0.5
        p.copy_(_normal(gen, tuple(p.shape), scale, p.dtype, dev))
    return model


# ---------------------------------------------------------------- sublayers

def _attn_qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attn_seq(x, p, cfg: ModelConfig, positions):
    q, k, v = _attn_qkv(x, p, cfg, positions)
    o = attention(q, k, v, causal=True, k_chunk=cfg.attn_chunk_k)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


def _sublayer_seq(x, sub: Sublayer, cfg: ModelConfig, positions):
    h = rms_norm(x, sub.ln1, cfg.norm_eps)
    x = x + _self_attn_seq(h, sub.attn, cfg, positions)
    h2 = rms_norm(x, sub.ln2, cfg.norm_eps)
    return x + ffn(h2, sub.ffn, cfg.ffn_act)


# -------------------------------------------------------------- embeddings

def embed_inputs(model: Transformer, batch: dict):
    """tokens -> (x (B, S, d), positions (B, S))."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = model.embed[tokens.long()]
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


# ------------------------------------------------------------------ forward

@torch.inference_mode()
def forward(model: Transformer, batch: dict):
    """Eval forward -> (logits (B, S, padded_vocab), aux loss)."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    for block in model.blocks:
        for j in range(cfg.block_period):
            x = _sublayer_seq(x, block[f"sub{j}"], cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    return x @ model.unembedding(), aux
