"""A dense decoder (``references/dense_decoder.py``) on the port: a
configuration file turned into the port's ``ModelConfig``, the
benchmark's weights loaded into the port's ``Transformer``, and the
port's leaves read back under the benchmark's names over the published
vocabulary.

The port pads the vocabulary of its tables to a multiple of 256; the
padded rows of the embedding and columns of the unembedding start at
zero, and are left out wherever a leaf is compared.
"""

from __future__ import annotations

import torch

from ..references.dense_decoder import dims

_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm")
_FFN = ("w1", "w3", "w2")


def model_config(c: dict, name: str, remat: bool = True):
    """The port's ``ModelConfig`` for published ``config.json`` keys ``c``,
    run as the configuration states (norm eps, tied embeddings)."""
    from repro_torch.models.config import ModelConfig

    m = dims(c)
    return ModelConfig(
        name=name, family="dense", n_layers=m["layers"], d_model=m["d"], n_heads=m["heads"],
        n_kv_heads=m["kv_heads"], head_dim=m["head_dim"], d_ff=m["ffn"], vocab_size=m["vocab"],
        qkv_bias=m["qkv_bias"], qk_norm=m["qk_norm"], rope_theta=m["theta"], norm_eps=m["eps"],
        tie_embeddings=m["tied"], ffn_act="swiglu", dtype=c["torch_dtype"], remat=remat)


def program_name(name: str) -> str:
    """The port's parameter name of the benchmark's leaf ``name``."""
    if not name.startswith("layers."):
        return name
    _, i, leaf = name.split(".")
    if leaf in _ATTN:
        return f"blocks.{i}.sub0.attn.{leaf}"
    if leaf in _FFN:
        return f"blocks.{i}.sub0.ffn.{leaf}"
    return f"blocks.{i}.sub0.{leaf}"


def build_model(W: dict, pcfg, device):
    """The port's ``Transformer`` holding copies of ``W`` in its own
    dtypes and padded shapes."""
    from repro_torch.models import Transformer

    model = Transformer(pcfg, device="meta")
    want = model.state_dict()
    state = {}
    for name, t in W.items():
        pname = program_name(name)
        meta = want[pname]
        out = torch.zeros(meta.shape, dtype=meta.dtype, device=device)
        out[tuple(slice(0, n) for n in t.shape)] = t
        state[pname] = out
    model.load_state_dict(state, strict=True, assign=True)
    return model


def leaf(model, name: str, t: torch.Tensor | None = None) -> torch.Tensor:
    """The port's leaf for the benchmark's ``name`` (or ``t``, a tensor of
    that leaf's shape, such as its AdamW moment) over the published
    vocabulary."""
    params = dict(model.named_parameters())
    p = params[program_name(name)] if t is None else t
    v = model.cfg.vocab_size
    if name == "embed":
        return p[:v]
    if name == "unembed":
        return p[:, :v]
    return p
