"""Model zoo, the port of ``repro.models``: the serving and training paths
of every family (dense, MoE, the Mamba hybrid, RWKV6, the VLM, the audio
encoder-decoder).

API:
    cfg     = ModelConfig(...) (see repro_torch.configs for the archs)
    model   = init_params(cfg, generator, device="cuda")  # a Transformer
    logits, aux = forward(model, batch)     # batch: tokens (+ vision / frames)
    loss, metrics = loss_fn(model, batch)   # + labels; records the graph
    logits, cache = prefill(model, batch, max_len)
    logits, cache = decode_step(model, cache, tokens)

``weights.from_reference`` / ``to_reference`` carry the reference's
parameter tree across.
"""

from .config import ModelConfig
from .serving import decode_step, init_cache, prefill
from .transformer import Transformer, forward, init_params, loss_fn, tp_pad

__all__ = [
    "ModelConfig",
    "Transformer",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_cache",
    "tp_pad",
]
