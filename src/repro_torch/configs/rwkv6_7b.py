"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 attention-free d_ff=14336
vocab=65536, data-dependent per-channel decay, head_dim 64.
[arXiv:2404.05892; hf]"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,          # informational; rwkv uses n_rwkv_heads = d/64
        n_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        attn_every=0,
        ssm_kind="rwkv6",
        rwkv_head_dim=64,
        rwkv_decay_lora=64,
    )
