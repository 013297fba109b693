"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
