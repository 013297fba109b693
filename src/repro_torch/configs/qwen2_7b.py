"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias. [arXiv:2407.10671; hf]

Note: 28 q-heads are padded to 32 on a 16-way model axis (tp_pad);
overhead is visible in §Roofline's MODEL_FLOPS/HLO ratio."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
