"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave (attention at
layer 4 of every 8), MoE every 2nd layer. [arXiv:2403.19887; hf]"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        n_experts=16,
        top_k=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        attn_offset=4,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
    )
