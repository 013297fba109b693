"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        n_experts=8,
        top_k=2,
        # GLU experts: 3 x (d x f) matrices per expert -> ~314B total,
        # matching the published size (2-matrix GELU would be ~213B).
    )
