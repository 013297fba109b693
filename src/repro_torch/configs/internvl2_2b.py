"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 (padded to 92672 for sharding), InternViT frontend STUB
(input_specs provides 256 precomputed patch embeddings prepended to the
text sequence). [arXiv:2404.16821; hf]"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        n_patches=256,
        rope_theta=1_000_000.0,
    )
