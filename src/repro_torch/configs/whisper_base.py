"""whisper-base [audio] — 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 (padded 51968), GELU MLP, tied embeddings, conv frontend
STUB (input_specs provides 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        n_enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        ffn_act="gelu",
        tie_embeddings=True,
        n_frames=1500,
    )
