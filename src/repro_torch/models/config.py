"""Unified model configuration covering the 10 assigned architectures.

One dataclass drives dense GQA transformers, MoE, Mamba/attention
hybrids (Jamba), RWKV-6, encoder-decoder (Whisper) and VLM backbones
(InternVL2). ``reduced()`` produces the family-preserving small config
used by CPU smoke tests; full configs are exercised only via the AOT
dry-run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    ffn_act: str = "swiglu"        # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0             # 0 = dense FFN
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 1             # MoE FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    moe_impl: str = "einsum"       # einsum (GShard) | sort (gather/scatter)

    # hybrid (Jamba): attention on layers where i % attn_every == attn_offset,
    # SSM elsewhere. attn_every=1 -> pure attention; 0 -> no attention (RWKV).
    attn_every: int = 1
    attn_offset: int = 0
    ssm_kind: str = "mamba"        # mamba | rwkv6
    # mamba
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0               # 0 -> d_model // 16
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # encoder-decoder (audio family)
    n_enc_layers: int = 0
    n_frames: int = 1500           # stub conv-frontend output length

    # VLM stub frontend
    n_patches: int = 0             # patch embeddings prepended to the text seq

    # numerics / scan
    vocab_chunk: int = 0     # >0: vocab-chunked cross-entropy (never
                             # materializes (B,S,V) logits; MaxText-style)
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk_q: int = 512        # flash chunking for long sequences
    attn_chunk_k: int = 1024
    ssm_chunk: int = 64

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", max(1, self.d_model // 16))

    # ------------------------------------------------------------- helpers
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards on any mesh."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' | 'rwkv6' for decoder layer i."""
        if self.attn_every == 0:
            return self.ssm_kind
        if i % self.attn_every == self.attn_offset % max(self.attn_every, 1):
            return "attn"
        return self.ssm_kind

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every == self.moe_offset % max(self.moe_every, 1))

    @property
    def block_period(self) -> int:
        """Length of the repeating layer pattern (for scan-over-blocks)."""
        import math

        p = 1
        if self.attn_every > 1:
            p = math.lcm(p, self.attn_every)
        if self.n_experts > 0 and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        return p

    def reduced(self, **over) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        period = self.block_period
        small = dict(
            n_layers=max(2 * period, period),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=16 if self.n_frames else 0,
            n_patches=8 if self.n_patches else 0,
            dt_rank=8,
            rwkv_decay_lora=8,
            attn_chunk_q=16,
            attn_chunk_k=16,
            ssm_chunk=8,
        )
        small.update(over)
        return dataclasses.replace(self, **small)
