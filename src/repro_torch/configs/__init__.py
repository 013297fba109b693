"""Assigned architecture configs (public-literature references inline).

Usage: ``from repro_torch.configs import get_config; cfg = get_config("qwen2-7b")``
Every entry also declares which dry-run input shapes apply
(``long_500k`` only for sub-quadratic families — DESIGN.md §4).
"""

from __future__ import annotations

import importlib

ARCHS = [
    "qwen1_5_4b",
    "qwen1_5_0_5b",
    "qwen3_1_7b",
    "qwen2_7b",
    "dbrx_132b",
    "grok_1_314b",
    "jamba_v0_1_52b",
    "internvl2_2b",
    "whisper_base",
    "rwkv6_7b",
]

_ALIAS = {
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-7b": "qwen2_7b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-2b": "internvl2_2b",
    "whisper-base": "whisper_base",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_IDS = list(_ALIAS.keys())

# the 4 assigned input shapes: (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


def get_config(arch: str):
    mod = importlib.import_module(f".{_ALIAS.get(arch, arch)}", __name__)
    return mod.config()


def shape_applicable(arch: str, shape: str) -> bool:
    """long_500k needs a sub-quadratic path (DESIGN.md §4)."""
    if shape != "long_500k":
        return True
    cfg = get_config(arch)
    return cfg.attn_every != 1  # hybrid (sparse attention) or attention-free
