"""The FLOP and byte counts behind ``mfu.*`` and ``kernels_roofline.*``
against counts made by hand from the published sizes."""

import json
from pathlib import Path

import pytest

from bench import counts, weights

CONF = Path(__file__).resolve().parent / "configs"
QWEN15 = json.loads((CONF / "qwen1.5-0.5b.json").read_text())
QWEN3 = json.loads((CONF / "qwen3-1.7b.json").read_text())
PEAK = {"bf16_flop_s": 989e12, "hbm_bytes_s": 3.35e12}


def test_parameters_by_hand():
    # embedding and unembedding 151,936 x 1,024 each; a layer: q, k, v, o
    # 1,024^2 each, their three biases, the FFN's three 1,024 x 2,816, two
    # norms; the final norm
    layer = 4 * 1024 * 1024 + 3 * 1024 + 3 * 1024 * 2816 + 2 * 1024
    assert weights.n_params(QWEN15) == 2 * 151936 * 1024 + 24 * layer + 1024 == 619_570_176
    # tied: one 151,936 x 2,048 table; a layer: q 2,048 x 2,048, k and v
    # 2,048 x 1,024, o 2,048 x 2,048, q/k norms of 128, FFN 3 x 2,048 x 6,144
    layer = 2 * 2048 * 2048 + 2 * 2048 * 1024 + 2 * 128 + 3 * 2048 * 6144 + 2 * 2048
    assert weights.n_params(QWEN3) == 151936 * 2048 + 28 * layer + 2048


def test_train_step_flops_by_hand():
    t = 8 * 2048
    products = 24 * (4 * 1024 * 1024 + 3 * 1024 * 2816) + 1024 * 151936
    assert products == 463_863_808
    # causal: query i attends i + 1 keys; q.k and p.v are 2 * 64 FLOPs a pair each
    attention = 24 * 8 * 16 * (2048 * 2049 // 2) * 4 * 64
    phases = counts.train_step(QWEN15, 8, 2048)
    assert phases[0]["flops"] == 3 * (2 * products * t + attention) == 50_549_886_025_728
    p = weights.n_params(QWEN15)
    assert phases[0]["bytes"] == 2 * 2 * p + 8 * t
    assert phases[1] == {"phase": "adamw", "flops": 0, "bytes": (3 * 2 + 16) * p}
    # the step's least time: the products at the bf16 peak, AdamW at the memory's
    least = counts.least_seconds(phases, PEAK)
    assert least == pytest.approx(50_549_886_025_728 / 989e12 + 22 * p / 3.35e12)


def test_serve_batch_flops_and_bytes_by_hand():
    b, s, new = 32, 2048, 16
    layers = 28 * (2 * 2048 * 2048 + 2 * 2048 * 1024 + 3 * 2048 * 6144)
    assert layers == 1_409_286_144
    unembed = 2048 * 151936
    phases = counts.serve_batch(QWEN3, b, s, new)
    assert len(phases) == new
    prefill_attention = 28 * b * 16 * (2048 * 2049 // 2) * 4 * 128
    assert phases[0]["flops"] == 2 * layers * b * s + prefill_attention + 2 * unembed * b
    kv = 2 * 28 * 8 * 128 * 2  # bytes of one token's K and V in all layers
    w = 2 * weights.n_params(QWEN3)
    assert phases[0]["bytes"] == w + kv * b * s + 4 * b * s
    # decode step k attends 2,048 + k slots and reads the (tied) table whole
    for k in (1, 15):
        ctx = s + k
        assert phases[k]["flops"] == 2 * (layers + unembed) * b + 4 * b * 16 * 128 * ctx * 28
        assert phases[k]["bytes"] == w + kv * b * ctx
    assert counts.flops(phases) == sum(p["flops"] for p in phases)
    # the prefill is bound by FLOPs, a decode step by bytes
    assert phases[0]["flops"] / 989e12 > phases[0]["bytes"] / 3.35e12
    assert phases[5]["flops"] / 989e12 < phases[5]["bytes"] / 3.35e12


def test_untied_decode_reads_only_the_rows_it_embeds():
    tied = counts.serve_batch(QWEN15, 4, 64, 2)[1]["bytes"]
    whole = 2 * weights.n_params(QWEN15) + 2 * 24 * 16 * 64 * 2 * 4 * 65
    assert tied == whole - 2 * (151936 - 4) * 1024
