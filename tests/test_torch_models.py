"""The port's dense LM serving path against the JAX package's (the other
families: ``tests/test_torch_families.py``).

``repro_torch.models`` holds every family of ``repro.models``; here the
dense one: the layers, the ``Transformer`` (``init_params``, ``forward``), the KV-cache
serving (``init_cache``, ``prefill``, ``decode_step``) and
``weights.from_reference`` / ``to_reference``. The weights of each case
are drawn by the reference's ``init_params`` and carried across, so both
packages compute on the same numbers. Tolerances: fp32 logits within
``FP32_REL`` of the largest |logit| (the gap is summation order; seen
below 1e-6 here), bf16 within ``BF16_REL`` (JAX and torch round bf16
products differently, ~0.009 here; the reference's own bf16 cache test
allows 0.12).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.models import layers as rlayers
from repro_torch import configs
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
    tp_pad,
)
from repro_torch.models import layers
from repro_torch.models.weights import from_reference, to_reference

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen3-1.7b", "qwen1.5-0.5b", "qwen2-7b", "qwen1.5-4b"]
FP32_REL = 2e-5
BF16_REL = 0.05


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = rlayers.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale), 1e-6)
    got = layers.rms_norm(_t(x, td), _t(scale), 1e-6)
    assert got.dtype == td
    assert _rel(got, _np(want)) < (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    np.testing.assert_array_equal(layers.rope_freqs(64, theta), rlayers.rope_freqs(64, theta))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), theta)
    assert _rel(got, _np(want)) < 1e-5


def _qkv(seed, b=2, sq=16, sk=16, h=4, kv=2, hd=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("k_chunk", [16, 4, 5, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len", [None, (16, 9)])
def test_attention(k_chunk, causal, kv_len):
    q, k, v = _qkv(2)
    lens = None if kv_len is None else np.array(kv_len, np.int32)
    want = rlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             k_chunk=k_chunk, kv_len=None if lens is None else jnp.asarray(lens))
    got = layers.attention(_t(q), _t(k), _t(v), causal=causal, k_chunk=k_chunk,
                           kv_len=None if lens is None else torch.from_numpy(lens))
    assert got.shape == q.shape
    assert _rel(got, _np(want)) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(64, 64), (40, 150)])
@pytest.mark.parametrize("kv", [8, 4, 1])
@pytest.mark.parametrize("all_masked", [False, True])
def test_attention_and_its_gradients_at_the_kernels_cases(causal, sq, sk, kv, all_masked):
    """The plain version against the reference where the CUDA kernel is
    held to the plain version on the card (tests/test_torch_attention_kernel.py,
    whose card has no JAX): 8 query heads over 8, 4 or 1 KV heads, Sq !=
    Sk with a ragged Sk, a batch row whose keys are all masked; o and the
    gradients of <o, do> for q, k and v, in fp32."""
    q, k, v = _qkv(5, sq=sq, sk=sk, h=8, kv=kv, hd=32)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    lens = np.array([0, sk * 2 // 3], np.int32) if all_masked else None
    jlens = None if lens is None else jnp.asarray(lens)
    want, vjp = jax.vjp(lambda *a: rlayers.attention(*a, causal=causal, kv_len=jlens),
                        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    got = layers.attention(*leaves, causal=causal,
                           kv_len=None if lens is None else torch.from_numpy(lens))
    got.backward(_t(do))
    for name, g, w in zip(("o", "dq", "dk", "dv"), [got.detach()] + [t.grad for t in leaves],
                          [want, *vjp(jnp.asarray(do))]):
        assert _rel(g, _np(w)) < 1e-5, name


@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (8, 1)])
def test_decode_attention(h, kv):
    q, k, v = _qkv(3, sq=1, sk=12, h=h, kv=kv)
    lens = np.array([12, 5], np.int32)
    want = rlayers.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens))
    got = layers.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(lens))
    assert _rel(got, _np(want)) < 1e-5


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn(act):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    p = {"w1": rng.normal(size=(16, 24)), "w2": rng.normal(size=(24, 16))}
    p.update({"w3": rng.normal(size=(16, 24))} if act == "swiglu"
             else {"b1": rng.normal(size=(24,)), "b2": rng.normal(size=(16,))})
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = rlayers.ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, act)
    got = layers.ffn(_t(x), {k: _t(v) for k, v in p.items()}, act)
    assert _rel(got, _np(want)) < 1e-5


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    want, got = rconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.padded_vocab == want.padded_vocab and got.block_period == want.block_period
    for shape in rconfigs.SHAPES:
        assert configs.shape_applicable(arch, shape) == rconfigs.shape_applicable(arch, shape)
    for tp in (1, 4, 16):
        assert dataclasses.asdict(tp_pad(got, tp)) == dataclasses.asdict(
            rmodels.tp_pad(want, tp))


# ------------------------------------------------------- the model as a whole

@pytest.fixture(scope="module")
def carried():
    """arch -> (reference cfg, reference params, port model), fp32, reduced."""
    out = {}
    for arch in DENSE:
        rcfg = rconfigs.get_config(arch).reduced(dtype="float32")
        params = rmodels.init_params(rcfg, jax.random.PRNGKey(DENSE.index(arch)))
        model = from_reference(configs.get_config(arch).reduced(dtype="float32"),
                               jax.tree.map(np.asarray, params), device="cpu")
        out[arch] = (rcfg, params, model)
    return out


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(carried, arch):
    rcfg, params, model = carried[arch]
    toks = _tokens(rcfg)
    want, _ = rmodels.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    got, aux = forward(model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 16, rcfg.padded_vocab) and float(aux) == 0.0
    assert _rel(got, _np(want)) < FP32_REL


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(carried, arch):
    rcfg, params, model = carried[arch]
    toks = _tokens(rcfg, seed=1)
    lw, cw = rmodels.prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :8])}, max_len=20)
    lg, cg = prefill(model, {"tokens": torch.from_numpy(toks[:, :8])}, 20)
    assert _rel(lg, _np(lw)) < FP32_REL
    for t in range(8, 14):
        lw, cw = rmodels.decode_step(params, rcfg, cw, jnp.asarray(toks[:, t:t + 1]))
        lg, cg = decode_step(model, cg, torch.from_numpy(toks[:, t:t + 1]))
        assert _rel(lg, _np(lw)) < FP32_REL, t
    np.testing.assert_array_equal(cg["pos"].numpy(), np.asarray(cw["pos"]))
    for i, block in enumerate(cg["blocks"]):
        for kv in ("k", "v"):
            assert _rel(block["sub0"][kv], _np(cw["blocks"]["sub0"][kv][i])) < FP32_REL


@pytest.mark.parametrize("arch", DENSE)
def test_cache_equals_forward(carried, arch):
    """prefill + decode logits == the forward's at the same positions."""
    _, _, model = carried[arch]
    toks = torch.from_numpy(_tokens(model.cfg, s=12, seed=2))
    full, _ = forward(model, {"tokens": toks})
    lg, cache = prefill(model, {"tokens": toks[:, :6]}, 16)
    seq = [lg]
    for t in range(6, 12):
        lg, cache = decode_step(model, cache, toks[:, t:t + 1])
        seq.append(lg)
    got = torch.stack(seq[:-1], dim=1)
    assert _rel(got, full[:, 5:11].numpy()) < FP32_REL


def test_unstacked_blocks_match_reference():
    """``scan_layers=False``: the reference's blocks as a list."""
    rcfg = rconfigs.get_config("qwen2-7b").reduced(dtype="float32", scan_layers=False)
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(5))
    assert isinstance(params["blocks"], list)
    model = from_reference(configs.get_config("qwen2-7b").reduced(
        dtype="float32", scan_layers=False), jax.tree.map(np.asarray, params), device="cpu")
    toks = _tokens(rcfg, seed=3)
    want, _ = rmodels.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    got, _ = forward(model, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, _np(want)) < FP32_REL
    back = to_reference(model)
    assert isinstance(back["blocks"], list)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, params)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_tied_embeddings_match_reference():
    """``tie_embeddings``: no unembedding; the logits use the embedding's
    transpose, in the forward and in the cache path."""
    over = dict(dtype="float32", tie_embeddings=True)
    rcfg = rconfigs.get_config("qwen1.5-0.5b").reduced(**over)
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(6))
    assert "unembed" not in params
    model = from_reference(configs.get_config("qwen1.5-0.5b").reduced(**over),
                           jax.tree.map(np.asarray, params), device="cpu")
    assert model.unembed is None
    toks = _tokens(rcfg, seed=8)
    want, _ = rmodels.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    got, _ = forward(model, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, _np(want)) < FP32_REL
    lw, cw = rmodels.prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :8])}, max_len=10)
    lg, cg = prefill(model, {"tokens": torch.from_numpy(toks[:, :8])}, 10)
    lw, _ = rmodels.decode_step(params, rcfg, cw, jnp.asarray(toks[:, 8:9]))
    lg, _ = decode_step(model, cg, torch.from_numpy(toks[:, 8:9]))
    assert _rel(lg, _np(lw)) < FP32_REL


def test_bf16_matches_reference():
    rcfg = rconfigs.get_config("qwen3-1.7b").reduced()
    assert rcfg.dtype == "bfloat16"
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    assert tree["embed"].dtype.name == "bfloat16"
    model = from_reference(configs.get_config("qwen3-1.7b").reduced(), tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[0]["sub0"].attn["q_norm"].dtype == torch.float32
    assert model.blocks[0]["sub0"].ln1.dtype == torch.float32
    toks = _tokens(rcfg, seed=4)
    want, _ = rmodels.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    got, _ = forward(model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    assert _rel(got, _np(want)) < BF16_REL
    lw, cw = rmodels.prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :8])}, max_len=12)
    lg, cg = prefill(model, {"tokens": torch.from_numpy(toks[:, :8])}, 12)
    assert _rel(lg, _np(lw)) < BF16_REL
    for t in range(8, 11):
        lw, cw = rmodels.decode_step(params, rcfg, cw, jnp.asarray(toks[:, t:t + 1]))
        lg, cg = decode_step(model, cg, torch.from_numpy(toks[:, t:t + 1]))
        assert _rel(lg, _np(lw)) < BF16_REL, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_round_trip(dtype):
    cfg = configs.get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    model = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    tree = to_reference(model)
    back = from_reference(cfg, tree, device="cpu")
    for (na, a), (nb, b) in zip(model.named_parameters(), back.named_parameters()):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b), na
    # the tree has the reference's layout: the same keys and shapes
    rcfg = rconfigs.get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    want = jax.eval_shape(lambda k: rmodels.init_params(rcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, tree))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tree)):
        assert tuple(w.shape) == g.shape


def test_from_reference_rejects_a_wrong_tree():
    cfg = configs.get_config("qwen3-1.7b").reduced(dtype="float32")
    tree = to_reference(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        from_reference(cfg, bad, device="cpu")
    del bad["extra"], bad["ln_f"]
    with pytest.raises(KeyError):
        from_reference(cfg, bad, device="cpu")
    bad = dict(tree, ln_f=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        from_reference(cfg, bad, device="cpu")
    # more blocks than the model: stacked on the leading axis, and as a list
    deeper = dataclasses.replace(cfg, n_layers=cfg.n_layers + cfg.block_period)
    bad = to_reference(init_params(deeper, torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="blocks"):
        from_reference(cfg, bad, device="cpu")
    listed = dataclasses.replace(cfg, scan_layers=False)
    bad = to_reference(init_params(listed, torch.Generator().manual_seed(0), device="cpu"))
    bad["blocks"].append(bad["blocks"][0])
    with pytest.raises(ValueError, match="blocks"):
        from_reference(listed, bad, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_scales(dtype):
    """The reference's distributions: N(0, s) with s = fan_in ** -0.5, the
    output projections divided by sqrt(2 L), the embedding 0.02; biases
    zero and norms one in fp32."""
    cfg = configs.get_config("qwen1.5-0.5b").reduced(dtype=dtype, d_model=256, d_ff=512)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    deep = np.sqrt(2 * cfg.n_layers)
    sub = model.blocks[0]["sub0"]
    for name, p, s in (("embed", model.embed, 0.02), ("unembed", model.unembed, 256 ** -0.5),
                       ("wq", sub.attn["wq"], 256 ** -0.5), ("wo", sub.attn["wo"],
                                                              128 ** -0.5 / deep),
                       ("w1", sub.ffn["w1"], 256 ** -0.5), ("w2", sub.ffn["w2"],
                                                            512 ** -0.5 / deep)):
        assert p.dtype == want_dt, name
        assert abs(float(p.float().std()) / s - 1) < 0.05, name
    assert sub.ln1.dtype == torch.float32 and bool((sub.ln1 == 1).all())
    assert bool((sub.attn["bq"] == 0).all()) and sub.attn["bq"].dtype == want_dt
    # one seed, one model
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.embed, model.embed)


def test_decode_at_a_full_cache_clamps_like_reference(carried):
    """pos == max_len: the write lands at max_len - 1 (the reference's
    dynamic_update_slice clamps), and every slot is attended."""
    rcfg, params, model = carried["qwen3-1.7b"]
    toks = _tokens(rcfg, s=10, seed=5)
    lw, cw = rmodels.prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :8])}, max_len=8)
    lg, cg = prefill(model, {"tokens": torch.from_numpy(toks[:, :8])}, 8)
    assert int(cg["pos"][0]) == 8
    for t in (8, 9):
        lw, cw = rmodels.decode_step(params, rcfg, cw, jnp.asarray(toks[:, t:t + 1]))
        lg, cg = decode_step(model, cg, torch.from_numpy(toks[:, t:t + 1]))
        assert _rel(lg, _np(lw)) < FP32_REL, t
    assert cg["pos"].tolist() == [10, 10]
    for i, block in enumerate(cg["blocks"]):
        assert _rel(block["sub0"]["k"], _np(cw["blocks"]["sub0"]["k"][i])) < FP32_REL


def test_rows_write_at_the_first_rows_position(carried):
    """Every row writes its new K/V at pos[0], as in the reference, even
    when the rows' positions differ; each row masks to its own pos + 1."""
    rcfg, params, model = carried["qwen2-7b"]
    toks = _tokens(rcfg, s=9, seed=6)
    cw = rmodels.prefill(params, rcfg, {"tokens": jnp.asarray(toks[:, :8])}, max_len=12)[1]
    cg = prefill(model, {"tokens": torch.from_numpy(toks[:, :8])}, 12)[1]
    cw = dict(cw, pos=jnp.asarray([5, 8], jnp.int32))
    cg = dict(cg, pos=torch.tensor([5, 8], dtype=torch.int32))
    lw, cw = rmodels.decode_step(params, rcfg, cw, jnp.asarray(toks[:, 8:9]))
    lg, cg = decode_step(model, cg, torch.from_numpy(toks[:, 8:9]))
    assert _rel(lg, _np(lw)) < FP32_REL
    for i, block in enumerate(cg["blocks"]):
        assert _rel(block["sub0"]["v"], _np(cw["blocks"]["sub0"]["v"][i])) < FP32_REL


def test_init_cache_layout():
    cfg = configs.get_config("qwen2-7b").reduced()
    cache = init_cache(cfg, 3, 20, device="cpu")
    assert cache["pos"].dtype == torch.int32 and cache["pos"].tolist() == [0, 0, 0]
    assert len(cache["blocks"]) == cfg.n_layers
    k = cache["blocks"][0]["sub0"]["k"]
    assert k.shape == (3, 20, cfg.n_kv_heads, cfg.head_dim) and k.dtype == torch.bfloat16
    rc = rmodels.init_cache(rconfigs.get_config("qwen2-7b").reduced(), 3, 20)
    assert rc["blocks"]["sub0"]["k"].shape[1:] == tuple(k.shape)


def test_serve_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu"],
                          env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert out[:2] == ["batch of 4 served (4/8)", "batch of 4 served (8/8)"]
    assert out[-1].startswith("8 requests x 16 tokens in ")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_serve_cli_defaults_to_the_card():
    """--device is "cuda" by default, checked before the weights are built."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"], env=env,
                          cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "served" not in proc.stdout


def test_serve_loop_is_deterministic_and_greedy():
    from repro_torch.launch.serve import serve_requests

    cfg = configs.get_config("qwen3-1.7b").reduced(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    runs = [serve_requests(model, 3, 2, 6, 4, np.random.default_rng(0), log=lambda m: None)
            for _ in range(2)]
    assert runs[0]["served"] == 3 and runs[0]["decode_steps"] == 6
    for a, b in zip(runs[0]["tokens"], runs[1]["tokens"]):
        assert torch.equal(a, b) and a.shape == (2, 4)
    # the first token is the prefill's argmax over the padded vocabulary
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (2, 6)).astype(np.int32)
    lg, _ = prefill(model, {"tokens": torch.from_numpy(toks)}, 10)
    assert torch.equal(runs[0]["tokens"][0][:, 0], lg.argmax(-1).to(torch.int32))
