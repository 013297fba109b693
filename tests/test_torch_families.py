"""The port's serving path for the LM zoo's families other than dense
(MoE, the Mamba hybrid, RWKV6, the VLM, the audio encoder-decoder)
against the JAX package's.

Every case draws its weights with the reference's ``init_params`` (or a
module's own) and carries them across with ``weights.from_reference``,
so both packages compute on the same numbers, at ``.reduced()`` widths.
Tolerances: fp32 outputs within ``FP32_REL`` of the largest |value| (the
gap is summation order and the scans' composition order: up to ~6e-6
here, on jamba), bf16 within ``BF16_REL`` (JAX and torch round bf16
products differently).
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
from repro.models import mamba as rmamba
from repro.models import moe as rmoe
from repro.models import rwkv6 as rrwkv6
from repro_torch import configs
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models import mamba, rwkv6
from repro_torch.models.moe import moe_ffn
from repro_torch.models.weights import from_reference, to_reference

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen3-1.7b", "qwen1.5-0.5b", "qwen2-7b", "qwen1.5-4b"]
OTHER = [a for a in rconfigs.ARCH_IDS if a not in DENSE]
FP32_REL = 2e-5
BF16_REL = 0.05


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _batch(cfg, b=2, s=16, seed=0) -> dict:
    """Tokens and the family's stubs (random, so that they matter)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.n_patches:
        out["vision"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


PREFILL, STEPS = 8, 6


class _Carried:
    """arch -> the reduced fp32 reference and port models on the same
    weights, and the reference's outputs, each computed once."""

    def __init__(self):
        self._out = {}

    def __getitem__(self, arch):
        if arch not in self._out:
            rcfg = rconfigs.get_config(arch).reduced(dtype="float32")
            params = rmodels.init_params(rcfg, jax.random.PRNGKey(OTHER.index(arch)))
            model = from_reference(configs.get_config(arch).reduced(dtype="float32"),
                                   jax.tree.map(np.asarray, params), device="cpu")
            batch = _batch(rcfg)
            logits, aux = rmodels.forward(params, rcfg, _j(batch))
            max_len = PREFILL + STEPS + rcfg.n_patches
            pre = dict(batch, tokens=batch["tokens"][:, :PREFILL])
            lw, cw = rmodels.prefill(params, rcfg, _j(pre), max_len=max_len)
            steps = [np.asarray(lw)]
            for t in range(PREFILL, PREFILL + STEPS):
                lw, cw = rmodels.decode_step(params, rcfg, cw,
                                             jnp.asarray(batch["tokens"][:, t:t + 1]))
                steps.append(np.asarray(lw))
            self._out[arch] = {
                "rcfg": rcfg, "params": params, "model": model, "batch": batch,
                "max_len": max_len, "logits": np.asarray(logits), "aux": float(aux),
                "steps": steps, "cache": jax.tree.map(np.asarray, cw)}
        return self._out[arch]


@pytest.fixture(scope="module")
def carried():
    return _Carried()


# ------------------------------------------------------- the model as a whole

@pytest.mark.parametrize("arch", OTHER)
def test_forward_matches_reference(carried, arch):
    c = carried[arch]
    got, aux = forward(c["model"], _tt(c["batch"]))
    n = c["batch"]["tokens"].shape[1] + c["rcfg"].n_patches
    assert got.shape == (2, n, c["rcfg"].padded_vocab)
    assert _rel(got, c["logits"]) < FP32_REL
    assert aux.dtype == torch.float32
    assert abs(float(aux) - c["aux"]) <= 1e-5 * max(1.0, abs(c["aux"]))
    assert (c["aux"] > 0) == (c["rcfg"].n_experts > 0)


@pytest.mark.parametrize("arch", OTHER)
def test_prefill_and_decode_match_reference(carried, arch):
    c = carried[arch]
    batch = c["batch"]
    pre = dict(batch, tokens=batch["tokens"][:, :PREFILL])
    lg, cg = prefill(c["model"], _tt(pre), c["max_len"])
    assert _rel(lg, c["steps"][0]) < FP32_REL
    for i, t in enumerate(range(PREFILL, PREFILL + STEPS)):
        lg, cg = decode_step(c["model"], cg, torch.from_numpy(batch["tokens"][:, t:t + 1]))
        assert _rel(lg, c["steps"][i + 1]) < FP32_REL, t
    want = c["cache"]
    np.testing.assert_array_equal(cg["pos"].numpy(), want["pos"])
    for i, block in enumerate(cg["blocks"]):
        for sub, state in block.items():
            assert set(state) == set(want["blocks"][sub]), sub
            for name, leaf in state.items():
                assert _rel(leaf, want["blocks"][sub][name][i]) < FP32_REL, (i, sub, name)
    if c["rcfg"].n_enc_layers:
        for i, xc in enumerate(cg["xattn"]):
            for name in ("k", "v"):
                assert _rel(xc[name], want["xattn"][name][i]) < FP32_REL, (i, name)


@pytest.mark.parametrize("arch", OTHER)
def test_cache_equals_forward(carried, arch):
    """prefill + decode logits == the forward's at the same positions. A
    MoE drops slots by a capacity that depends on the tokens of a call, so
    a decode step drops other slots than the forward does (the reference
    too): here every expert has room for every slot."""
    model = carried[arch]["model"]
    cfg = model.cfg
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        model = from_reference(cfg, to_reference(model), device="cpu")
    batch = _tt(_batch(cfg, seed=2))
    full, _ = forward(model, batch)
    toks = batch["tokens"]
    lg, cache = prefill(model, dict(batch, tokens=toks[:, :8]), 16 + cfg.n_patches)
    seq = [lg]
    for t in range(8, 16):
        lg, cache = decode_step(model, cache, toks[:, t:t + 1])
        seq.append(lg)
    p = cfg.n_patches
    assert _rel(torch.stack(seq[:-1], dim=1), full[:, p + 7:p + 15].numpy()) < FP32_REL


def test_whisper_decode_past_the_cache_clamps_like_reference(carried):
    """pos == max_len: the reference's sine-position gather clamps into
    the table (JAX), as its K/V write does; the port clamps both."""
    c = carried["whisper-base"]
    rcfg, params, model = c["rcfg"], c["params"], c["model"]
    batch = _batch(rcfg, s=10, seed=5)
    pre = dict(batch, tokens=batch["tokens"][:, :8])
    lw, cw = rmodels.prefill(params, rcfg, _j(pre), max_len=8)
    lg, cg = prefill(model, _tt(pre), 8)
    assert int(cg["pos"][0]) == 8
    for t in (8, 9):
        lw, cw = rmodels.decode_step(params, rcfg, cw, jnp.asarray(batch["tokens"][:, t:t + 1]))
        lg, cg = decode_step(model, cg, torch.from_numpy(batch["tokens"][:, t:t + 1]))
        assert torch.isfinite(lg).all()
        assert _rel(lg, np.asarray(lw)) < FP32_REL, t
    assert cg["pos"].tolist() == [10, 10]


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_bf16_matches_reference(arch):
    """bf16 weights: the port's logits are as close to the reference's
    fp32 run on the same weights as the reference's own bf16 forward is
    (its bf16 noise), or within ``BF16_REL`` of it. That noise is what
    bounds the two packages' distance: on jamba's 16 reduced layers it is
    ~0.12 of max |logit| (mamba's rounding: JAX's bf16 ``silu`` rounds
    ``sigmoid`` and the product apart), on dbrx ~0.01."""
    rcfg = rconfigs.get_config(arch).reduced()
    assert rcfg.dtype == "bfloat16"
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(7))
    r32 = dataclasses.replace(rcfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = from_reference(configs.get_config(arch).reduced(), jax.tree.map(np.asarray, params),
                           device="cpu")
    assert model.embed.dtype == torch.bfloat16
    moe = next(s.moe for b in model.blocks for s in b.values() if s.ffn_kind == "moe")
    assert moe["wg"].dtype == torch.float32 and moe["w1"].dtype == torch.bfloat16

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    batch = _batch(rcfg, seed=4)
    want32 = f32(rmodels.forward(p32, r32, _j(batch))[0])
    bound = max(BF16_REL, _rel(f32(rmodels.forward(params, rcfg, _j(batch))[0]), want32))

    def check(got, want, what):
        assert _rel(got, f32(want)) <= bound, (what, _rel(got, f32(want)), bound)

    got, _ = forward(model, _tt(batch))
    assert got.dtype == torch.bfloat16
    check(got, want32, "forward")
    pre = dict(batch, tokens=batch["tokens"][:, :8])
    l32, c32 = rmodels.prefill(p32, r32, _j(pre), max_len=12)
    lg, cg = prefill(model, _tt(pre), 12)
    check(lg, l32, "prefill")
    for t in range(8, 11):
        tok = batch["tokens"][:, t:t + 1]
        l32, c32 = rmodels.decode_step(p32, r32, c32, jnp.asarray(tok))
        lg, cg = decode_step(model, cg, torch.from_numpy(tok))
        check(lg, l32, t)


# ----------------------------------------------------------------- modules

def _moe_case(seed, b, s, d, f, e, act):
    rng = np.random.default_rng(seed)
    p = {"wg": rng.normal(size=(d, e)) * d ** -0.5,
         "w1": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w2": rng.normal(size=(e, f, d)) * f ** -0.5}
    if act == "swiglu":
        p["w3"] = rng.normal(size=(e, d, f)) * d ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return rng.normal(size=(b, s, d)).astype(np.float32), p


# (batch, seq, experts, top_k, capacity_factor, group, act): slots that
# fit; slots that overflow capacity; a decode step (capacity 1); a group
# size that does not divide the tokens (the reference searches down)
MOE_CASES = {
    "fits": (2, 16, 4, 2, 4.0, 512, "swiglu"),
    "overflow": (2, 16, 4, 2, 0.5, 512, "swiglu"),
    "decode": (4, 1, 16, 4, 1.25, 512, "swiglu"),
    "group": (2, 12, 4, 2, 1.0, 10, "gelu"),
}


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(impl, case):
    b, s, e, k, cf, group, act = MOE_CASES[case]
    x, p = _moe_case(11, b, s, 32, 48, e, act)
    kw = dict(top_k=k, act=act, impl=impl, group=group)
    want, waux = rmoe.moe_ffn(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
                              capacity_factor=cf, **kw)
    got, aux = moe_ffn(_t(x), {n: _t(v) for n, v in p.items()}, capacity_factor=cf, **kw)
    assert got.shape == x.shape and aux.dtype == torch.float32
    assert _rel(got, np.asarray(want)) < FP32_REL
    assert abs(float(aux) - float(waux)) < 1e-6
    # the same slots dropped: against the run with room for every slot, the
    # rows that lost a slot differ in both packages alike
    roomy, _ = moe_ffn(_t(x), {n: _t(v) for n, v in p.items()}, capacity_factor=64.0, **kw)
    lost = (got - roomy).abs().amax(-1) > 1e-6
    wroomy, _ = rmoe.moe_ffn(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
                             capacity_factor=64.0, **kw)
    wlost = np.abs(np.asarray(want) - np.asarray(wroomy)).max(-1) > 1e-6
    np.testing.assert_array_equal(lost.numpy(), wlost)
    assert bool(lost.any()) == (case != "fits"), int(lost.sum())


def _ssm_cfg(**over):
    return rconfigs.get_config("jamba-v0.1-52b").reduced(dtype="float32", **over)


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_mamba_matches_reference(n_chunks):
    cfg = _ssm_cfg()
    params = rmamba.init_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    # a wider dt than the init's softplus(-2), so the state carries
    params = dict(params, dt_bias=jnp.full_like(params["dt_bias"], 0.5))
    tp = {k: _t(v) for k, v in params.items()}
    rng = np.random.default_rng(n_chunks)
    x = rng.normal(size=(2, 8 * n_chunks + 3, cfg.d_model)).astype(np.float32)
    seq = x[:, :8 * n_chunks]
    yw, (cw, hw) = rmamba.mamba_seq(jnp.asarray(seq), params, cfg)
    yg, (cg, hg) = mamba.mamba_seq(_t(seq), tp, cfg)
    assert _rel(yg, np.asarray(yw)) < FP32_REL
    assert _rel(cg, np.asarray(cw)) < FP32_REL and _rel(hg, np.asarray(hw)) < FP32_REL
    assert hg.dtype == torch.float32 and cg.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    sw, sg = (cw, hw), (cg, hg)
    for t in range(8 * n_chunks, x.shape[1]):
        yw, sw = rmamba.mamba_decode(jnp.asarray(x[:, t:t + 1]), params, cfg, sw)
        yg, sg = mamba.mamba_decode(_t(x[:, t:t + 1]), tp, cfg, sg)
        assert _rel(yg, np.asarray(yw)) < FP32_REL, t
    assert _rel(sg[1], np.asarray(sw[1])) < FP32_REL
    with pytest.raises(AssertionError):  # the reference's: whole chunks only
        mamba.mamba_seq(_t(x[:, :10]), tp, cfg)


def _rwkv(seed, decay0=None):
    cfg = rconfigs.get_config("rwkv6-7b").reduced(dtype="float32")
    params = rrwkv6.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    if decay0 is not None:
        params = dict(params, w_decay0=jnp.full_like(params["w_decay0"], decay0))
    cmix = rrwkv6.init_cmix_params(jax.random.PRNGKey(seed + 1), cfg, jnp.float32)
    return cfg, params, cmix


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_rwkv_matches_reference(n_chunks):
    cfg, params, cmix = _rwkv(4)
    tp = {k: _t(v) for k, v in params.items()}
    rng = np.random.default_rng(n_chunks)
    x = rng.normal(size=(2, 8 * n_chunks + 3, cfg.d_model)).astype(np.float32)
    seq = x[:, :8 * n_chunks]
    yw, sw = rrwkv6.rwkv_seq(jnp.asarray(seq), params, cfg)
    yg, sg = rwkv6.rwkv_seq(_t(seq), tp, cfg)
    assert _rel(yg, np.asarray(yw)) < FP32_REL
    assert _rel(sg[1], np.asarray(sw[1])) < FP32_REL and sg[1].dtype == torch.float32
    for t in range(8 * n_chunks, x.shape[1]):
        yw, sw = rrwkv6.rwkv_decode(jnp.asarray(x[:, t:t + 1]), params, cfg, sw)
        yg, sg = rwkv6.rwkv_decode(_t(x[:, t:t + 1]), tp, cfg, sg)
        assert _rel(yg, np.asarray(yw)) < FP32_REL, t
    assert _rel(sg[1], np.asarray(sw[1])) < FP32_REL
    # the state carried into a second sequence, and the channel mix
    yw, _ = rrwkv6.rwkv_seq(jnp.asarray(seq), params, cfg, state=sw)
    yg, _ = rwkv6.rwkv_seq(_t(seq), tp, cfg, state=sg)
    assert _rel(yg, np.asarray(yw)) < FP32_REL
    hw, xw = rrwkv6.cmix_seq(jnp.asarray(seq), cmix)
    hg, xg = rwkv6.cmix_seq(_t(seq), {k: _t(v) for k, v in cmix.items()})
    assert _rel(hg, np.asarray(hw)) < FP32_REL and torch.equal(xg, _t(seq[:, -1]))


def test_rwkv_clamp_matches_reference():
    """A chunk whose cumulative log-decay passes CLAMP: the port clamps the
    cumulative sum within the chunk (and each decode step's) as the
    reference does, and so leaves the step recurrence where it does."""
    assert rwkv6.CLAMP == rrwkv6.CLAMP == -30.0
    cfg, params, _ = _rwkv(6, decay0=2.0)
    tp = {k: _t(v) for k, v in params.items()}
    x = np.random.default_rng(9).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    xprev = rwkv6._shift(_t(x))
    logw = rwkv6._projections(_t(x), xprev, tp, cfg)[4]
    assert float(torch.cumsum(logw[:, :8], dim=1).min()) < 2 * rwkv6.CLAMP
    seq_w, sw = rrwkv6.rwkv_seq(jnp.asarray(x), params, cfg)
    seq_g, sg = rwkv6.rwkv_seq(_t(x), tp, cfg)
    assert _rel(seq_g, np.asarray(seq_w)) < FP32_REL
    assert _rel(sg[1], np.asarray(sw[1])) < FP32_REL
    yw, _ = rrwkv6.rwkv_decode(jnp.asarray(x[:, :1]), params, cfg, sw)
    yg, _ = rwkv6.rwkv_decode(_t(x[:, :1]), tp, cfg, sg)
    assert _rel(yg, np.asarray(yw)) < FP32_REL
    # the clamp is the reference's fault, copied: past it the chunked form
    # leaves the step recurrence (decode's), in both packages; with chunks
    # of one step the two agree
    state, steps = None, []
    for t in range(x.shape[1]):
        state = rwkv6.init_state(2, cfg, torch.float32, "cpu") if state is None else state
        y, state = rwkv6.rwkv_decode(_t(x[:, t:t + 1]), tp, cfg, state)
        steps.append(y)
    recurrence = torch.cat(steps, dim=1)
    assert _rel(seq_g, recurrence) > 0.01 and _rel(np.asarray(seq_w), recurrence) > 0.01
    one = rwkv6.rwkv_seq(_t(x), tp, dataclasses.replace(cfg, ssm_chunk=1))[0]
    assert _rel(one, recurrence) < FP32_REL


# ------------------------------------------------------ init, weights, cache

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-base"])
def test_init_params_scales_by_leaf(arch, dtype):
    """Each new leaf has the reference's rule by its name: experts scale by
    their d or f (not E), the router is fp32; mamba's conv_b 0, dt_bias -2,
    D 1, A_log log(1..d_state) in fp32; RWKV's mixes 0.5, w_decay0 -1 and
    u_bonus N(0, 0.1) in fp32, ln_scale (H, hd) ones; whisper's encoder and
    cross-attention as the decoder's."""
    cfg = configs.get_config(arch).reduced(dtype=dtype, d_model=256, d_ff=512)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    deep = np.sqrt(2 * cfg.n_layers)
    d, f = 256, 512
    f32 = torch.float32
    subs = [s for b in model.blocks for s in b.values()]

    def std(p, want, name, tol=0.05):
        assert abs(float(p.float().std()) / want - 1) < tol, name

    for sub in subs:
        assert sub.ln1.dtype == f32 and bool((sub.ln1 == 1).all())
    if cfg.n_experts:
        moe = next(s.moe for s in subs if s.ffn_kind == "moe")
        assert moe["wg"].dtype == f32 and moe["w1"].dtype == dt
        std(moe["wg"], d ** -0.5, "wg")
        std(moe["w1"], d ** -0.5, "w1")
        std(moe["w3"], d ** -0.5, "w3")
        std(moe["w2"], f ** -0.5 / deep, "w2")
    if cfg.family == "hybrid":
        m = next(s.mamba for s in subs if s.kind == "mamba")
        assert m["conv_b"].dtype == dt and bool((m["conv_b"] == 0).all())
        assert m["dt_bias"].dtype == dt and bool((m["dt_bias"] == -2).all())
        assert m["D"].dtype == f32 and bool((m["D"] == 1).all())
        want = np.log(np.broadcast_to(np.arange(1, cfg.ssm_state + 1, dtype=np.float32),
                                      (cfg.d_inner, cfg.ssm_state)))
        assert m["A_log"].dtype == f32
        np.testing.assert_allclose(m["A_log"].detach().numpy(), want, rtol=1e-6)
        std(m["in_proj"], d ** -0.5, "in_proj")
        std(m["out_proj"], cfg.d_inner ** -0.5, "out_proj")
        std(m["x_proj"], cfg.d_inner ** -0.5, "x_proj")
        std(m["conv_w"], cfg.ssm_conv ** -0.5, "conv_w", 0.1)
    if cfg.family == "ssm":
        t, c = subs[0].tmix, subs[0].cmix
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            assert t[name].dtype == dt and bool((t[name] == 0.5).all()), name
        assert c["mu"].dtype == dt and bool((c["mu"] == 0.5).all())
        assert t["w_decay0"].dtype == f32 and bool((t["w_decay0"] == -1).all())
        assert t["u_bonus"].dtype == f32
        std(t["u_bonus"], 0.1, "u_bonus", 0.15)
        assert t["ln_scale"].shape == (cfg.n_rwkv_heads, cfg.rwkv_head_dim)
        assert t["ln_scale"].dtype == f32 and bool((t["ln_scale"] == 1).all())
        std(t["w_o"], d ** -0.5, "w_o")
        std(t["w_decay2"], cfg.rwkv_decay_lora ** -0.5, "w_decay2", 0.1)
        std(c["wv"], f ** -0.5, "cmix.wv")
    if cfg.n_enc_layers:
        enc, xa = model.encoder[0], model.xattn[0]
        assert model.enc_ln_f.dtype == f32 and bool((model.enc_ln_f == 1).all())
        assert xa.lnx.dtype == f32 and "bq" not in xa.xattn
        std(enc.attn["wo"], (cfg.n_heads * cfg.head_dim) ** -0.5 / deep, "enc.wo")
        std(xa.xattn["wq"], d ** -0.5, "xattn.wq")
        assert bool((enc.ffn["b1"] == 0).all())


def test_whisper_weights_round_trip_unstacked():
    """``scan_layers=False``: the blocks are a list, the encoder and the
    cross-attention stay stacked, as the reference ``vmap``s them; a
    stack of the wrong depth raises."""
    rcfg = rconfigs.get_config("whisper-base").reduced(dtype="float32", scan_layers=False)
    params = jax.tree.map(np.asarray, rmodels.init_params(rcfg, jax.random.PRNGKey(8)))
    assert isinstance(params["blocks"], list)
    assert params["encoder"]["attn"]["wq"].shape[0] == rcfg.n_enc_layers
    assert params["xattn"]["lnx"].shape[0] == rcfg.n_layers
    cfg = configs.get_config("whisper-base").reduced(dtype="float32", scan_layers=False)
    model = from_reference(cfg, params, device="cpu")
    back = to_reference(model)
    assert isinstance(back["blocks"], list)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, params)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, back))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the same weights stacked run the reference's forward (its unstacked
    # forward takes no cross-attention)
    scfg = dataclasses.replace(rcfg, scan_layers=True)
    stacked = dict(params, blocks=jax.tree.map(lambda *a: np.stack(a), *params["blocks"]))
    batch = _batch(scfg, seed=3)
    want, _ = rmodels.forward(stacked, scfg, _j(batch))
    got, _ = forward(model, _tt(batch))
    assert _rel(got, np.asarray(want)) < FP32_REL
    for group, leaf in (("encoder", ("ln1",)), ("xattn", ("lnx",))):
        bad = jax.tree.map(lambda a: a, back)
        node = bad[group]
        node[leaf[0]] = np.concatenate([node[leaf[0]], node[leaf[0]][:1]])
        with pytest.raises(ValueError, match=group):
            from_reference(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", OTHER)
def test_init_cache_layout(arch):
    """Each block's state has the shape and dtype of the reference's leaf
    for that block."""
    cfg = configs.get_config(arch).reduced()
    cache = init_cache(cfg, 3, 20, device="cpu")
    want = rmodels.init_cache(rconfigs.get_config(arch).reduced(), 3, 20)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].tolist() == [0, 0, 0]
    assert len(cache["blocks"]) == cfg.n_layers // cfg.block_period
    for block in cache["blocks"]:
        assert set(block) == set(want["blocks"])
        for sub, state in block.items():
            assert set(state) == set(want["blocks"][sub]), sub
            for name, leaf in state.items():
                w = want["blocks"][sub][name]
                assert tuple(leaf.shape) == w.shape[1:], (sub, name)
                assert str(leaf.dtype).split(".")[-1] == str(w.dtype), (sub, name)
                assert not leaf.any()
    assert ("xattn" in cache) == bool(cfg.n_enc_layers)
    if cfg.n_enc_layers:
        assert len(cache["xattn"]) == want["xattn"]["k"].shape[0]
        for xc in cache["xattn"]:
            assert tuple(xc["k"].shape) == want["xattn"]["k"].shape[1:]


# ------------------------------------------------------------- the launcher

@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-base"])
def test_serve_cli_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                           "--device", "cpu", "--requests", "4"], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert out[0] == "batch of 4 served (4/4)"
    assert out[-1].startswith("4 requests x 16 tokens in ") and f"reduced {arch}" in out[-1]


def test_serve_loop_feeds_the_stubs():
    """The VLM's zero patches come before the prompt (the cache holds
    n_patches more positions); whisper's zero frames feed the encoder."""
    from repro_torch.launch.serve import serve_requests

    for arch in ("internvl2-2b", "whisper-base"):
        cfg = configs.get_config(arch).reduced(dtype="float32")
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        out = serve_requests(model, 2, 2, 6, 4, np.random.default_rng(0), log=lambda m: None)
        toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (2, 6)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks)}
        if cfg.n_patches:
            batch["vision"] = torch.zeros((2, cfg.n_patches, cfg.d_model))
        if cfg.n_enc_layers:
            batch["frames"] = torch.zeros((2, cfg.n_frames, cfg.d_model))
        lg, cache = prefill(model, batch, 10 + cfg.n_patches)
        assert torch.equal(out["tokens"][0][:, 0], lg.argmax(-1).to(torch.int32)), arch
        assert int(cache["pos"][0]) == 6 + cfg.n_patches
