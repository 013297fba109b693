"""The port's optimizer stack against the JAX package's: AdamW (one update
element by element, the weight-decay rule on stacked leaves included),
global-norm clipping, the cosine schedule, int8 quantization bit for bit;
the int8 error-feedback all-reduce and the explicit train step over
``torch.distributed`` gloo groups of CPU processes.

Tolerances: fp32 results within ``F32_REL`` of the leaf's largest |value|
(XLA and torch may round a ``pow`` or ``sqrt`` one ulp apart); bf16
parameters within one bf16 ulp of the leaf's largest |value| (an ulp of
difference in fp32 can round the one cast the other way). int8
quantization and the all-reduce against its numpy emulation: exact.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro_torch import configs
from repro_torch.models import init_params, loss_fn
from repro_torch.models.weights import from_reference, reference_ndims, stack, to_reference
from repro_torch.models.weights import unstack
from repro_torch.optim import compress
from repro_torch.optim.adamw import (
    AdamWHyper,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)

ROOT = Path(__file__).resolve().parents[1]
F32_REL = 1e-6
BF16_ULP = 2.0 ** -7  # bf16 has 8 significant bits: an ulp is 2^-7 of the leading power of 2


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _tensors(model, tree, dtypes=None) -> dict:
    """A reference tree of numpy arrays -> {parameter name: tensor}, in the
    parameter's dtype (``dtypes``) or fp32."""
    params = dict(model.named_parameters())
    out = {}
    for k, a in unstack(model, tree).items():
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        out[k] = t.to(params[k].dtype) if dtypes == "params" else t
    return out


def _close(got: dict, want: dict, bf16: set = frozenset(), rel: float = F32_REL):
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max(initial=0))
        tol = (BF16_ULP if path in bf16 else rel) * float(np.abs(w).max(initial=0))
        assert err <= tol, (path, err, tol)


def _state(rcfg, seed):
    """Reference params, random grads in the params' dtypes, and an AdamW
    state at step 3 with random moments."""
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def like(a, scale=1.0, positive=False, dtype=None):
        x = rng.normal(size=a.shape).astype(np.float32) * scale
        x = np.abs(x) if positive else x
        return x.astype(dtype or a.dtype)

    grads = jax.tree.map(lambda a: like(np.asarray(a)), params)
    opt = {"mu": jax.tree.map(lambda a: like(np.asarray(a), 0.1, dtype=np.float32), params),
           "nu": jax.tree.map(lambda a: like(np.asarray(a), 0.01, True, np.float32), params),
           "step": np.int32(3)}
    return params, grads, opt


def _bf16_leaves(tree) -> set:
    out = set()

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, list):
            for j, v in enumerate(node):
                walk(v, f"{prefix}{j}/")
        elif np.asarray(node).dtype == ml_dtypes.bfloat16:
            out.add(prefix[:-1])

    walk(tree, "")
    return out


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_update_matches_reference(dtype, scan_layers):
    """One update on the same grads and moments, element by element. With
    ``scan_layers`` the reference stacks the blocks, so a block's norm
    scale is (L, d) there and decayed; unstacked it is (d,) and not."""
    rcfg = rconfigs.get_config("qwen1.5-0.5b").reduced(dtype=dtype, scan_layers=scan_layers)
    cfg = configs.get_config("qwen1.5-0.5b").reduced(dtype=dtype, scan_layers=scan_layers)
    params, grads, opt = _state(rcfg, 5)
    hyper = dict(lr=1e-2, weight_decay=0.5)
    wp, wo = radamw.adamw_update(jax.tree.map(jnp.asarray, grads),
                                 jax.tree.map(jnp.asarray, opt), params,
                                 radamw.AdamWHyper(**hyper))
    host = jax.tree.map(np.asarray, params)
    model = from_reference(cfg, host, device="cpu")
    assert reference_ndims(model)["blocks.0.sub0.ln1"] == (2 if scan_layers else 1)
    g = _tensors(model, grads, "params")
    state = {"mu": _tensors(model, opt["mu"]), "nu": _tensors(model, opt["nu"]),
             "step": torch.tensor(3, dtype=torch.int32)}
    ids = {k: id(p) for k, p in model.named_parameters()}
    new = adamw_update(g, state, model, AdamWHyper(**hyper))
    assert {k: id(p) for k, p in model.named_parameters()} == ids  # updated in place
    assert int(new["step"]) == int(wo["step"]) == 4
    _close(_flat(to_reference(model)), _flat(jax.tree.map(np.asarray, wp)), _bf16_leaves(host))
    for name in ("mu", "nu"):
        _close(_flat(stack(model, new[name])), _flat(jax.tree.map(np.asarray, wo[name])))
    # the norm's update is decayed exactly when the reference's leaf is 2-D
    undecayed = from_reference(cfg, host, device="cpu")
    adamw_update(g, state, undecayed, AdamWHyper(**dict(hyper, weight_decay=0.0)))
    ln1, ln1_plain = model.blocks[0]["sub0"].ln1, undecayed.blocks[0]["sub0"].ln1
    assert (not torch.equal(ln1, ln1_plain)) == scan_layers
    assert torch.equal(model.ln_f, undecayed.ln_f)  # 1-D in both layouts: never decayed
    assert not torch.equal(model.embed, undecayed.embed)


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    """The norm over every leaf in fp32; the scaled grads rounded back to
    their dtype (bf16 stays bf16), fp32 ones within the norm's tolerance
    (they carry its rounding); max_norm 1e6 leaves them as they are."""
    rcfg = rconfigs.get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    cfg = configs.get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    params, grads, _ = _state(rcfg, 6)
    want, wgn = radamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
    model = from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    g = _tensors(model, grads, "params")
    got, gn = clip_by_global_norm(g, max_norm)
    # the sum of ~6e5 squares, in another order: ~2e-6 apart here
    norm_rel = 1e-5
    assert gn.dtype == torch.float32 and abs(float(gn) - float(wgn)) <= norm_rel * float(wgn)
    assert all(got[k].dtype == g[k].dtype for k in g)
    _close(_flat(stack(model, got)), _flat(jax.tree.map(np.asarray, want)),
           _bf16_leaves(jax.tree.map(np.asarray, params)), norm_rel)
    if max_norm > float(wgn):
        assert all(torch.equal(got[k], g[k]) for k in g)


def test_cosine_schedule_matches_reference():
    want_fn, got_fn = radamw.cosine_schedule(6e-4, 20, 100), cosine_schedule(6e-4, 20, 100)
    steps = np.arange(0, 106)
    want = np.array([float(want_fn(s)) for s in steps])
    got = np.array([float(got_fn(torch.tensor(s, dtype=torch.int32))) for s in steps])
    assert np.abs(got - want).max() <= F32_REL * 6e-4
    assert got[0] == 0.0 and got[20] == pytest.approx(6e-4) and got[100:].max() < 1e-12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 48)).astype(np.float32) * 3
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties: both round half to even
    err = rng.normal(size=(64, 48)).astype(np.float32) * 0.01
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    wq, ws, we = rcompress.quantize_int8(jx, jnp.asarray(err))
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    q, scale, e = compress.quantize_int8(tx, torch.from_numpy(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert np.float32(scale) == np.asarray(ws)
    np.testing.assert_array_equal(e.numpy(), np.asarray(we))


# ---------------------------------------------- gloo groups of processes

_RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, store, out, case = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
torch.manual_seed(0)
if case == "allreduce":
    from repro_torch.optim.compress import allreduce_int8, init_error_state
    rng = np.random.default_rng(100 + rank)
    grads = {"w": torch.from_numpy(rng.normal(size=(16, 33)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32) * 1e-3)}
    err = init_error_state(grads)
    res = {}
    for it in range(3):
        red, err = allreduce_int8(grads, err, None)
        for k in grads:
            res[f"out{it}_{k}"], res[f"err{it}_{k}"] = red[k].numpy(), err[k].numpy()
    np.savez(out, **res)
else:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.weights import to_reference
    from repro_torch.optim.adamw import AdamWHyper, adamw_init
    from repro_torch.optim.compress import init_error_state
    from repro_torch.train.steps import make_train_step_explicit
    cfg = get_config("qwen1.5-0.5b").reduced(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    data = np.load(store + ".batch.npz")
    b = data["tokens"].shape[0] // world
    batch = {k: torch.from_numpy(data[k][rank * b:(rank + 1) * b]) for k in data.files}
    step = make_train_step_explicit(cfg, {case: dist.group.WORLD}, AdamWHyper(lr=1e-3))
    opt = adamw_init(model)
    err = init_error_state(dict(model.named_parameters()))
    metrics = []
    for _ in range(2):
        model, opt, err, m = step(model, opt, err, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    flat = {}
    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + k + "/")
        else:
            flat[prefix[:-1]] = node
    walk(to_reference(model), "")
    flat["metrics"] = np.array(metrics)
    flat["err_max"] = np.array(max(float(e.abs().max()) for e in err.values()))
    np.savez(out, **flat)
dist.destroy_process_group()
"""


def _ranks(world: int, case: str, batch: dict | None = None) -> list:
    """Run ``_RANK`` in ``world`` processes of one gloo group -> each
    rank's saved arrays."""
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        if batch is not None:
            np.savez(store + ".batch.npz", **batch)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(world), store,
                                   os.path.join(d, f"r{r}.npz"), case],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=240) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        return [dict(np.load(os.path.join(d, f"r{r}.npz"))) for r in range(world)]


def _emulate(grads_by_rank: list, err_by_rank: list):
    """allreduce_int8's formula in numpy float32 arithmetic."""
    n = len(grads_by_rank)
    x32 = [g / np.float32(n) + e for g, e in zip(grads_by_rank, err_by_rank)]
    amax = max(np.maximum(np.abs(x).max(), np.float32(1e-12)) for x in x32)
    scale = np.float32(amax) / np.float32(127.0)
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in x32]
    total = np.sum([qq.astype(np.int32) for qq in q], axis=0, dtype=np.int32)
    return total.astype(np.float32) * scale, [x - qq.astype(np.float32) * scale
                                              for x, qq in zip(x32, q)]


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce_int8_over_a_gloo_group(world):
    """Three rounds of error feedback over 2 and 4 ranks: each round's mean
    and residuals equal the numpy emulation of the contract bit for bit
    (x32 = g/n + e, one max scale, int8 summed in int32, residual
    x32 - q scale); the mean is within the int8 grid of the true mean."""
    got = _ranks(world, "allreduce")
    grads = []
    for r in range(world):
        rng = np.random.default_rng(100 + r)
        grads.append({"w": rng.normal(size=(16, 33)).astype(np.float32),
                      "b": rng.normal(size=(7,)).astype(np.float32) * np.float32(1e-3)})
    for k in ("w", "b"):
        err = [np.zeros_like(g[k]) for g in grads]
        for it in range(3):
            out, err = _emulate([g[k] for g in grads], err)
            for r in range(world):
                np.testing.assert_array_equal(got[r][f"out{it}_{k}"], out)
                np.testing.assert_array_equal(got[r][f"err{it}_{k}"], err[r])
        mean = np.mean([g[k] for g in grads], axis=0)
        first = got[0][f"out0_{k}"]
        assert np.abs(first - mean).max() <= np.abs(mean).max() / 127 * world
        assert np.abs(got[0][f"err0_{k}"]).max() > 0


def _full_step(batch, steps=2):
    """The single-process reference: ``make_train_step`` on the whole batch
    -> (reference tree of the parameters, [[loss, grad norm]], the smaller
    |gradient| of each parameter over the steps)."""
    from repro_torch.train.steps import make_train_step

    cfg = configs.get_config("qwen1.5-0.5b").reduced(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, AdamWHyper(lr=1e-3))
    opt = adamw_init(model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics, gmin = [], None
    for _ in range(steps):
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss_fn(model, tb)[0], list(params.values()))
        g = {k: v.abs() for k, v in zip(params, grads)}
        gmin = g if gmin is None else {k: torch.minimum(gmin[k], g[k]) for k in g}
        model, opt, m = step(model, opt, tb)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return _flat(to_reference(model)), np.array(metrics), _flat(stack(model, gmin))


def _dp_batch():
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 512, (4, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@pytest.mark.parametrize("axis", ["data", "pod"])
def test_explicit_step_over_two_processes(axis):
    """``make_train_step_explicit`` on 2 ranks, each with half the batch
    (every label valid, so the mean of the halves' losses is the whole
    batch's): the ranks end on identical parameters. Over "data" (fp32
    mean) the loss and grad norm equal the one-process step on the whole
    batch within 1e-5, the parameters within 1e-6 + 2 lr a step where a
    gradient is below 1e-4 of the largest (AdamW's sign(g) * lr); over
    "pod" (int8 error feedback) the first loss equals it within 1e-5 (the
    second follows int8 gradients: 1e-2), the grad norms are within the
    int8 grid (1e-2) and the residuals are non-zero."""
    batch = _dp_batch()
    ranks = _ranks(2, axis, batch)
    want, wm, gmin = _full_step(batch)
    for k in ranks[0]:
        if k != "err_max":  # each rank keeps its own residual
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    got = ranks[0]
    np.testing.assert_allclose(got["metrics"][0, 0], wm[0, 0], rtol=1e-5)
    if axis == "pod":
        np.testing.assert_allclose(got["metrics"], wm, rtol=1e-2)
        assert float(got["err_max"]) > 0
        return
    np.testing.assert_allclose(got["metrics"], wm, rtol=1e-5)
    top = max(float(g.max()) for g in gmin.values())
    for path, w in want.items():
        diff = np.abs(got[path] - w)
        small = gmin[path] < 1e-4 * top
        assert diff[~small].max(initial=0) <= 1e-6 + 1e-6 * np.abs(w).max(), path
        assert diff[small].max(initial=0) <= 1e-6 + 2 * 2 * 1e-3, path
