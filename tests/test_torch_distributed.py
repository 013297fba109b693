"""The port's distribution over gloo groups of CPU processes: the sharded
train step against one process, a checkpoint written from one mesh and
restored onto another, the launcher over processes, and
``wildcard_match_sharded`` against the JAX package's ``wildcard_match``.

Each case runs ``_RANK`` in a group of processes of its own (each
destroys its group at the end), rank 0 saving what the test reads.
The step is the reference test's (``tests/test_multidevice.py::
test_gspmd_train_step_matches_single_device``: 2 layers, d 64, 4 / 2
heads, vocab 512, a (8, 32) batch) in fp32 on a (2, 2) ("data",
"model") mesh: the loss within ``LOSS_REL``; every parameter within
``PARAM_REL`` of its leaf's largest |value|, but where one process's
gradient is below 1e-4 of the largest (an AdamW first step is lr *
sign(g) there, and the shards' reordered sums may flip a tiny
gradient's sign): within 2 lr.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL = 1e-5
PARAM_REL = 1e-5
LR = 1e-3

_RANK = r"""
import json, os, sys, tempfile
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
rank, world, store, out, case = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                 sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
torch.manual_seed(0)
from repro_torch.distributed.act_shard import install_mesh
from repro_torch.distributed.sharding import (batch_pspecs, param_pspecs, shard_batch,
    shard_model, shard_opt_state, to_placements, zero1_opt_pspecs)

def flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, prefix + k + "/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out

def small():
    from repro_torch.models import ModelConfig, init_params
    cfg = ModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=512, remat=False, attn_chunk_k=16, dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

res = {}
if case.startswith("step"):
    mode = case.split("_")[1]
    from repro_torch.models import loss_fn
    from repro_torch.models.weights import stack, to_reference
    from repro_torch.optim.adamw import AdamWHyper, adamw_init
    from repro_torch.train.steps import make_train_step
    cfg, model = small()
    data = np.load(store + ".batch.npz")
    batch = {k: torch.from_numpy(data[k]) for k in data.files}
    # dp mode: two microbatches, each cut from the gathered batch and placed again
    step = make_train_step(cfg, AdamWHyper(lr=%LR%), microbatches=2 if mode == "dp" else 1)
    if rank == 0:  # the one-process step, on a copy, with its gradients
        _, one = small()
        params = dict(one.named_parameters())
        grads = torch.autograd.grad(loss_fn(one, batch)[0], list(params.values()))
        for k, v in flat(stack(one, {k: g.detach() for k, g in zip(params, grads)})).items():
            res["grad/" + k] = v
        one, _, m1 = step(one, adamw_init(one), batch)
        res["loss1"] = np.array(float(m1["loss"]))
        res["gnorm1"] = np.array(float(m1["grad_norm"]))
        for k, v in flat(to_reference(one)).items():
            res["one/" + k] = v
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    p_specs = param_pspecs(model, cfg, mesh, mode=mode)
    m_specs = zero1_opt_pspecs(model, mesh) if mode == "dp" else p_specs
    opt = adamw_init(model)
    shard_model(model, mesh, p_specs)
    opt = shard_opt_state(opt, mesh, m_specs)
    dp = tuple(mesh.mesh_dim_names) if mode == "dp" else None
    install_mesh(mesh, dp_axes=dp, tp=mode != "dp")
    sb = shard_batch(batch, mesh, batch_pspecs(batch, mesh, dp_axes=dp))
    model, opt, m2 = step(model, opt, sb)
    install_mesh(None)
    placed = {k: [str(p) for p in t.placements] for k, t in opt["mu"].items()}
    full = {k: p.detach().full_tensor() for k, p in model.named_parameters()}
    if rank == 0:
        res["loss2"] = np.array(float(m2["loss"]))
        res["gnorm2"] = np.array(float(m2["grad_norm"]))
        res["placed"] = np.array(json.dumps(placed))
        res["sharded_params"] = np.array(sum(any(not p.startswith("R") for p in
            [str(q) for q in t.placements]) for _, t in model.named_parameters()))
        for k, v in flat(stack(model, full)).items():
            res["two/" + k] = v
elif case == "ckpt":
    from torch.distributed.tensor import distribute_tensor, Shard
    from repro_torch.checkpoint.ckpt import Sharding, load_checkpoint, save_checkpoint
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import load_train_state, train_state
    d = store + ".ckpt"
    mesh_a = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    x = torch.arange(64.0).reshape(8, 8)
    xs = distribute_tensor(x, mesh_a, [Shard(0)])
    cfg, model = small()
    specs_a = param_pspecs(model, cfg, DeviceMesh("cpu", torch.arange(world).reshape(2, -1),
                                                  mesh_dim_names=("data", "model")))
    mesh_2d = DeviceMesh("cpu", torch.arange(world).reshape(2, -1),
                         mesh_dim_names=("data", "model"))
    opt = adamw_init(model)
    for t in list(opt["mu"].values()) + list(opt["nu"].values()):
        t.normal_()  # moments worth restoring
    want_tree = train_state(model, opt)
    shard_model(model, mesh_2d, specs_a)
    opt = shard_opt_state(opt, mesh_2d, specs_a)
    save_checkpoint(d, 1, {"x": xs, **train_state(model, opt)})
    dist.barrier()
    # restore onto a different mesh shape: (4,) -> (2, 2) with other placements
    mesh_b = DeviceMesh("cpu", torch.arange(world).reshape(2, 2), mesh_dim_names=("data", "model"))
    pl = to_placements(("model", "data"), mesh_b)
    tree, _, _ = load_checkpoint(d, device="cpu", shardings={"x": Sharding(mesh_b, pl)})
    ok_x = bool(torch.equal(tree["x"].full_tensor(), x)) and list(tree["x"].placements) == pl
    # the train state onto a (4, 1) mesh in dp mode, moments by ZeRO-1
    mesh_c = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                        mesh_dim_names=("data", "model"))
    _, again = small()
    with torch.no_grad():
        for p in again.parameters():
            p.zero_()
    shard_model(again, mesh_c, param_pspecs(again, cfg, mesh_c, mode="dp"))
    z1 = zero1_opt_pspecs(again, mesh_c)
    opt_c = load_train_state(again, tree, moment_specs=z1)
    back = train_state(again, opt_c)
    same = all(np.array_equal(a, b) for a, b in zip(
        [t for _, t in sorted(flat(want_tree).items())],
        [t for _, t in sorted(flat(back).items())]))
    zero1 = all([str(p) for p in opt_c["mu"][k].placements] ==
                [str(p) for p in to_placements(z1[k], mesh_c)] for k in z1)
    if rank == 0:
        res["ok_x"] = np.array(ok_x)
        res["same"] = np.array(same)
        res["zero1"] = np.array(zero1)
        res["n_leaves"] = np.array(len(flat(back)))
elif case == "match":
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.kernels import ops
    data = np.load(store + ".batch.npz")
    logs, lens, tmpl, tl = (data[k] for k in ("logs", "lens", "tmpl", "tl"))
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"))
    ops.reset_launch_counts()
    with CommDebugMode() as comm:
        got = ops.wildcard_match_sharded(logs, lens, tmpl, tl, mesh)
    n_comm = comm.get_total_counts()
    launches = ops.launch_counts()["wildcard_match"]
    local = got.to_local().numpy()
    part = logs.shape[0] // world
    own = ops.wildcard_match(logs[rank * part:(rank + 1) * part],
                             lens[rank * part:(rank + 1) * part], tmpl, tl, device="cpu")
    try:
        ops.wildcard_match_sharded(logs[:-1], lens[:-1], tmpl, tl, mesh)
        uneven = "no error"
    except ValueError as e:
        uneven = str(e)
    full = got.full_tensor().numpy()
    if rank == 0:
        res.update(full=full, n_comm=np.array(n_comm), launches=np.array(launches),
                   own=np.array(bool(np.array_equal(local, own))), uneven=np.array(uneven),
                   placements=np.array(str(got.placements)), shape=np.array(got.shape))
elif case.startswith("decode"):
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import cache_pspecs, shard_cache
    from repro_torch.models import decode_step, init_params, prefill
    data = np.load(store + ".batch.npz")
    toks, m_len, n_pre = torch.from_numpy(data["tokens"]), int(data["max_len"]), int(data["prompt"])
    cfg = get_config(case.split(":")[1]).reduced(dtype="float32")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items() for k, v in leaves(t, prefix + n + "/").items()}
        if isinstance(tree, list):
            return {k: v for i, t in enumerate(tree) for k, v in leaves(t, f"{prefix}{i}/").items()}
        return {prefix[:-1]: tree}

    if rank == 0:  # one process
        one = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        lg, cache = prefill(one, {"tokens": toks[:, :n_pre]}, m_len)
        res["one/0"] = lg.numpy()
        for t in range(n_pre, toks.shape[1]):
            lg, cache = decode_step(one, cache, toks[:, t:t + 1])
            res[f"one/{t - n_pre + 1}"] = lg.numpy()
        for k, v in leaves(cache).items():
            res["onecache/" + k] = v.numpy()

    class Views(TorchDispatchMode):
        # the DTensor-level views whose flatten folds a split dim into the
        # dim before it (DTensor 2.11 refuses them)
        def __init__(self):
            super().__init__()
            self.bad = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is DTensor for t in types):
                name = func._schema.name.split("::")[-1]
                if name in ("view", "_unsafe_view") and isinstance(args[0], DTensor):
                    x, size = args[0], list(args[1])
                    if -1 in size:
                        size[size.index(-1)] = x.numel() // -int(np.prod(size))
                    split = {q.dim for q in x.placements if q.is_shard()}
                    ins = [d for d in range(x.ndim) if x.shape[d] != 1]  # size 1: squeezes
                    outs = [n for n in size if n != 1]
                    i = j = 0
                    pi = pj = 1
                    group = []
                    while i < len(ins) or j < len(outs):  # the input dims each group folds
                        if pi <= pj and i < len(ins):
                            group.append(ins[i])
                            pi *= x.shape[ins[i]]
                            i += 1
                        elif j < len(outs):
                            pj *= outs[j]
                            j += 1
                        else:
                            break
                        if pi == pj:
                            if any(d in split for d in group[1:]):
                                self.bad.append(f"{name} {tuple(x.shape)} {x.placements} -> {size}")
                            group, pi, pj = [], 1, 1
                return NotImplemented
            return func(*args, **kwargs)

    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2), mesh_dim_names=("data", "model"))
    shard_model(model, mesh, param_pspecs(model, cfg, mesh))
    install_mesh(mesh)
    views = Views()
    with views:
        pre = {"tokens": toks[:, :n_pre]}
        lg, cache = prefill(model, shard_batch(pre, mesh, batch_pspecs(pre, mesh)), m_len)
        cache = shard_cache(cache, mesh, cache_pspecs(cache, cfg, mesh))
        placed = {k: list(v.placements) for k, v in leaves(cache).items()}
        specs = leaves(cache_pspecs(cache, cfg, mesh))
        kept = placed == {k: to_placements(sp, mesh) for k, sp in specs.items()}
        got = [lg.full_tensor()]
        for t in range(n_pre, toks.shape[1]):
            tok = {"t": toks[:, t:t + 1]}
            tok = shard_batch(tok, mesh, batch_pspecs(tok, mesh))["t"]
            lg, cache = decode_step(model, cache, tok)
            kept = kept and {k: list(v.placements) for k, v in leaves(cache).items()} == placed
            got.append(lg.full_tensor())
    install_mesh(None)
    full = {k: v.full_tensor() for k, v in leaves(cache).items()}
    if rank == 0:
        for i, g in enumerate(got):
            res[f"two/{i}"] = g.numpy()
        for k, v in full.items():
            res["twocache/" + k] = v.numpy()
        res["kept"] = np.array(kept)
        res["split"] = np.array(json.dumps({k: [f"S({q.dim})" if q.is_shard() else "R" for q in v]
                                            for k, v in placed.items()}))
        res["bad_views"] = np.array(json.dumps(views.bad))
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
""".replace("%LR%", repr(LR))


def _ranks(world: int, case: str, batch: dict | None = None) -> dict:
    """Run ``_RANK`` in ``world`` processes of one gloo group -> rank 0's
    saved arrays."""
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        if batch is not None:
            np.savez(store + ".batch.npz", **batch)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        out = os.path.join(d, "r0.npz")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(world), store, out,
                                   case], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=400) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        return dict(np.load(out))


@pytest.mark.parametrize("mode", ["2d", "dp"])
def test_sharded_step_equals_one_process(mode):
    """The reference test's step on a (2, 2) gloo mesh, parameters placed
    by ``param_pspecs`` ("2d": TP + FSDP, moments alike; "dp": replicated,
    moments by ZeRO-1, the batch over every axis, two microbatches)
    against the one-process step (two microbatches in dp mode too)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (8, 32)).astype(np.int32)
    got = _ranks(4, f"step_{mode}", {"tokens": toks, "labels": np.roll(toks, -1, 1)})
    l1, l2 = float(got["loss1"]), float(got["loss2"])
    assert abs(l1 - l2) <= LOSS_REL * abs(l1), (l1, l2)
    assert abs(float(got["gnorm1"]) - float(got["gnorm2"])) <= LOSS_REL * float(got["gnorm1"])
    grads = {k[5:]: v for k, v in got.items() if k.startswith("grad/")}
    top_g = max(float(np.abs(g).max()) for g in grads.values())
    ones = {k[4:]: v for k, v in got.items() if k.startswith("one/")}
    assert ones and set(ones) == {k[4:] for k in got if k.startswith("two/")}
    for k, a in ones.items():
        b = got["two/" + k]
        scale = float(np.abs(a).max())
        small = np.abs(grads[k]) < 1e-4 * top_g
        diff = np.abs(a - b)
        assert float(diff[~small].max(initial=0.0)) <= PARAM_REL * scale, k
        assert float(diff[small].max(initial=0.0)) <= 2 * LR + PARAM_REL * scale, k
    placed = json.loads(str(got["placed"]))
    if mode == "2d":
        assert int(got["sharded_params"]) > 0
        assert any("S(" in "".join(p) for p in placed.values())
    else:
        assert int(got["sharded_params"]) == 0  # params replicated
        assert sum("S(" in "".join(p) for p in placed.values()) >= len(placed) - 1  # ZeRO-1


DECODE_REL = 1e-5  # fp32: the shards' sums run in another order


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b", "rwkv6-7b"])
def test_sharded_decode_equals_one_process(arch):
    """The reduced config in fp32 on the (2, 2) mesh in 2d (parameters by
    ``param_pspecs``, the prefill's cache placed by ``cache_pspecs``: K/V
    split over "model" along the sequence) against one process: a prompt
    of 6 into a cache of 16, then 12 decode steps, whose writes cross from
    the first sequence shard (slots 0-7) into the second and end clamped
    at slot 15. Every step's logits within ``DECODE_REL`` of the largest
    |logit|, the gathered cache within it of each leaf's largest |value|,
    every cache leaf placed as it came in after every step, and no view
    on a DTensor folds a split dim into the dim before it (the pattern
    DTensor 2.11 refuses: ROADMAP C.7)."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (4, 18)).astype(np.int32)
    got = _ranks(4, f"decode:{arch}", {"tokens": toks, "max_len": np.array(16),
                                      "prompt": np.array(6)})
    assert bool(got["kept"])
    split = json.loads(str(got["split"]))
    if arch != "rwkv6-7b":  # the K/V cache's sequence over "model"
        assert any(v == ["S(0)", "S(1)"] and k.endswith("/k")
                   for k, v in split.items()), split
    assert json.loads(str(got["bad_views"])) == []
    for i in range(13):
        a, b = got[f"one/{i}"], got[f"two/{i}"]
        assert float(np.abs(a - b).max()) <= DECODE_REL * float(np.abs(a).max()), i
    names = [k[9:] for k in got if k.startswith("onecache/")]
    assert names and {k[9:] for k in got if k.startswith("twocache/")} == set(names)
    for k in names:
        a, b = got["onecache/" + k], got["twocache/" + k]
        assert a.shape == b.shape, k
        assert float(np.abs(a - b).max()) <= DECODE_REL * max(float(np.abs(a).max()), 1e-30), k


def test_checkpoint_restores_onto_another_mesh():
    """A DTensor sharded over a (4,) mesh is saved whole and restored onto
    a (2, 2) mesh with other placements; a 2d-sharded train state is
    restored onto a (4, 1) mesh in dp mode, its moments by ZeRO-1, equal
    leaf for leaf."""
    got = _ranks(4, "ckpt")
    assert bool(got["ok_x"])
    assert bool(got["same"]) and int(got["n_leaves"]) > 10
    assert bool(got["zero1"])


def test_wildcard_match_sharded_equals_the_references():
    """The reference test's inputs over 4 ranks: the match equals the JAX
    package's ``wildcard_match``, each rank's rows are its own block's
    match and the match issues no collective; rows that do not split
    evenly raise. On the CPU each rank runs the plain version, which
    launches no kernel (the card's launches: ``chip_smoke.py`` phase 14)."""
    from repro.kernels import ops as rops

    rng = np.random.default_rng(0)
    logs = rng.integers(2, 20, (64, 8)).astype(np.int32)
    lens = np.full((64,), 8, np.int32)
    lens[::7] = 5
    tmpl = np.array([[5, 1, 7, 0], [3, 1, 0, 0], [1, 0, 0, 0]], np.int32)
    tl = np.array([3, 2, 1], np.int32)
    want = np.asarray(rops.wildcard_match(logs, lens, tmpl, tl))
    got = _ranks(4, "match", {"logs": logs, "lens": lens, "tmpl": tmpl, "tl": tl})
    np.testing.assert_array_equal(got["full"], want)
    assert want.any() and not want.all()
    assert int(got["n_comm"]) == 0
    assert int(got["launches"]) == 0  # the plain version on the CPU launches no kernel
    assert bool(got["own"])
    assert "do not split evenly" in str(got["uneven"])
    assert "Shard(dim=0)" in str(got["placements"]) and tuple(got["shape"]) == (64, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_LAUNCH = r"""
import json, sys
from repro_torch.launch.train import main
run = main(sys.argv[2:])
import os
if int(os.environ.get("RANK", "0")) == 0:
    json.dump(run["losses"], open(sys.argv[1], "w"))
"""


def test_launcher_over_processes_gives_the_one_process_losses(tmp_path):
    """``launch/train.py --device cpu --reduced --model-parallel 2`` over 4
    gloo processes (a (2, 2) mesh: data and tensor parallel) gives the
    losses of one process, within 1e-3 relative (the reduced config
    computes in bf16, whose epsilon is 7.8e-3; the shards' sums run in
    another order)."""
    args = ["--reduced", "--steps", "3", "--seq", "64", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    one = tmp_path / "one"
    p = subprocess.run([sys.executable, "-c", _LAUNCH, str(tmp_path / "one.json"), *args,
                        "--workdir", str(one)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "mesh:" not in p.stdout
    many = tmp_path / "many"
    many.mkdir()
    subprocess.run(["cp", "-r", str(one / "shards"), str(many / "shards")], check=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LAUNCH, str(tmp_path / "many.json"), *args, "--workdir",
         str(many), "--model-parallel", "2"],
        env=dict(env, RANK=str(r), WORLD_SIZE="4", MASTER_ADDR="localhost",
                 MASTER_PORT=str(port)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        outs = [q.communicate(timeout=400) for q in procs]
    finally:
        for q in procs:
            q.kill()
    for q, (_, err) in zip(procs, outs):
        assert q.returncode == 0, err[-3000:]
    assert "mesh: {'data': 2, 'model': 2}" in outs[0][0]
    a = json.loads((tmp_path / "one.json").read_text())
    b = json.loads((tmp_path / "many.json").read_text())
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(b, a, rtol=1e-3)
    assert (many / "ckpt" / "step-00000003").is_dir()  # rank 0 wrote the final checkpoint
