"""The port's checkpoints and training launcher: the reference's four
checkpoint tests (``tests/test_checkpoint.py``) run on the port, each
package reading what the other writes (bf16 and int32 leaves, and a
whole train state in the launcher's tree), the async snapshot taken
before ``save_async`` returns, and the launcher's preemption: SIGTERM,
then a resume, equal to an uninterrupted run on the CPU.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.checkpoint import ckpt as rckpt
from repro.optim.adamw import adamw_init as radamw_init
from repro_torch import configs
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.models import ModelConfig, init_params
from repro_torch.models.weights import to_reference
from repro_torch.optim.adamw import AdamWHyper, adamw_init
from repro_torch.train.steps import load_train_state, make_train_step, train_state

ROOT = Path(__file__).resolve().parents[1]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
                   "blocks": [{"a": torch.arange(4)}, {"a": torch.arange(4) + 1}]},
        "opt": {"mu": torch.zeros((8, 16)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------- the reference's tests, on the port

def test_save_load_roundtrip(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    save_checkpoint(d, 10, tree, extra={"data_state": {"shard": 3}})
    loaded, extra, step = load_checkpoint(d, device="cpu")
    assert step == 10 and extra["data_state"]["shard"] == 3
    want, got = _leaves(tree), _leaves(loaded)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_atomicity_no_partial(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step-00000002.tmp"))  # an interrupted write
    assert latest_step(d) == 1
    loaded, _, step = load_checkpoint(d, device="cpu")
    assert step == 1 and loaded is not None


def test_manager_async_and_gc(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    steps = sorted(int(x.split("-")[1]) for x in os.listdir(d) if x.startswith("step-"))
    assert steps == [3, 4]
    assert mgr.last_saved == 4


def test_restore_resumes_training_state(tmp_path):
    """Train 3 steps, checkpoint, 'crash', restore, continue: equal to an
    uninterrupted 6-step run (the CPU's arithmetic is repeatable: exact)."""
    cfg = ModelConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                      vocab_size=32, remat=False, attn_chunk_k=8)
    step_fn = make_train_step(cfg, AdamWHyper(lr=1e-3))
    toks = torch.tile(torch.arange(16)[None, :], (2, 1)) % 32
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def fresh():
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        return model, adamw_init(model)

    full, opt = fresh()
    for _ in range(6):
        full, opt, m = step_fn(full, opt, batch)
    want = float(m["loss"])
    model, opt = fresh()
    for _ in range(3):
        model, opt, _ = step_fn(model, opt, batch)
    save_checkpoint(str(tmp_path), 3, train_state(model, opt))
    tree, _, s = load_checkpoint(str(tmp_path), device="cpu")
    model2 = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    opt2 = load_train_state(model2, tree)
    assert s == 3 and int(opt2["step"]) == 3
    for _ in range(3):
        model2, opt2, m2 = step_fn(model2, opt2, batch)
    assert float(m2["loss"]) == want
    for (_, p), (_, q) in zip(full.named_parameters(), model2.named_parameters()):
        assert torch.equal(p, q)


# ------------------------------------------- each package reads the other's

def test_cross_read_bf16_and_int32_leaves(tmp_path):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    ref_tree = {"w": jnp.asarray(w, jnp.bfloat16), "n": jnp.arange(6, dtype=jnp.int32),
                "s": jnp.int32(9), "f": jnp.asarray(w)}
    rckpt.save_checkpoint(str(tmp_path / "ref"), 1, ref_tree, extra={"k": [1, 2]})
    got, extra, step = load_checkpoint(str(tmp_path / "ref"), device="cpu")
    assert step == 1 and extra == {"k": [1, 2]}
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (4, 5)
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(ref_tree["w"]).astype(np.float32))
    assert got["n"].dtype == torch.int32 and got["n"].tolist() == list(range(6))
    assert got["s"].dtype == torch.int32 and got["s"].shape == () and int(got["s"]) == 9
    assert torch.equal(got["f"], torch.from_numpy(w))

    port_tree = {"w": torch.from_numpy(w).to(torch.bfloat16), "n": torch.arange(6,
                 dtype=torch.int32), "s": torch.tensor(9, dtype=torch.int32),
                 "f": torch.from_numpy(w)}
    save_checkpoint(str(tmp_path / "port"), 1, port_tree, extra={"k": [1, 2]})
    back, extra, _ = rckpt.load_checkpoint(str(tmp_path / "port"))
    assert back["w"].dtype == ml_dtypes.bfloat16 and extra == {"k": [1, 2]}
    np.testing.assert_array_equal(back["w"], np.asarray(ref_tree["w"]))
    assert back["n"].dtype == np.int32 and back["s"].dtype == np.int32
    np.testing.assert_array_equal(back["f"], w)
    manifests = {}
    for d in ("ref", "port"):  # the same manifests, leaf for leaf
        with open(tmp_path / d / "step-00000001" / "manifest.json") as f:
            manifests[d] = json.load(f)["leaves"]
    assert manifests["ref"] == manifests["port"]


@pytest.mark.parametrize("scan_layers", [True, False])
def test_train_state_cross_read(tmp_path, scan_layers):
    """The launcher's tree, {"params", "opt": {"mu", "nu", "step"}}: a
    reference bf16 train state loads into a port model and AdamW state,
    and the port's written state loads in the reference with the same leaf
    paths, shapes, dtypes and bytes (stacked blocks, or a list of them)."""
    arch = "qwen1.5-0.5b"
    rcfg = rconfigs.get_config(arch).reduced(scan_layers=scan_layers)
    cfg = configs.get_config(arch).reduced(scan_layers=scan_layers)
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(4))
    ropt = radamw_init(params)
    ropt["mu"] = jax.tree.map(lambda a: a + 0.25, ropt["mu"])
    ropt["step"] = jnp.int32(11)
    rckpt.save_checkpoint(str(tmp_path / "ref"), 11, {"params": params, "opt": ropt},
                          extra={"data": {"shard_pos": 2}})
    tree, extra, step = load_checkpoint(str(tmp_path / "ref"), device="cpu")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = load_train_state(model, tree)
    assert step == 11 and extra == {"data": {"shard_pos": 2}} and int(opt["step"]) == 11
    assert model.embed.dtype == torch.bfloat16
    want = _leaves(jax.tree.map(np.asarray, params))
    got = _leaves(to_reference(model))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32))
    assert all(bool((m == 0.25).all()) and m.dtype == torch.float32 for m in opt["mu"].values())

    save_checkpoint(str(tmp_path / "port"), 11, train_state(model, opt),
                    extra={"data": {"shard_pos": 2}})
    back, extra, step = rckpt.load_checkpoint(str(tmp_path / "port"))
    assert step == 11 and extra == {"data": {"shard_pos": 2}}
    manifests = {}
    for d in ("ref", "port"):
        with open(tmp_path / d / "step-00000011" / "manifest.json") as f:
            manifests[d] = json.load(f)["leaves"]
    assert manifests["port"] == manifests["ref"]
    assert manifests["port"]["opt/step"] == {**manifests["port"]["opt/step"], "shape": [],
                                             "dtype": "int32"}
    wantb = _leaves({"params": jax.tree.map(np.asarray, params),
                     "opt": jax.tree.map(np.asarray, ropt)})
    gotb = _leaves(back)
    for k in wantb:
        assert gotb[k].dtype == wantb[k].dtype, k
        assert gotb[k].tobytes() == wantb[k].tobytes(), k


def test_async_snapshot_is_taken_before_save_async_returns(tmp_path):
    """The port updates parameters in place: what ``save_async`` writes is
    the tree as it was at the call, whatever happens to it afterwards."""
    t = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"t": t, "b": b})
    t.add_(1.0)
    b.mul_(3.0)
    mgr.wait()
    got, _, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(got["t"], torch.arange(1 << 16, dtype=torch.float32))
    assert got["b"].dtype == torch.bfloat16 and bool((got["b"] == 1).all())


def test_load_checkpoint_without_one(tmp_path):
    assert load_checkpoint(str(tmp_path / "none"), device="cpu") == (None, None, None)


# ---------------------------------------------------------------- launcher

STEPS = 24
THREADS = 2  # one thread count for every run, so that the CPU runs repeat bit for bit


def _argv(workdir):
    return ["--reduced", "--device", "cpu", "--steps", str(STEPS), "--batch", "4",
            "--seq", "64", "--workdir", str(workdir), "--ckpt-every", "1000"]


def _shards(workdir: Path):
    """A small shard set, so that the launcher skips its 40,000-line write."""
    from repro_torch.core.codec import LogzipConfig
    from repro_torch.data.loggen import DATASETS, generate_lines
    from repro_torch.data.pipeline import write_logzip_shards

    write_logzip_shards(generate_lines("Spark", 1200, seed=0), str(workdir / "shards"), 400,
                        cfg=LogzipConfig(level=3, format=DATASETS["Spark"]["format"],
                                         device="cpu"))


def _launch(workdir):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=str(THREADS))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *_argv(workdir)],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_launcher_preempted_and_resumed_equals_uninterrupted(tmp_path):
    """Run A: ``main(argv)`` in this process, uninterrupted. Run B: a process
    sent SIGTERM after its first step line, which writes its preemption
    checkpoint at step k + 1 < STEPS and exits 0; relaunched, it resumes
    there and runs to STEPS. The final checkpoints are equal leaf for leaf
    (parameters, moments, step) and in the data cursor."""
    from repro_torch.launch.train import main

    for run in ("a", "b"):
        _shards(tmp_path / run)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        ran = main(_argv(tmp_path / "a"))
    finally:
        torch.set_num_threads(threads)
    assert ran["start"] == 0 and len(ran["losses"]) == STEPS and ran["ckpt_seconds"] > 0

    proc = _launch(tmp_path / "b")
    try:
        first = proc.stdout.readline()
        assert first.startswith("step     0"), first + proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    done = [ln for ln in out.splitlines() if ln.startswith("preemption checkpoint at step ")]
    assert len(done) == 1, out
    k1 = int(done[0].split()[4])
    assert 0 < k1 < STEPS, out
    assert latest_step(str(tmp_path / "b" / "ckpt")) == k1

    proc = _launch(tmp_path / "b")
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    assert f"resumed from step {k1} (sample-exact)" in out and "done: " in out

    a, ea, sa = load_checkpoint(str(tmp_path / "a" / "ckpt"), device="cpu")
    b, eb, sb = load_checkpoint(str(tmp_path / "b" / "ckpt"), device="cpu")
    assert sa == sb == STEPS and ea == eb and ea["data"]["line_pos"] + ea["data"]["shard_pos"] > 0
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys() and int(la["opt/step"]) == STEPS
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
    kept = sorted(os.listdir(tmp_path / "b" / "ckpt"))
    assert kept == [f"step-{k1:08d}", f"step-{STEPS:08d}"]


def test_launcher_refuses_model_parallel(tmp_path):
    """Since the sharding port the launcher lays ``--model-parallel`` out
    over its process group (``tests/test_torch_distributed.py`` trains
    that way); it refuses a width that does not divide the group's ranks,
    on every rank, before it writes anything."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--workdir",
         str(tmp_path), "--device", "cpu", "--model-parallel", "3"],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode != 0
        assert "2 ranks do not split into model-parallel groups of 3" in err, err[-2000:]
    assert not os.path.exists(tmp_path / "shards")
