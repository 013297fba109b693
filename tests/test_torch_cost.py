"""The port's cost model of a traced step (``launch.hlo_cost``): the cases
of ``tests/test_hlo_cost.py`` translated to the eager op stream, the ring
math on a fake process group, and the FLOPs of a reduced dense train
step against the JAX package's ``analyze`` of the same step's HLO."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze as ranalyze
from repro_torch.launch.hlo_cost import CostModel, analyze, roofline_terms

ROOT = Path(__file__).resolve().parents[1]


def test_flops_single_matmul():
    a, b = torch.randn(128, 64), torch.randn(64, 32)
    r = analyze(lambda x, y: x @ y, a, b)
    assert r["flops"] == 2 * 128 * 64 * 32
    assert r["dot_count"] == 1
    # operands and result, in fp32
    assert r["hbm_bytes"] == 4 * (128 * 64 + 64 * 32 + 128 * 32)


def test_flops_loop_counts_every_step():
    """A loop is unrolled in the op stream: 7 steps, 7 products (the
    reference multiplies a scan body by its trip count)."""
    def looped(x):
        for _ in range(7):
            x = x @ x
        return x

    r = analyze(looped, torch.randn(64, 64))
    assert r["flops"] == 7 * 2 * 64 ** 3


def test_flops_grad_of_loop():
    """The backward's products arrive from the autograd engine: two for
    each forward product."""
    x = torch.randn(32, 32, requires_grad=True)

    def grad_of_loop(x):
        y = x
        for _ in range(5):
            y = y @ y
        return torch.autograd.grad((y ** 2).sum(), x)

    r = analyze(grad_of_loop, x)
    assert r["flops"] == pytest.approx(3 * 5 * 2 * 32 ** 3, rel=0.05)


def test_flops_on_meta_tensors():
    """Shapes alone: meta tensors cost what real ones do."""
    a = torch.empty(256, 512, device="meta")
    b = torch.empty(8, 512, 128, device="meta")
    r = analyze(lambda x, y: torch.bmm(x.expand(8, 256, 512), y), a, b)
    assert r["flops"] == 2 * 8 * 256 * 128 * 512


def test_row_reads_billed_rows_not_the_table():
    """Reading one block of rows per step bills the rows, not the table."""
    table = torch.randn(512, 128)

    def rows(t):
        acc = torch.zeros(())
        for i in range(64):
            acc = acc + t[i * 8:(i + 1) * 8].sum()
        return acc

    r = analyze(rows, table)
    table_bytes = 512 * 128 * 4
    assert r["hbm_bytes"] < 10 * table_bytes
    # an index read bills twice its result, whatever the table's size
    idx = torch.arange(0, 512, 64)
    g = analyze(lambda t, i: t[i], table, idx)
    assert g["hbm_bytes"] == 2 * 8 * 128 * 4
    # a row write into a buffer bills the rows moved
    buf = torch.zeros(512, 128)
    w = analyze(lambda b, v: b.index_copy_(0, idx, v), buf, torch.ones(8, 128))
    assert w["hbm_bytes"] < 4 * 8 * 128 * 4 + 8 * 8


def test_views_are_free_and_casts_are_convert_bytes():
    x = torch.randn(64, 64)
    r = analyze(lambda t: t.view(4096).reshape(64, 64).T.unsqueeze(0), x)
    assert r["hbm_bytes"] == 0
    c = analyze(lambda t: t.to(torch.bfloat16), x)
    assert c["convert_bytes"] == c["hbm_bytes"] == 64 * 64 * (4 + 2)


def test_live_bytes_follow_the_autograd_graph():
    """Activations saved for the backward stay live until it runs."""
    w = torch.randn(256, 256, requires_grad=True)
    x = torch.randn(64, 256)

    def fwd_bwd(w, x):
        h = x
        for _ in range(4):
            h = torch.tanh(h @ w)
        return torch.autograd.grad(h.sum(), w)

    with CostModel() as cm:
        g = fwd_bwd(w, x)
    r = cm.result()
    act = 64 * 256 * 4
    assert r["peak_live_bytes"] >= 8 * act  # 4 products and 4 tanh outputs held
    assert r["live_bytes"] == g[0].numel() * 4  # only the gradient is left


_RING = r"""
import json
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_cost import CostModel
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
quad = dist.new_group([0, 1, 2, 3])
x = torch.randn(256, 128)
with CostModel(1) as cm:  # every group's size read from the op, none assumed
    funcol.all_reduce(x, "sum", quad)
    funcol.all_gather_tensor(x, 0, quad)
    funcol.reduce_scatter_tensor(x, "sum", 0, quad)
    funcol.all_to_all_single(x, None, None, quad)
    dist.all_reduce(x)  # a c10d op over the whole group of 8
print(json.dumps(cm.result()))
dist.destroy_process_group()
"""


def test_collective_ring_math():
    """Per-device wire bytes by the ring model on a fake group of 8 ranks,
    collectives over groups of 4 (the functional ones DTensor issues) and
    one ``torch.distributed`` all-reduce over all 8."""
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_RING)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    size = 256 * 128 * 4
    assert r["collective_bytes"]["all-reduce"] == pytest.approx(
        2 * size * 3 / 4 + 2 * size * 7 / 8)
    assert r["collective_count"]["all-reduce"] == 2
    assert r["collective_bytes"]["all-gather"] == pytest.approx(4 * size * 3 / 4)
    assert r["collective_bytes"]["reduce-scatter"] == pytest.approx(size / 4 * 3)
    assert r["collective_bytes"]["all-to-all"] == pytest.approx(size * 3 / 4)
    assert r["collective_bytes_total"] == pytest.approx(sum(r["collective_bytes"].values()))


def test_roofline_terms_dominant():
    costs = {"flops": 989e12, "hbm_bytes": 3.35e12 / 2, "collective_bytes_total": 0.0}
    t = roofline_terms(costs)
    assert t["dominant"] == "compute"
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(0.5)
    assert t["step_time_lower_bound_s"] == pytest.approx(1.0)
    assert "t_memory_tpu_s" not in t
    t = roofline_terms({"flops": 1.0, "hbm_bytes": 1.0, "collective_bytes_total": 450e9})
    assert t["dominant"] == "collective" and t["t_collective_s"] == pytest.approx(1.0)


# the port's products against the reference's, on one reduced dense step
STEP_FLOPS_REL = 0.02


def test_train_step_flops_equal_the_references():
    """One train step of reduced qwen1.5-0.5b (fp32, remat off, (4, 64)):
    the port's traced FLOPs against the reference's ``analyze`` of the
    compiled step, within ``STEP_FLOPS_REL``. Both count every product
    exactly and the model's products are the same (projections, attention
    tiles, the unembedding and their gradients); here the reference's
    count is 8,388,608 (1.3%) above the port's, the size of one more pair
    of attention-tile products, which its compiled step holds."""
    from repro import configs as rconfigs
    from repro import models as rmodels
    from repro.optim.adamw import adamw_init as radamw_init
    from repro.train.steps import make_train_step as rmake_train_step
    from repro_torch import configs
    from repro_torch.models.weights import from_reference
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import make_train_step

    over = dict(dtype="float32", remat=False)
    rcfg = rconfigs.get_config("qwen1.5-0.5b").reduced(**over)
    cfg = configs.get_config("qwen1.5-0.5b").reduced(**over)
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, 512, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = jax.jit(rmake_train_step(rcfg)).lower(
        params, radamw_init(params), jbatch).compile()
    want = ranalyze(compiled.as_text(), 1)
    model = from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = analyze(make_train_step(cfg), model, adamw_init(model), tb)
    assert got["flops"] == pytest.approx(want["flops"], rel=STEP_FLOPS_REL), (got, want)
    # the analytic floor: 6 N tokens over the matrices (the embedding's
    # gather is not a product in either)
    assert got["flops"] > 0 and got["dot_count"] > 0
