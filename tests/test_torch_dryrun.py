"""The port's dry run (``launch.dryrun``): its pure functions against the
JAX package's for every arch and shape, and a cell traced end to end on
a fake process group (the counterpart of ``tests/test_multidevice.py::
test_dryrun_cell_smoke``, which is red on this tree: the reference's
``with_sharding_constraint`` refuses jax 0.9's ``Explicit`` mesh axes,
ROADMAP C)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rdryrun():
    """The reference's dryrun module; importing it sets ``XLA_FLAGS`` for
    512 host devices, which is put back so that later subprocesses do not
    inherit it."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pure_functions_equal_the_references(rdryrun, arch):
    from repro.configs import get_config as rget_config
    from repro.models import tp_pad as rtp_pad
    from repro_torch.models import tp_pad

    for tp in (1, 16):
        cfg, rcfg = tp_pad(get_config(arch), tp), rtp_pad(rget_config(arch), tp)
        assert dryrun.analytic_params(cfg) == rdryrun.analytic_params(rcfg)
        for shape in SHAPES:
            assert dryrun.model_flops(cfg, shape) == rdryrun.model_flops(rcfg, shape)
            assert dryrun.parallel_mode(cfg, shape) == rdryrun.parallel_mode(rcfg, shape)
        for batch, dp in ((256, 16), (256, 32), (32, 16), (128, 256), (1, 16)):
            assert (dryrun.default_microbatches(cfg, batch, dp)
                    == rdryrun.default_microbatches(rcfg, batch, dp))
    assert dryrun.default_microbatches(get_config(arch)) == \
        rdryrun.default_microbatches(rget_config(arch))


_CELL = r"""
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
dryrun.fake_group(8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"))
dryrun.SHAPES["smoke_64"] = {"seq": 64, "batch": 8, "kind": sys.argv[2]}
art = dryrun.run_cell(sys.argv[1], "smoke_64", "single", sys.argv[3], device="cpu", mesh=mesh,
                      cfg=get_config(sys.argv[1]).reduced(), mode="2d")
print(json.dumps(art))
"""


def _cell(tmp_path, arch: str, kind: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_CELL), arch, kind,
                        str(tmp_path)], env=env, capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    art = json.loads(p.stdout.strip().splitlines()[-1])
    on_disk = json.loads((tmp_path / f"{arch}__smoke_64__single.json").read_text())
    assert on_disk == art
    return art


def test_dryrun_cell_on_a_fake_mesh(tmp_path):
    """Reduced jamba (mamba, attention, MoE) trained one step on a fake
    (4, 2) mesh in 2d mode, traced on meta tensors: FLOPs, bytes,
    collectives and temporary memory all above zero, every key of the
    reference's artifact that has a counterpart present, the parameters
    aliased by the in-place update."""
    art = _cell(tmp_path, "jamba-v0.1-52b", "train")
    for key in ("arch", "shape", "mesh", "chips", "microbatches", "padded_heads", "lower_s",
                "memory", "hlo_cost", "roofline", "model_flops_global",
                "model_flops_per_device", "useful_flops_ratio"):
        assert key in art, key
    mem, hc = art["memory"], art["hlo_cost"]
    assert set(mem) >= {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0
    assert 0 < mem["alias_bytes"] < mem["output_bytes"]
    assert hc["flops_per_device"] > 0 and hc["hbm_bytes_per_device"] > 0
    assert hc["dot_count"] > 0
    assert sum(hc["collective_count"].values()) > 0 and hc["collective_bytes_total"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(hc["collective_count"])  # FSDP
    assert art["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert art["chips"] == 8 and art["mode"] == "2d"


def test_dryrun_prefill_cell_on_a_fake_mesh(tmp_path):
    """A prefill of reduced qwen2-7b on the same mesh: products and
    collectives counted, nothing aliased (no parameter update)."""
    art = _cell(tmp_path, "qwen2-7b", "prefill")
    mem, hc = art["memory"], art["hlo_cost"]
    assert hc["flops_per_device"] > 0 and sum(hc["collective_count"].values()) > 0
    assert mem["alias_bytes"] == 0 and mem["output_bytes"] > 0
    assert art["microbatches"] == 0


def test_dryrun_decode_cell_is_refused_with_its_reason():
    """Decode cells are not ported (ROADMAP A.2): the refusal comes before
    any process group is made."""
    import torch

    with pytest.raises(NotImplementedError, match="sequence dim is split"):
        dryrun.lower_cell("qwen2-7b", "decode_32k", False, device="cpu")
    assert not torch.distributed.is_initialized()
