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
dryrun.SHAPES["smoke_64"] = {"seq": 64, "batch": int(sys.argv[4]), "kind": sys.argv[2]}
art = dryrun.run_cell(sys.argv[1], "smoke_64", "single", sys.argv[3], device="cpu", mesh=mesh,
                      cfg=get_config(sys.argv[1]).reduced(), mode="2d")
print(json.dumps(art))
"""


def _cell(tmp_path, arch: str, kind: str, batch: int = 8) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_CELL), arch, kind,
                        str(tmp_path), str(batch)], env=env, capture_output=True, text=True,
                       timeout=400)
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


MESH = ((4, 2), ("data", "model"))


def _local_bytes(tree, specs) -> int:
    """The bytes of one rank's blocks of ``tree``'s tensors (meta) placed
    by ``specs`` (a tree of the same shape) on ``MESH``."""
    sizes = dict(zip(MESH[1], MESH[0]))
    if isinstance(tree, dict):
        return sum(_local_bytes(v, specs[k]) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_local_bytes(v, sp) for v, sp in zip(tree, specs))
    n = tree.numel()
    for e in specs:
        for a in () if e is None else e if isinstance(e, tuple) else (e,):
            n //= sizes[a]
    return n * tree.element_size()


def _decode_flops(cfg, batch: int, seq: int) -> float:
    """The products of one decode step, all ranks together, from the
    config: the reference's ``model_flops`` (2 N_active per token), less
    what it counts that is no product (the embedding's rows are gathered;
    mamba's conv, A and D act elementwise), plus each attention layer's
    4 B S H hd against the whole cache, plus what the einsum MoE computes
    beyond its top-k experts (every expert runs its capacity slots) and
    its dispatch and combine products."""
    d, f = cfg.d_model, cfg.d_ff
    out = 2.0 * dryrun.analytic_params(cfg)["active"] * batch  # model_flops of a decode
    if not cfg.tie_embeddings:
        out -= 2 * batch * cfg.padded_vocab * d
    g = min(512, batch)
    while batch % g:
        g -= 1
    cap = max(1, int(g * cfg.top_k * cfg.capacity_factor / max(cfg.n_experts, 1)))
    nmat = 3 if cfg.ffn_act == "swiglu" else 2
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            out += 4 * batch * seq * cfg.n_heads * cfg.head_dim
        elif kind == "mamba":
            di = cfg.d_inner
            out -= 2 * batch * (cfg.ssm_conv * di + di * cfg.ssm_state + di)
        if kind != "rwkv6" and cfg.layer_is_moe(i):
            slots = (batch // g) * cfg.n_experts * cap
            out += 2 * (slots - batch * cfg.top_k) * nmat * d * f
            out += 2 * 2 * slots * g * d
    return out


@pytest.mark.parametrize("arch,batch", [("qwen2-7b", 8), ("jamba-v0.1-52b", 1)])
def test_dryrun_decode_cell_on_a_fake_mesh(tmp_path, arch, batch):
    """A decode step of the reduced config (``decode_32k`` of qwen2-7b, and
    ``long_500k`` of jamba: batch 1, so the batch is not split; mamba
    states over "model", MoE decode) against a cache of 64 on the fake
    (4, 2) mesh in 2d: every key the train cell has; the arguments are
    the rank's blocks of the parameters, the cache and the tokens, as
    their specs place them; the cache but ``pos`` (a new ``pos + 1``) is
    updated in place, so aliased; no all-gather of a cache block; the
    traced products per rank from their count derived from the config
    (``_decode_flops`` over the 8 ranks) up to twice it: DTensor places
    each product op by op and may repeat part of one on the ranks of an
    axis (the reduced jamba's products run 1.7x their share)."""
    import torch

    from repro_torch.distributed.sharding import (
        AbstractMesh,
        batch_pspecs,
        cache_pspecs,
        param_pspecs,
    )
    from repro_torch.models import Transformer, init_cache, tp_pad

    art = _cell(tmp_path, arch, "decode", batch)
    for key in ("arch", "shape", "mesh", "chips", "microbatches", "padded_heads", "lower_s",
                "memory", "hlo_cost", "roofline", "model_flops_global",
                "model_flops_per_device", "useful_flops_ratio"):
        assert key in art, key
    mem, hc = art["memory"], art["hlo_cost"]
    assert set(mem) >= {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert art["chips"] == 8 and art["mode"] == "2d" and art["microbatches"] == 0

    cfg = tp_pad(get_config(arch).reduced(), 2)
    mesh = AbstractMesh(*MESH)
    model = Transformer(cfg, "meta")
    specs = param_pspecs(model, cfg, mesh)
    params = sum(_local_bytes(p, specs[n]) for n, p in model.named_parameters())
    cache = init_cache(cfg, batch, 64, device="meta")
    cspecs = cache_pspecs(cache, cfg, mesh)
    toks = {"t": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
    states = dict(cache, pos=[])
    assert mem["argument_bytes"] == (params + _local_bytes(cache, cspecs)
                                     + _local_bytes(toks, batch_pspecs(toks, mesh)))
    assert mem["alias_bytes"] == _local_bytes(states, dict(cspecs, pos=[])) > 0
    assert mem["output_bytes"] > mem["alias_bytes"] and mem["temp_bytes"] > 0

    want = _decode_flops(cfg, batch, 64) / 8
    assert want <= hc["flops_per_device"] <= 2 * want, (hc["flops_per_device"], want)
    assert hc["dot_count"] > 0 and hc["hbm_bytes_per_device"] > 0
    assert sum(hc["collective_count"].values()) > 0
    assert art["cache_all_gathers"] == 0 and hc["all_gather_inputs"]


_PREFILL = r"""
import json, sys
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import cache_pspecs, to_placements
from repro_torch.launch import dryrun
dryrun.fake_group(8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"))
dryrun.SHAPES["smoke_64"] = {"seq": 64, "batch": 8, "kind": "prefill"}
mesh, cfg, step, args, _, _ = dryrun.lower_cell(sys.argv[1], "smoke_64", False, device="cpu",
                                                mesh=mesh, cfg=get_config(sys.argv[1]).reduced(),
                                                mode="2d")
_, cache = step(*args)
got, want = [], []
def visit(node, spec):
    if isinstance(node, dict):
        return [visit(node[k], spec[k]) for k in node]
    if isinstance(node, list):
        return [visit(v, s) for v, s in zip(node, spec)]
    got.append([str(p) for p in node.placements])
    want.append([str(p) for p in to_placements(spec, mesh)])
visit(cache, cache_pspecs(cache, cfg, mesh))
print(json.dumps({"got": got, "want": want}))
"""


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "internvl2-2b"])
def test_dryrun_prefill_cell_places_its_cache_as_the_reference(arch):
    """The prefill cell's step returns its cache placed by ``cache_pspecs``
    (the reference's ``out_shardings=(None, c_shard)``, ROADMAP C.9), on
    the fake (4, 2) mesh, every leaf: reduced jamba (K/V split over
    "model" along the sequence, mamba's states over "model", ``pos`` over
    "data") and reduced internvl2 (whose vision prefix is joined to the
    embedding's rows: ROADMAP C.10)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", _PREFILL, arch], env=env,
                       capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["got"] == out["want"] and len(out["got"]) >= 5
    assert any("S(1)" in "".join(w) or "Shard(dim=1)" in "".join(w) for w in out["want"])


def test_production_prefill_cell_with_fewer_kv_heads_than_the_model_axis(tmp_path):
    """qwen2-7b x prefill_32k on the (16, 16) mesh of 256 fake ranks (4 KV
    heads, a model axis of 16), on shapes: DTensor split the K/V
    projections' columns over "model" and the reshape to (B, S, 4, 128)
    raised (ROADMAP C.10); the columns now split by whole heads only. The
    cell runs, fits 80 GB a rank, returns its cache placed by
    ``cache_pspecs`` and gathers no cache block."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-7b",
                        "--shape", "prefill_32k", "--device", "cpu", "--out", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stderr[-3000:]
    art = json.loads((tmp_path / "qwen2-7b__prefill_32k__single.json").read_text())
    assert art["chips"] == 256 and art["mode"] == "2d"
    assert art["memory"]["fits_hbm"] and art["cache_all_gathers"] == 0
    assert art["hlo_cost"]["flops_per_device"] > 0
