"""The port's sharding rules against the JAX package's.

``param_pspecs`` on both production mesh shapes for all ten archs at full
width, in "2d" and "dp" mode, leaf by leaf: the reference's spec of a
stacked leaf minus its leading stack entry. ``zero1_opt_pspecs``,
``batch_pspecs`` and ``cache_pspecs`` on the reference test's archs;
``tp_pad``; ``act_spec`` against the spec the reference's ``shard_act``
builds. Then, in a subprocess with 8 host devices for the reference and
a fake process group of 8 ranks for the port: ``to_placements`` gives
each rank the block of the tensor that ``NamedSharding`` gives the device
at the same mesh coordinate, and ``shard_act`` redistributes a
``DTensor`` to the placements of the reference's spec.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as rget_config
from repro.distributed import act_shard as ract_shard
from repro.distributed.sharding import batch_pspecs as rbatch_pspecs
from repro.distributed.sharding import cache_pspecs as rcache_pspecs
from repro.distributed.sharding import param_pspecs as rparam_pspecs
from repro.distributed.sharding import zero1_opt_pspecs as rzero1_opt_pspecs
from repro.models import init_cache as rinit_cache
from repro.models import init_params as rinit_params
from repro.models import tp_pad as rtp_pad
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import act_shard
from repro_torch.distributed.sharding import (
    AbstractMesh,
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    zero1_opt_pspecs,
)
from repro_torch.models import Transformer, init_cache, tp_pad
from repro_torch.models.weights import reference_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1pod": ((16, 16), ("data", "model")), "2pod": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(sizes, names):
    try:
        return JAbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x takes (name, size) pairs
        return JAbstractMesh(tuple(zip(names, sizes)))


def _tuple(spec) -> tuple:
    """A ``PartitionSpec`` as the port's plain tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _flat(tree, prefix=()):
    """{path tuple: leaf} of a nested dict (a list's index as a key; a
    tuple, a spec, is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def _ref_specs(cfg, mesh, mode):
    params = jax.eval_shape(lambda k: rinit_params(cfg, k), jax.random.PRNGKey(0))
    specs = rparam_pspecs(params, cfg, mesh, mode=mode)
    return ({k: v.shape for k, v in _flat(params).items()},
            {k: _tuple(v) for k, v in _flat(specs).items()})


def test_the_archs_are_the_references():
    assert ARCH_IDS == R_ARCH_IDS


@pytest.mark.parametrize("mode", ["2d", "dp"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_the_references(arch, mesh_id, mode):
    """Every parameter's spec is the reference's for its leaf, minus the
    stack dim; every leaf is covered and divides; every leaf above 1e6
    elements is sharded in 2d mode (the reference's checks)."""
    sizes, names = MESHES[mesh_id]
    cfg = tp_pad(get_config(arch), 16)
    rcfg = rtp_pad(rget_config(arch), 16)
    model = Transformer(cfg, "meta")
    got = param_pspecs(model, cfg, AbstractMesh(sizes, names), mode=mode)
    shapes, want = _ref_specs(rcfg, _jmesh(sizes, names), mode)
    paths = reference_paths(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    seen = set()
    ax = dict(zip(names, sizes))
    big = 0
    for name, p in model.named_parameters():
        keys, stack = paths[name]
        key = tuple(keys)
        ref = want[key]
        if stack:
            assert ref[0] is None and shapes[key][0] == stack, (name, ref, shapes[key])
            ref = ref[1:]
        ref = ref + (None,) * (p.ndim - len(ref))
        assert got[name] == ref, (name, got[name], ref)
        seen.add(key)
        for dim, e in zip(p.shape, got[name]):
            n = int(np.prod([ax[a] for a in (e if isinstance(e, tuple) else (e,))])) \
                if e is not None else 1
            assert dim % n == 0, (name, p.shape, got[name])
        if mode == "2d" and p.numel() > 1e6:
            assert any(e is not None for e in got[name]), (name, got[name])
            big += 1
    assert seen == set(want)  # every reference leaf is one of the port's
    assert mode == "dp" or big > 0


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-base"])
def test_zero1_opt_pspecs_equal_the_references(arch):
    """On both production meshes the reference never picks the layer dim
    (no layer count divides 256 or 512): the port's spec is the
    reference's minus the stack dim."""
    cfg = tp_pad(get_config(arch), 16)
    rcfg = rtp_pad(rget_config(arch), 16)
    model = Transformer(cfg, "meta")
    paths = reference_paths(model)
    params = jax.eval_shape(lambda k: rinit_params(rcfg, k), jax.random.PRNGKey(0))
    for sizes, names in MESHES.values():
        got = zero1_opt_pspecs(model, AbstractMesh(sizes, names))
        want = {k: _tuple(v) for k, v in _flat(rzero1_opt_pspecs(params, _jmesh(sizes, names)))
                .items()}
        for name, p in model.named_parameters():
            keys, stack = paths[name]
            ref = want[tuple(keys)]
            if stack:
                assert ref[0] is None, (name, ref)
                ref = ref[1:]
            assert got[name] == ref, (name, got[name], ref)


def test_zero1_divergence_where_the_reference_shards_the_layer_dim():
    """ROADMAP C.6: on a mesh of 2 a 2-layer model's stacked leaves divide
    on the layer dim, which the reference shards; the port's per-block
    moments lack it and shard the first per-block dim that divides, or
    none."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    rcfg = rget_config("qwen1.5-0.5b").reduced()
    model = Transformer(cfg, "meta")
    paths = reference_paths(model)
    params = jax.eval_shape(lambda k: rinit_params(rcfg, k), jax.random.PRNGKey(0))
    want = {k: _tuple(v) for k, v in _flat(rzero1_opt_pspecs(params, _jmesh((2,), ("data",))))
            .items()}
    got = zero1_opt_pspecs(model, AbstractMesh((2,), ("data",)))
    diverged = 0
    for name, p in model.named_parameters():
        keys, stack = paths[name]
        ref = want[tuple(keys)]
        if stack:
            assert ref[0] == "data", (name, ref)  # the reference takes the layer dim
            first = next((i for i, d in enumerate(p.shape) if d % 2 == 0), None)
            expect = tuple("data" if i == first else None for i in range(p.ndim))
            assert got[name] == expect, (name, got[name])
            diverged += 1
        else:
            assert got[name] == ref, (name, got[name], ref)
    assert diverged == len(list(model.named_parameters())) - 3  # all but embed/unembed/ln_f


def test_batch_pspecs_equal_the_references():
    for sizes, names in MESHES.values():
        jm, pm = _jmesh(sizes, names), AbstractMesh(sizes, names)
        for shape in ((256, 4096), (1, 1), (32, 32768), (128, 1), (512, 16, 8)):
            batch = {"tokens": jax.ShapeDtypeStruct(shape, np.int32)}
            want = _tuple(rbatch_pspecs(batch, jm)["tokens"])
            assert batch_pspecs({"tokens": shape}, pm)["tokens"] == want, (names, shape)
            dp = tuple(names)
            want = _tuple(rbatch_pspecs(batch, jm, dp_axes=dp)["tokens"])
            assert batch_pspecs({"tokens": torch.empty(shape, device="meta")}, pm,
                                dp_axes=dp)["tokens"] == want
    # long_500k: replicate the batch
    one = batch_pspecs({"tokens": (1, 1)}, AbstractMesh((16, 16), ("data", "model")))
    assert one["tokens"] == (None, None)


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b", "rwkv6-7b", "whisper-base"])
def test_cache_pspecs_equal_the_references(arch):
    """The port's per-block cache leaves take the reference's stacked
    leaves' specs minus the stack dim; the KV sequence shards over model."""
    cfg = tp_pad(get_config(arch), 16)
    rcfg = rtp_pad(rget_config(arch), 16)
    jm = _jmesh((16, 16), ("data", "model"))
    pm = AbstractMesh((16, 16), ("data", "model"))
    ref = jax.eval_shape(lambda: rinit_cache(rcfg, 128, 32768))
    want = {k: _tuple(v) for k, v in _flat(rcache_pspecs(ref, rcfg, jm)).items()}
    got = _flat(cache_pspecs(init_cache(cfg, 128, 32768, device="meta"), cfg, pm))
    assert rcfg.scan_layers and got  # the reference stacks blocks and xattn
    for path, spec in got.items():
        if path[0] in ("blocks", "xattn"):  # (group, block index, ...): drop both
            ref = want[(path[0],) + path[2:]][1:]
        else:
            ref = want[path]
        assert spec == ref, (path, spec, ref)
        if path[-1] in ("k", "v") and path[0] == "blocks":
            assert "model" in spec, (path, spec)


def test_tp_pad():
    cfg = get_config("qwen2-7b")
    padded = tp_pad(cfg, 16)
    assert padded.n_heads == 32 and padded.n_kv_heads == 4
    cfg2 = get_config("qwen1.5-4b")
    padded2 = tp_pad(cfg2, 16)
    assert padded2.n_heads == 32 and padded2.n_kv_heads == 32  # MHA stays MHA
    assert tp_pad(get_config("qwen3-1.7b"), 16).n_heads == 16  # already divides
    for arch in ARCH_IDS:
        for tp in (2, 4, 16):
            a, b = tp_pad(get_config(arch), tp), rtp_pad(rget_config(arch), tp)
            assert (a.n_heads, a.n_kv_heads, a.head_dim) == (b.n_heads, b.n_kv_heads, b.head_dim)


_DIMS = [(("batch", None, "model", None), (256, 64, 16, 128)),
         (("batch", None, None), (256, 4096, 1024)),
         (("batch", None, None), (1, 1, 1024)),            # batch 1: replicated
         (("model", "batch", None), (16, 512, 4096)),
         (("model", "batch", None), (8, 512, 4096)),       # 8 experts < tp 16
         (("batch", "model", None, None), (32, 64, 64, 64)),
         ((None, "model"), (1024, 152064)),
         (("batch", None, "model"), (256, 4096, 151936))]


@pytest.mark.parametrize("dp_axes,tp", [(None, True), (("pod", "data", "model"), False)])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_act_spec_equals_the_references(monkeypatch, mesh_id, dp_axes, tp):
    """The port's ``act_spec`` is the spec the reference's ``shard_act``
    hands ``with_sharding_constraint`` (captured; the JAX package is not
    edited), for the model's sites, in 2d and in pure-DP layouts."""
    sizes, names = MESHES[mesh_id]
    if dp_axes is not None:
        dp_axes = tuple(a for a in dp_axes if a in names)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: seen.append(s) or x)
    monkeypatch.setattr(ract_shard, "NamedSharding", lambda mesh, spec: spec)
    rmesh = _jmesh(sizes, names)
    ract_shard.install_mesh(rmesh, dp_axes=dp_axes, tp=tp)
    act_shard.install_mesh(AbstractMesh(sizes, names), dp_axes=dp_axes, tp=tp)
    try:
        for dims, shape in _DIMS:
            ract_shard.shard_act(jax.ShapeDtypeStruct(shape, np.float32), dims)
            assert act_shard.act_spec(shape, dims) == _tuple(seen[-1]), (dims, shape)
    finally:
        ract_shard.install_mesh(None)
        act_shard.install_mesh(None)
    assert act_shard.act_spec((4, 4), ("batch", None)) is None  # no mesh: no spec


_PLACEMENTS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np, torch, torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro.distributed import act_shard as ract
from repro_torch.distributed import act_shard
from repro_torch.distributed.sharding import place, to_placements

CASES = [
    ((2, 4), ("data", "model"), (8, 12), ("data", "model")),
    ((2, 4), ("data", "model"), (8, 12), ("model", "data")),
    ((2, 4), ("data", "model"), (16, 4), (("data", "model"), None)),
    ((2, 4), ("data", "model"), (8, 12), (None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 12), (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 12, 6), (("pod", "data", "model"), None, None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 12), ("model", ("pod", "data"))),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4), (None, None)),
]
# shard_act's sites: (dims, shape) on each mesh, 2d layout
ACTS = [(("batch", None, "model", None), (8, 4, 4, 2)), (("batch", None, None), (8, 4, 6)),
        (("model", "batch", None), (4, 8, 2)), (("batch", "model", None, None), (6, 4, 2, 2))]

def spec_p(s):
    return P(*s)

out = {"blocks": [], "acts": []}
for sizes, names, shape, spec in CASES:
    jm = jax.make_mesh(sizes, names)
    idx = NamedSharding(jm, spec_p(spec)).devices_indices_map(shape)
    coords = {d.id: c for c, d in np.ndenumerate(jm.devices)}
    want = {}
    for dev, sl in idx.items():
        want[coords[dev.id]] = [[s.start or 0, s.stop if s.stop is not None else shape[i]]
                                for i, s in enumerate(sl)]
    out["blocks"].append({"case": [list(sizes), list(names), list(shape)],
                          "want": {str(list(k)): v for k, v in want.items()}})

# the reference's shard_act specs, captured
seen = []
jax.lax.with_sharding_constraint = lambda x, s: seen.append(s.spec) or x
for sizes, names in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
    ract.install_mesh(jax.make_mesh(sizes, names))
    for dims, shape in ACTS:
        ract.shard_act(jax.numpy.zeros(shape), dims)
        out["acts"].append({"mesh": [list(sizes), list(names)], "dims": list(dims),
                            "shape": list(shape),
                            "spec": [list(e) if isinstance(e, tuple) else e for e in seen[-1]]})

got_blocks = [dict() for _ in CASES]
got_acts = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    for i, (sizes, names, shape, spec) in enumerate(CASES):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(sizes), mesh_dim_names=names)
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        loc = place(full, spec, mesh).to_local()
        coord = tuple(mesh.get_coordinate())
        # the block's bounds from its first and last elements
        first = np.unravel_index(int(loc.flatten()[0]), shape) if loc.numel() else None
        last = np.unravel_index(int(loc.flatten()[-1]), shape) if loc.numel() else None
        bounds = [[int(a), int(b) + 1] for a, b in zip(first, last)]
        assert list(loc.shape) == [b - a for a, b in bounds], (loc.shape, bounds)
        got_blocks[i][str(list(coord))] = bounds
    if rank == 0:
        from torch.distributed.tensor import distribute_tensor, Replicate
        for sizes, names in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(sizes), mesh_dim_names=names)
            act_shard.install_mesh(mesh)
            for dims, shape in ACTS:
                x = distribute_tensor(torch.zeros(shape), mesh, [Replicate()] * len(sizes),
                                      src_data_rank=None)
                y = act_shard.shard_act(x, dims)
                got_acts.append([str(p) for p in y.placements])
            act_shard.install_mesh(None)
    dist.destroy_process_group()
out["got_blocks"] = got_blocks
out["got_acts"] = got_acts
# the placements the reference's specs map to, on the same meshes
want_acts = []
for rank in (0,):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    for a in out["acts"]:
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(a["mesh"][0]),
                          mesh_dim_names=tuple(a["mesh"][1]))
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in a["spec"])
        want_acts.append([str(p) for p in to_placements(spec, mesh)])
    dist.destroy_process_group()
out["want_acts"] = want_acts
print(json.dumps(out))
"""


def test_placements_give_each_rank_the_references_block():
    """``to_placements`` on a (2, 4) and a (2, 2, 2) mesh: the block of a
    tensor each rank keeps is the one ``NamedSharding.devices_indices_map``
    gives the device at the same mesh coordinate (one dim over two or
    three axes too, pod-major); ``shard_act`` redistributes a ``DTensor``
    to the placements of the reference's spec."""
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_PLACEMENTS)], env=env,
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    for case, got in zip(out["blocks"], out["got_blocks"]):
        assert got == case["want"], (case["case"], got, case["want"])
    assert len(out["got_acts"]) == len(out["want_acts"]) == 8
    assert out["got_acts"] == out["want_acts"]
    assert any(p.startswith("S(") for acts in out["got_acts"] for p in acts)
