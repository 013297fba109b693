"""The port stands alone: it imports neither jax nor the JAX package
``repro``, and it never carries on on the CPU when a card was asked for."""

import ast
import io
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, models
from repro_torch.core import codec, parallel, query, stream
from repro_torch.core.encode import ColumnCodec
from repro_torch.core.ise import iterative_structure_extraction
from repro_torch.core.match import match_first
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, mesh
from repro_torch.launch import train as train_launcher
from repro_torch.models import weights

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[mod]
sys.meta_path.insert(0, Block())

import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.core.codec import LogzipConfig, compress, decompress
from repro_torch.data.loggen import DATASETS, generate_lines
lines = list(generate_lines("HDFS", 400, seed=42))
blob = compress(lines, LogzipConfig(format=DATASETS["HDFS"]["format"], device="cpu"))
assert decompress(blob) == lines
# every family of the LM zoo served on the CPU, reduced
import torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import decode_step, init_params, prefill
for arch in ARCH_IDS:
    cfg = get_config(arch).reduced(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    if cfg.n_patches:
        batch["vision"] = torch.zeros((1, cfg.n_patches, cfg.d_model))
    if cfg.n_enc_layers:
        batch["frames"] = torch.zeros((1, cfg.n_frames, cfg.d_model))
    logits, cache = prefill(model, batch, 10 + cfg.n_patches)
    logits, cache = decode_step(model, cache, logits.argmax(-1)[:, None])
    assert torch.isfinite(logits).all(), arch
# one train step, and its state through a checkpoint and back
import tempfile
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.steps import load_train_state, make_train_step, train_state
cfg = get_config("qwen1.5-0.5b").reduced(dtype="float32")
model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
toks = torch.arange(16, dtype=torch.int32).reshape(2, 8)
model, opt, m = make_train_step(cfg)(model, adamw_init(model), {"tokens": toks, "labels": toks})
assert torch.isfinite(m["loss"]) and int(opt["step"]) == 1
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, 1, train_state(model, opt), extra={"data": {}})
    tree, extra, step = load_checkpoint(d, device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert int(load_train_state(again, tree)["step"]) == 1 and step == 1
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))
# distribution: the rules at full width, a traced product's cost, the dry
# run's counts, and a sharded match on a fake mesh of 4 ranks
import numpy as np
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.distributed.sharding import AbstractMesh, param_pspecs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.models import Transformer
big = get_config("qwen1.5-0.5b")
specs = param_pspecs(Transformer(big, "meta"), big, AbstractMesh((16, 16), ("data", "model")))
assert specs["embed"] == ("model", "data")
assert hlo_cost.analyze(lambda a: a @ a, torch.ones(8, 8))["flops"] == 2 * 8 ** 3
assert dryrun.analytic_params(big)["total"] > 4e8
dryrun.fake_group(4)
m4 = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"))
hit = ops.wildcard_match_sharded(np.full((8, 3), 5, np.int32), np.full(8, 3, np.int32),
                                 np.array([[5, 1, 0]], np.int32), np.array([2], np.int32), m4)
assert tuple(hit.to_local().shape) == (2, 1) and bool(hit.to_local().all())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("OK", len(names), len(blob))
"""


def test_port_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, n_modules, _ = proc.stdout.split()
    assert ok == "OK" and int(n_modules) >= 17


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def _entry_points():
    ids = np.array([[2, 3], [2, 4]], np.int32)
    lens = np.array([2, 2], np.int32)
    tpl = [np.array([2, 1], np.int32)]
    return {
        "compress": lambda: codec.compress(["a b c"], codec.LogzipConfig(device="cuda")),
        "compress_file": lambda: codec.compress_file(
            __file__, os.devnull, codec.LogzipConfig(device="cuda")),
        "match_first": lambda: match_first(ids, lens, tpl, dedup=False, device="cuda"),
        "iterative_structure_extraction": lambda: iterative_structure_extraction(
            ids, lens, device="cuda"),
        "ColumnCodec": lambda: ColumnCodec("h.x", typed=True, device="cuda").encode(
            [str(v) for v in range(40)]),
        "delta_zigzag": lambda: ops.delta_zigzag(ids, lens, lens, device="cuda"),
        "simcount": lambda: ops.simcount(ids, ids, device="cuda"),
        "match_extract": lambda: ops.match_extract(ids, lens, tpl, device="cuda"),
        "match_extract_empty": lambda: ops.match_extract(ids[:0], lens[:0], tpl, device="cuda"),
        "device_tokenize": lambda: ops.device_tokenize(["a b"], device="cuda"),
        "device_encode_batch": lambda: ops.device_encode_batch(["a b"], None, 4, device="cuda"),
        "distinct_counts": lambda: ops.distinct_counts(lens, 3, device="cuda"),
        "distinct_counts_empty": lambda: ops.distinct_counts(lens[:0], 3, device="cuda"),
        "StreamingCompressor": lambda: _stream(codec.LogzipConfig(device="cuda")),
        "compress_parallel": lambda: parallel.compress_parallel(
            ["a b c"] * 4, codec.LogzipConfig(device="cuda"), n_workers=1, chunk_lines=2),
        "seed_template_store": lambda: parallel.seed_template_store(
            ["a b c"] * 4, codec.LogzipConfig(device="cuda")),
        "count_by_template": lambda: query.count_by_template(_archive(), device="cuda"),
        "top_k": lambda: query.top_k(_archive(), "Level", device="cuda"),
        "time_histogram": lambda: query.time_histogram(_archive(), "Time", device="cuda"),
        # the data pipeline: the writers' cfg=None is LogzipConfig(level=3) on "cuda"
        "write_logzip_shards": lambda: pipeline.write_logzip_shards(["a b c"], os.devnull + "/x"),
        "write_logzip_stream": lambda: pipeline.write_logzip_stream(["a b c"], os.devnull + "/x"),
        "TokenBatcher": lambda: pipeline.TokenBatcher(os.devnull),
        # the LM serving path
        "init_params": lambda: models.init_params(_small_lm()),
        "Transformer": lambda: models.Transformer(_small_lm()),
        "init_cache": lambda: models.init_cache(_small_lm(), 1, 4),
        "from_reference": lambda: weights.from_reference(_small_lm(), {}),
        # the other families: MoE, the mamba hybrid, RWKV6, the VLM, audio
        **{f"{entry}[{arch}]": _family_entry(entry, arch) for arch in FAMILIES
           for entry in ("init_params", "init_cache", "from_reference")},
        # training: the checkpoint reader and the launcher
        "load_checkpoint": lambda: checkpoint.load_checkpoint(os.devnull),
        "CheckpointManager.restore": lambda: checkpoint.CheckpointManager(os.devnull).restore(),
        "launch.train": lambda: train_launcher.main(["--workdir", os.devnull + "/x"]),
        "launch.train[model-parallel]": lambda: train_launcher.main(
            ["--workdir", os.devnull + "/x", "--model-parallel", "2"]),
        # distribution: meshes, the sharded match on a CUDA mesh, the dry run
        "make_local_mesh": lambda: mesh.make_local_mesh(2),
        "make_production_mesh": lambda: mesh.make_production_mesh(multi_pod=True),
        "wildcard_match_sharded": lambda: ops.wildcard_match_sharded(
            ids, lens, np.array([[2, 1]], np.int32), np.array([2], np.int32),
            types.SimpleNamespace(device_type="cuda", mesh_dim_names=("data",))),
        "dryrun.main": lambda: dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                                            "--out", os.devnull + "/x"]),
        "dryrun.run_cell": lambda: dryrun.run_cell("whisper-base", "prefill_32k", "multi",
                                                   os.devnull + "/x"),
    }


FAMILIES = ["dbrx-132b", "jamba-v0.1-52b", "rwkv6-7b", "internvl2-2b", "whisper-base"]


def _family_entry(entry, arch):
    def call():
        from repro_torch.configs import get_config

        cfg = get_config(arch).reduced()
        if entry == "init_params":
            return models.init_params(cfg)
        if entry == "init_cache":
            return models.init_cache(cfg, 1, 4)
        return weights.from_reference(cfg, {})
    return call


def _small_lm():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b").reduced()


def _stream(cfg):
    with stream.StreamingCompressor(io.BytesIO(), cfg) as sc:
        sc.feed(["a b c"])


def _archive():
    """A screened LZJS archive: count_by_template reads its manifests and
    opens no chunk, yet device="cuda" still raises without a card."""
    from repro_torch.data.loggen import DATASETS, generate_lines

    buf = io.BytesIO()
    cfg = codec.LogzipConfig(format=DATASETS["HDFS"]["format"], device="cpu")
    with stream.StreamingCompressor(buf, cfg, chunk_lines=50) as sc:
        sc.feed(generate_lines("HDFS", 100, seed=1))
    return buf.getvalue()


@pytest.mark.parametrize("name", list(_entry_points()))
def test_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' runs the kernels")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_device_defaults_to_cuda():
    assert codec.LogzipConfig().device == "cuda"
    assert ColumnCodec("x").device == "cuda"
    assert ColumnCodec("x").use_kernel
