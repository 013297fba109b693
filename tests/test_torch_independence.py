"""The port stands alone: it imports neither jax nor the JAX package
``repro``, and it never carries on on the CPU when a card was asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import codec
from repro_torch.core.encode import ColumnCodec
from repro_torch.core.ise import iterative_structure_extraction
from repro_torch.core.match import match_first
from repro_torch.kernels import ops

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
    }


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
