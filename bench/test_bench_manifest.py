"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
files are found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from bench import harness, ports, references

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for w in cmd[1:]:
        if (ROOT / w).exists():
            assert any(Path(w).parts[0] == Path(p).parts[0] for p in MANIFEST["paths"])
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys_and_allowed_characters():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    for group in (names, CELLS, [c["name"] for c in MANIFEST["configs"]]):
        assert len(group) == len(set(group))
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(CELLS)
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve_by_name(name):
    cell = harness.load_cell(name, MANIFEST)
    assert callable(harness.driver(cell).run) and callable(harness.driver(cell).tiny)
    for folder in ("references", "ports"):
        assert (ROOT / "bench" / folder / f"{cell.config['reference']}.py").is_file()
    ref, port = references.of(cell.config), ports.of(cell.config)
    for fn in ("leaves", "logits_at", "train_steps", "block_rows", "train_phases",
               "serve_phases", "tiny"):
        assert callable(getattr(ref, fn)), fn
    for fn in ("model_config", "build_model", "program_name", "leaf"):
        assert callable(getattr(port, fn)), fn
    conf = {c["name"]: c for c in MANIFEST["configs"]}[cell.workload["config"]]
    assert conf["file"].startswith("bench/") and (ROOT / conf["file"]).is_file()
    for m in harness.metrics_of(cell, False) + harness.metrics_of(cell, True):
        assert callable(harness._module(ROOT / "bench" / "metrics" / f"{m['name']}.py").read)
    assert all(math.isfinite(v) for v in cell.limits.values())


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(name):
    cell = harness.load_cell(name, MANIFEST)
    e2e = {m["name"] for m in harness.metrics_of(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_of(cell, True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_each_layer_is_named_alike_and_every_configuration_is_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert all(m["moves"] in e2e for m in MANIFEST["per_layer"])


def test_a_family_is_found_by_the_reference_key(monkeypatch):
    """A configuration of another family names its own reference and port
    modules; the weights and the counts go through them, so a new family
    is files added under ``references/`` and ``ports/``."""
    import sys
    import types

    from bench import counts, weights

    fam = types.ModuleType("bench.references.other_family")
    fam.leaves = lambda c: [("a", (2, 3), "normal", 0.5), ("b", (4,), "ones", 1.0)]
    fam.train_phases = lambda c, batch, seq: [{"phase": "all", "flops": batch * seq,
                                               "bytes": 1}]
    monkeypatch.setitem(sys.modules, fam.__name__, fam)
    c = {"reference": "other_family"}
    assert references.of(c) is fam
    w = weights.make_weights(c, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == {"a": (2, 3), "b": (4,)}
    assert weights.n_params(c) == 10
    assert counts.train_step(c, 3, 7) == [{"phase": "all", "flops": 21, "bytes": 1}]
