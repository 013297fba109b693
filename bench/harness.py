"""One run of one cell: the cell's files found by name, its driver run,
its metrics read, its numbers judged, and the result line built.

A driver (``kinds/<kind>.py``, the ``kind`` of the cell's traffic) has
``tiny(traffic) -> dict`` (the mix cut for the CPU tests) and
``run(run: Run, controls: bool = False) -> dict``, a record holding at
least ``t_window`` (the host clock at the first timed step),
``attempted``, ``failed``, ``numbers`` (the compared numbers by name),
``every`` (every number it can compare, for ``readings.py``), with
``controls`` also ``controls`` (the same numbers of the control and of
each fault, by name), ``memory_peak_bytes``, ``phases`` (the FLOP and
byte counts behind the shares) and, in a traced run, ``trace``
(``trace.reduce``'s figures); the metric readers take what else they
need from it.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import checks, counts

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    manifest: dict


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    log: list = field(default_factory=list)

    def sub(self, k: int) -> int:
        """A 63-bit seed for the ``k``-th use of the run's seed."""
        ss = np.random.SeedSequence([abs(int(self.seed)), k])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = manifest if manifest is not None else _json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(name=name, workload=w, config=_json(ROOT / conf["file"]),
                traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=_json(BENCH / "limits" / f"{name}.json")["limits"], manifest=manifest)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return importlib.import_module(f"bench.kinds.{cell.traffic['kind']}")


def metrics_of(cell: Cell, trace: bool) -> list[dict]:
    """The metrics this cell reports in a run with or without the trace."""
    e2e = [m for m in cell.manifest["end_to_end"]
           if "workloads" not in m or cell.name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in cell.manifest["per_layer"]
            if cell.name in m.get("workloads", [cell.name] if m["moves"] in moved else [])]


def read_metrics(cell: Cell, rec: dict, trace: bool) -> dict:
    out = {}
    for m in metrics_of(cell, trace):
        value = _module(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card(device) -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={torch.cuda.current_device()}"], capture_output=True,
                             text=True, timeout=30)
        limit = out.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "power_limit": limit}


def peak_of(device_kind: str) -> dict | None:
    return _json(BENCH / "peaks.json")["cards"].get(device_kind)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run, out=sys.stdout, err=sys.stderr) -> dict | None:
    """Run the cell and print its result line; None (and nothing on
    ``out``) where a module of JAX or the JAX package was loaded."""
    cell = run.cell
    dev = card(run.device)
    rec = driver(cell).run(run)
    rec["t0"] = run.t0
    rec["peak"] = peak_of(dev["kind"])
    bad = loaded_forbidden()
    if bad:
        print(f"loaded at the end of the run, and not allowed: {bad}", file=err, flush=True)
        return None
    metrics = read_metrics(cell, rec, run.trace)
    ok, compared = checks.judge(rec["numbers"], cell.limits)
    failed = int(rec["failed"])
    device = {"platform": dev["platform"], "kind": dev["kind"], "count": dev["count"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    line = {"correct": bool(ok and failed == 0), "attempted": int(rec["attempted"]),
            "failed": failed, "metrics": metrics, "device": device}
    if run.trace and rec.get("trace"):
        device.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    line["checks"] = compared
    least = counts.least_seconds(rec["phases"], rec["peak"]) if rec["peak"] else None
    print("[counts] " + json.dumps({"card": dev["kind"], "power_limit": dev["power_limit"],
                                    "peak": rec["peak"], "flops": counts.flops(rec["phases"]),
                                    "least_s": least, "phases": rec["phases"]}),
          file=out, flush=True)
    for note in run.log:
        print(note, file=out, flush=True)
    print(json.dumps(line), file=out, flush=True)
    for name, c in compared.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=err, flush=True)
    return line

