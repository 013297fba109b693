"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the tests: the same files, driver, readers and limits, the model cut by
its reference's ``tiny`` (a few layers, narrow, computed in fp32, so
that a sound run agrees with the reference to rounding, far inside
limits set for bf16 at full size) and the traffic by its driver's
``tiny`` (a few short batches)."""

from __future__ import annotations

import io
import sys
import time

import torch

from . import harness, references


def cell(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    c.config = references.of(c.config).tiny(c.config)
    c.traffic = harness.driver(c).tiny(c.traffic)
    return c


def run(name: str, seed: int = 2**31 + 7, trace: bool = False, seconds: float = 0.5):
    """(the result line or None, what the run printed on stdout). The
    modules of JAX and of the JAX package that other tests in this process
    loaded are hidden from the run's guard while it runs, so that the
    guard sees what the run itself loads, as in a process of its own."""
    r = harness.Run(cell=cell(name), seed=seed, seconds=seconds, trace=trace,
                    device=torch.device("cpu"), t0=time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    hidden = {m: sys.modules.pop(m) for m in list(sys.modules)
              if m.split(".")[0] in harness.FORBIDDEN}
    try:
        line = harness.execute(r, out=out, err=err)
    finally:
        sys.modules.update(hidden)
    return line, out.getvalue()
