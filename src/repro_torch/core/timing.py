"""Per-stage wall-time accounting for the compression hot path.

``StageTimer`` is deliberately tiny: ``compress(..., stage_times=dict)``
threads one through the pipeline, each stage wraps itself in
``with tm("name"):``, and ``benchmarks/throughput.py`` serializes the
dict into ``BENCH_compress.json``. With ``sink=None`` every context is a
shared no-op, so the instrumented path costs nothing when not measuring.
"""

from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter


@contextmanager
def _noop():
    yield


class StageTimer:
    """Accumulates per-stage wall seconds into ``sink`` (None = disabled)."""

    def __init__(self, sink: dict | None):
        self.sink = sink

    def __call__(self, name: str):
        if self.sink is None:
            return _noop()
        return self._timed(name)

    @contextmanager
    def _timed(self, name: str):
        t0 = perf_counter()
        try:
            yield
        finally:
            self.sink[name] = self.sink.get(name, 0.0) + perf_counter() - t0
