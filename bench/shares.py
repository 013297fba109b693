"""Shares of the chip's peak and of the device's time, shared by the
``.train`` and ``.serve`` readers of ``metrics/``. Each returns None
where the run gives nothing to read: another kind of cell, no trace, no
device time, or a card with no row in ``peaks.json``."""

from __future__ import annotations

from . import counts


def mfu(rec: dict, kind: str):
    """Model FLOPs of the window's steps (or batches) over its seconds,
    as a percentage of the bf16 peak."""
    if rec["kind"] != kind or rec["peak"] is None:
        return None
    n = rec["steps"] if kind == "train" else rec["batches"]
    return 100.0 * counts.flops(rec["phases"]) * n / rec["window_s"] / rec["peak"]["bf16_flop_s"]


def roofline(rec: dict, kind: str):
    """The least time of the profiled steps' counted work over the time
    some operation ran on the device, as a percentage."""
    t = rec.get("trace")
    if rec["kind"] != kind or rec["peak"] is None or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * counts.least_seconds(rec["phases"], rec["peak"]) * t["steps"] / t["busy_s"]


def idle(rec: dict, kind: str):
    """The share of the profiled window in which no operation ran on the
    device, as a percentage."""
    t = rec.get("trace")
    if rec["kind"] != kind or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
