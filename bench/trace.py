"""The profiler's trace reduced to what the metrics read.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activity) inside a ``bench.window`` range that ends with a synchronise,
and reduces the trace: the seconds in which some operation ran on the
device (the union of the kernels', copies' and fills' intervals inside
the window), the window's length, the ten device operations that took
the most time, and the ten longest idle stretches of the device summed
by what the host was doing then (the innermost host operation open at
the middle of each gap, CUDA runtime calls skipped for the operation
that made them).
"""

from __future__ import annotations

import torch

WINDOW = "bench.window"


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events) -> dict:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``);
    {} where the trace holds no ``bench.window``."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
    if not win:
        return {}
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    dev, host = [], []
    for e in events:
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("bench.") or t <= s:
                continue
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t, name))
        elif name != WINDOW and t > s:
            host.append((s, t, name))
    busy = _merge((s, t) for s, t, _ in dev)
    busy_ns = sum(t - s for s, t in busy)
    by_op: dict[str, int] = {}
    for s, t, name in dev:
        by_op[name] = by_op.get(name, 0) + (t - s)
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    host.sort()
    idle: dict[str, int] = {}
    open_, k = [], 0
    for g0, g1 in gaps:  # in time order, as the host's operations
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            if not host[k][2].startswith("cuda"):  # a runtime call names its operation
                open_.append(host[k])
            k += 1
        open_ = [h for h in open_ if h[1] >= mid]
        # the innermost open operation is the latest-starting one
        inner = max(open_)[2] if open_ else "host between operations"
        idle[inner] = idle.get(inner, 0) + (g1 - g0)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9, "device_ops_n": len(dev),
            "device_ops": [[n[:160], ns / 1e9] for n, ns in top],
            "idle_gaps": [[n[:160], ns / 1e9] for n, ns in gaps_top]}


def profiled(fn, device: torch.device) -> tuple[object, dict]:
    """(``fn()``'s result, the reduced trace) with ``fn`` run once under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
    return out, reduce(prof.profiler.kineto_results.events())
