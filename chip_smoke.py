#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
2. hold each kernel against its plain torch version on the card, on
   edge-case inputs, with ``torch.equal`` (integer outputs: tolerance 0);
3. the main path at real size: 1,000,000 HDFS lines (loggen, seed 42)
   through ``compress`` on the card (level 3, gzip, typed columns,
   integrity) and back through ``decompress``; both kernels must have
   been launched. The throughput comes from this run, with nothing
   measuring inside it. A second compress of the same lines runs under
   ``torch.profiler`` for each kernel's device time and the device's idle
   share, and keeps the largest input each kernel was given. Both
   archives must equal the port's ``device="cpu"`` archive byte for byte;
4. the golden LZJF fixtures of ``tests/fixtures`` (HDFS, 400 lines, seed
   42): the container inside each archive built on the card must equal
   the fixture's (containers, not gzip streams, since zlib builds differ);
5. time each kernel (device time, from a CUDA graph of launches) and its
   plain version on the largest input the main path gave it, and print
   the ``kernels`` line and the result line.

It imports torch, numpy, the standard library and ``repro_torch`` only.
It exits non-zero, printing no result, when there is no CUDA device or
when it is not run from a checkout that holds ``src/repro_torch``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_LINES = 1_000_000
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# 32-bit integer rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock,
# one operation per lane per clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def device_us(prof) -> dict[str, tuple[int, float]]:
    """{event name: (count, device microseconds)} of a CUDA-only profile."""
    return {e.key: (e.count, e.device_time_total) for e in prof.key_averages()
            if e.device_time_total > 0}


def kernel_device_ms(torch, fn, args, reps: int) -> float:
    """Device time of one kernel launch, without the wrapper's host work:
    ``reps`` calls captured in one CUDA graph, whose replay runs the
    launches back to back, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def matcher_steps(torch, logs, lens, templates, t_lens) -> int:
    """DP steps the matcher kernel runs on these inputs, summed over its
    (line, template) pairs. A pair of a line with ``len <= T`` and a
    template with ``t_len >= 0`` runs step ``j < min(t_len, Tt)`` while its
    column, cut to bits ``<= len``, still holds a bit; other pairs run
    none (``csrc/wildcard_match.cu``)."""
    n, t = logs.shape
    k, tt = templates.shape
    pos = torch.arange(t + 1, device=logs.device)
    rows = max(1, (1 << 24) // max(1, k * (t + 1)))
    total = 0
    for s in range(0, n, rows):
        lg, ln = logs[s:s + rows], lens[s:s + rows]
        cut = (pos[None, :] <= ln.clamp(min=0)[:, None])[:, None, :]
        runs = (ln <= t)[:, None] & (t_lens >= 0)[None, :]
        col = (pos == 0).expand(lg.shape[0], k, t + 1).clone()
        for j in range(tt):
            total += int((runs & (j < t_lens)[None, :] & col.any(dim=2)).sum())
            tj = templates[:, j]
            first = col.to(torch.uint8).argmax(dim=2, keepdim=True)
            star = (pos > first) & col.any(dim=2, keepdim=True)
            lit = torch.zeros_like(col)
            lit[:, :, 1:] = col[:, :, :-1] & (lg[:, None, :] == tj[None, :, None])
            col = torch.where((tj == 1)[None, :, None], star, lit) & cut
    return total


def time_ms(torch, fn, args, reps: int) -> float:
    """Host-to-host time of one call (CUDA events around ``reps`` calls)."""
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ phase 2 inputs

def wildcard_cases(np):
    """(name, logs, lens, templates, t_lens) edge cases for the matcher."""
    rng = np.random.default_rng(7)
    cases = []
    for n, t, k, tt in [(4099, 128, 37, 128), (1000, 128, 9, 64), (2311, 12, 225, 9),
                        (777, 31, 13, 40), (555, 32, 11, 33), (333, 63, 7, 64),
                        (257, 64, 5, 65), (129, 65, 3, 160), (0, 5, 3, 4), (5, 5, 0, 4)]:
        vocab = 6  # ids 2..7: literals hit often
        logs = rng.integers(2, 2 + vocab, (n, t)).astype(np.int32)
        lens = rng.integers(0, t + 1, (n,)).astype(np.int32)
        tmpl = rng.integers(2, 2 + vocab, (k, tt)).astype(np.int32)
        tmpl[rng.random((k, tt)) < 0.3] = 1
        t_lens = rng.integers(1, tt + 1, (k,)).astype(np.int32)
        t_lens[1::2] = np.minimum(t_lens[1::2], max(1, t // 3))  # some fit the grid
        for r in range(k):  # stars at the first, last and adjacent slots
            if r % 3 == 0:
                tmpl[r, 0] = 1
            if r % 3 == 1:
                tmpl[r, t_lens[r] - 1] = 1
            if r % 3 == 2 and t_lens[r] >= 3:
                tmpl[r, 1:3] = 1
        t_lens[::5] = -1                                # matches-nothing sentinel
        for r in range(min(n, 3 * k)):                  # planted matches
            src = r % k
            row = []
            for j in range(max(int(t_lens[src]), 0)):
                tok = int(tmpl[src, j])
                row += [int(rng.integers(2, 2 + vocab))] * int(rng.integers(1, 4)) \
                    if tok == 1 else [tok]
            if len(row) <= t:
                logs[r, :len(row)] = row
                lens[r] = len(row)
        if n:
            lens[rng.random(n) < 0.05] = t + 3          # longer than the grid
        cases.append((f"N={n} T={t} K={k} Tt={tt}", logs, lens, tmpl, t_lens))
    return cases


def colcodec_cases(np):
    rng = np.random.default_rng(11)
    cases = []
    for r, c in [(1, 1), (3, 2), (8, 127), (9, 128), (5, 129), (4, 4096), (1, 1_000_000),
                 (3, 1_000_000)]:
        lim = 1 << 28
        vals = rng.integers(-lim + 1, lim, (r, c)).astype(np.int32)
        vals[:, ::3] = np.where(rng.random((r, len(range(0, c, 3)))) < 0.5, lim - 1, -lim + 1)
        lens = rng.integers(0, c + 1, (r,)).astype(np.int32)
        lens[0] = c
        mode = (np.arange(r) % 3 + 1).astype(np.int32)
        ref = np.where(mode == 3, vals.min(axis=1), 0).astype(np.int32)
        cases.append((f"R={r} C={c}", vals, lens, mode, ref))
    return cases


# ------------------------------------------------------------------- phases

def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA "
              "device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.codec import LogzipConfig, compress, decompress
    from repro_torch.core.ise import ISEConfig
    from repro_torch.data.loggen import DATASETS, generate_lines
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import colcodec as cc
    from repro_torch.kernels import wildcard_match as wm

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1: build
    t0 = time.perf_counter()
    build_logs = build.build(build.SOURCES)
    build_s = time.perf_counter() - t0
    log(f"[build] {len(build_logs)} of {len(build.SOURCES)} sources compiled in {build_s:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 2: kernels against their plain versions on the card
    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mism = {"wildcard_match": 0, "colcodec_transform": 0}
    for name, *arrs in wildcard_cases(np):
        args = [on(a) for a in arrs]
        got = wm.wildcard_match(*args)
        want = wm.wildcard_match_plain(*args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mism["wildcard_match"] += bad + (not torch.equal(got, want))
        log(f"[check] wildcard_match {name}: {bad} mismatches, {int(want.sum())} matches")
    for name, *arrs in colcodec_cases(np):
        args = [on(a) for a in arrs]
        # uint32 has few CUDA operators: compare the values as int64
        got = cc.colcodec_transform(*args).to(torch.int64)
        want = cc.colcodec_transform_plain(*args).to(torch.int64)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mism["colcodec_transform"] += bad + (not torch.equal(got, want))
        log(f"[check] colcodec_transform {name}: {bad} mismatches")
    log(f"[check] mismatches per kernel: {json.dumps(mism)}")
    if any(mism.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {mism}")

    # -- 3: the main path at real size
    t0 = time.perf_counter()
    lines = list(generate_lines("HDFS", N_LINES, seed=SEED))
    raw_bytes = sum(len(l.encode("utf-8", "surrogateescape")) + 1 for l in lines)
    log(f"[main] {len(lines)} HDFS lines, {raw_bytes / 1e6:.1f} MB, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    fmt = DATASETS["HDFS"]["format"]
    cfg = LogzipConfig(format=fmt, device="cuda")
    stages: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    blob = compress(lines, cfg, stage_times=stages)
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if not all(counts[k] > 0 for k in ("wildcard_match", "colcodec_transform")):
        raise AssertionError(f"the main path skipped a kernel: {counts}")
    t0 = time.perf_counter()
    back = decompress(blob)
    dec_s = time.perf_counter() - t0
    if back != lines:
        raise AssertionError("decompress(compress(lines)) != lines on the card")
    log(f"[main] compress {comp_s:.2f} s: {N_LINES / comp_s:.0f} lines/s, "
        f"{raw_bytes / 1e6 / comp_s:.2f} MB/s, ratio {raw_bytes / len(blob):.3f} "
        f"({len(blob)} bytes); decompress {dec_s:.2f} s")
    log(f"[main] stage seconds: {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"[main] launches: {json.dumps(counts)}")

    # the same compress under the profiler, keeping each kernel's largest input
    largest: dict[str, tuple[int, tuple]] = {}

    def keep_largest(name, args):
        size = sum(a.numel() for a in args)
        if size > largest.get(name, (-1,))[0]:
            largest[name] = (size, args)

    kernel_names = {"wildcard_match": "wildcard_match_kernel",
                    "colcodec_transform": "colcodec_kernel"}
    ops.reset_launch_counts()
    ops.input_hook = keep_largest
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_blob = compress(lines, cfg)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    finally:
        ops.input_hook = None
    if prof_blob != blob or ops.launch_counts() != counts:
        raise AssertionError("a second compress of the same lines gave another archive or "
                             f"other launches: {ops.launch_counts()} vs {counts}")
    busy = device_us(prof)
    device_ms = {k: sum(us for name, (_, us) in busy.items() if kn in name) / 1e3
                 for k, kn in kernel_names.items()}
    busy_ms = sum(us for _, us in busy.values()) / 1e3
    seen = {k: sum(c for name, (c, _) in busy.items() if kn in name)
            for k, kn in kernel_names.items()}
    if seen != counts:
        log(f"[profile] the profiler saw {seen} launches of {counts}: its device ms undercount")
    log(f"[profile] compress {prof_s:.2f} s under the profiler; kernel device ms: "
        f"{json.dumps({k: round(v, 3) for k, v in device_ms.items()})}")
    log(f"[profile] device busy {busy_ms:.3f} ms of {prof_s * 1e3:.1f} ms compress wall "
        f"(idle share {1 - busy_ms / (prof_s * 1e3):.6f}); by activity: "
        f"{json.dumps({k[:48]: [c, round(us / 1e3, 3)] for k, (c, us) in busy.items()})}")
    t0 = time.perf_counter()
    cpu_blob = compress(lines, LogzipConfig(format=fmt, device="cpu"))
    log(f"[main] device='cpu' archive in {time.perf_counter() - t0:.2f} s")
    if cpu_blob != blob:
        raise AssertionError("the card's archive differs from the device='cpu' archive")
    log("[main] archive byte-identical to the device='cpu' archive")

    # -- 4: golden containers (recipe of tests/fixture_defs.py)
    gold_lines = list(generate_lines("HDFS", 400, seed=42))
    for ext, typed, integ in (("lzjf", False, False), ("v2.lzjf", True, False),
                              ("v3.lzjf", True, True)):
        cfg = LogzipConfig(level=3, kernel="gzip", format=fmt, device="cuda",
                           ise=ISEConfig(min_sample=100, max_iters=3, seed=0),
                           typed_columns=typed, integrity=integ)
        got = compress(gold_lines, cfg)
        gold = (ROOT / "tests" / "fixtures" / f"hdfs_400.{ext}").read_bytes()
        tail = 4 if integ else 0
        if got[:6] != gold[:6] or zlib.decompress(got[6:len(got) - tail]) != \
                zlib.decompress(gold[6:len(gold) - tail]):
            raise AssertionError(f"container differs from tests/fixtures/hdfs_400.{ext}")
        log(f"[golden] hdfs_400.{ext}: container identical")

    # -- 5: each kernel at the largest input the main path gave it
    rows = []
    for name, kernel, plain, src, replaces in (
            ("wildcard_match", wm.wildcard_match, wm.wildcard_match_plain,
             "src/repro_torch/csrc/wildcard_match.cu", "src/repro/kernels/wildcard_match.py:103"),
            ("colcodec_transform", cc.colcodec_transform, cc.colcodec_transform_plain,
             "src/repro_torch/csrc/colcodec.cu", "src/repro/kernels/colcodec.py:85")):
        args = largest[name][1]
        got, want = kernel(*args), plain(*args)
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0.0
        ms = kernel_device_ms(torch, kernel, args, 20)
        plain_ms = time_ms(torch, plain, args, 3)
        if name == "wildcard_match":
            (n, t), (k, tt) = args[0].shape, args[2].shape
            steps = matcher_steps(torch, *args)
            nbytes = 4 * (n * t + n + k * tt + k) + n * k
            # one operation per column word per step run
            nops = steps * ((t + 32) // 32)
            shape = f"N={n} T={t} K={k} Tt={tt}"
            work = f"{steps} DP steps over {n * k} pairs"
        else:
            r, c = args[0].shape
            # two differences, the zigzag's shift and xor per element
            nbytes, nops = 8 * r * c + 12 * r, 4 * r * c
            shape = f"R={r} C={c}"
            work = f"{r * c} elements"
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT32_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None, "shape": shape, "bytes": nbytes, "operations": nops,
                     "main_path_device_ms": device_ms[name]})
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version on {shape}")
        log(f"[bench] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: "
            f"{nbytes} bytes {bytes_ms:.6f} ms, {nops} int32 operations ({work}) "
            f"{ops_ms:.6f} ms")

    log(f"[card] {card}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
