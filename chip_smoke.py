#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. print the card's name and power limit; build the seven CUDA kernels
   from the six sources of ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
2. hold each kernel against its plain torch version on the card, on
   edge-case inputs, with ``torch.equal`` (integer outputs: tolerance 0);
   ``distinct_counts`` also on inputs one row past a 16-byte boundary;
3. the main path at real size: 1,000,000 HDFS lines (loggen, seed 42)
   through ``compress`` on the card (level 3, gzip, typed columns,
   integrity) and back through ``decompress``; ``wildcard_match_first``
   (every ``match_first``) and ``colcodec_transform`` must have been
   launched, the (N, K) ``wildcard_match`` never. The throughput comes
   from this run, with nothing measuring inside it. A second compress of
   the same lines runs under ``torch.profiler`` for each kernel's device
   time, the copies' and the device's idle share, and keeps the largest
   input each kernel was given and every first-hit call. Both archives
   must equal the port's ``device="cpu"`` archive byte for byte;
4. the golden LZJF fixtures of ``tests/fixtures`` (HDFS, 400 lines, seed
   42): the container inside each archive built on the card must equal
   the fixture's (containers, not gzip streams, since zlib builds differ);
5. the ops-layer device path at real size: 1,000,000 Spark lines
   (loggen, seed 3, the contents after ``": "``) through
   ``ops.device_encode_batch`` (``tokenize_hash``), ISE on the first
   4,000 rows (``wildcard_match_first``), ``ops.match_extract`` over every row
   and ``ops.simcount`` over the first 65,536 rows, on the card under
   ``torch.profiler``; the three kernels must have been launched. Then
   the host paths check it: ids, lengths and vocabulary equal
   ``Vocab.encode_batch`` over ``tokenize``; ``assign`` equals the numpy
   ``match_first`` and the spans ``extract_spans``; φ equals
   ``common_token_count``;
6. the streaming containers and the query path at real size, on the
   1,000,000 HDFS lines of phase 3: a ``StreamingCompressor`` session on
   the card (LZJS v3 with screens, 8,192-line chunks) and
   ``compress_parallel`` over four spawned workers on the card (LZJM of
   the first 500,000 lines, a chunk per worker), each equal byte for byte
   to its ``device="cpu"``
   twin and decompressing to the lines; then on the LZJF of phase 3, the
   LZJM and the LZJS, ``count_by_template``, ``top_k`` of two header
   fields and of one parameter column and ``time_histogram`` on the card
   under ``torch.profiler`` (``distinct_counts`` must have been
   launched, with no fill or memset beside it), each equal to its
   ``device="cpu"`` result and the header fields' to a plain count over
   the parsed lines; and ``search`` / ``count`` predicates on the LZJS
   equal to a plain grep;
7. time the card's empty-launch floor (a one-element ``fill_``) and each
   kernel (device time, from a CUDA graph of launches) and its plain
   version on the largest input the main paths gave it (the (N, K)
   ``wildcard_match`` on the largest first-token bucket of phase 3's
   first-hit calls); ``distinct_counts`` also at two LZJF inputs and at
   the full LZJS chunks with the fewest and the most bins, each against
   ``index_add_``; ``colcodec_transform`` also at the session's largest
   input, times its launches; time ``ops.match_first_bucketed`` end to
   end against the per-bucket composition it replaced, and print the
   ``kernels`` line and the result line.

It imports torch, numpy, the standard library and ``repro_torch`` only.
It exits non-zero, printing no result, when there is no CUDA device or
when it is not run from a checkout that holds ``src/repro_torch``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_LINES = 1_000_000
SEED = 42
OPS_LINES = 1_000_000  # the ops-layer phase: Spark, loggen seed 3
OPS_SEED = 3
SIMCOUNT_ROWS = 65_536
STREAM_CHUNK_LINES = 8192  # StreamingCompressor's default chunk
LZJM_WORKERS = 4
# the LZJM takes the first half of the lines, a chunk per worker: with all
# 1,000,000 the script ran 711-800 s of its 1200 s on slower hosts
LZJM_LINES = 500_000
LZJM_CHUNK_LINES = LZJM_LINES // LZJM_WORKERS
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


def dp_steps(torch, logs, at, runs, templates, t_lens) -> int:
    """DP steps a matcher kernel runs on these inputs, summed over the
    (line, template) pairs where ``runs`` (N, K) holds: a pair runs step
    ``j < min(t_len, Tt)`` while its column, cut to bits ``<= at[n]``,
    still holds a bit (``csrc/wildcard_match.cu``, ``csrc/match_extract.cu``)."""
    n, t = logs.shape
    k, tt = templates.shape
    pos = torch.arange(t + 1, device=logs.device)
    rows = max(1, (1 << 24) // max(1, k * (t + 1)))
    total = 0
    for s in range(0, n, rows):
        lg, run = logs[s:s + rows], runs[s:s + rows]
        cut = (pos[None, :] <= at[s:s + rows, None])[:, None, :]
        col = (pos == 0).expand(lg.shape[0], k, t + 1).clone()
        for j in range(tt):
            total += int((run & (j < t_lens)[None, :] & col.any(dim=2)).sum())
            tj = templates[:, j]
            first = col.to(torch.uint8).argmax(dim=2, keepdim=True)
            star = (pos > first) & col.any(dim=2, keepdim=True)
            lit = torch.zeros_like(col)
            lit[:, :, 1:] = col[:, :, :-1] & (lg[:, None, :] == tj[None, :, None])
            col = torch.where((tj == 1)[None, :, None], star, lit) & cut
    return total


def token_bytes(torch, lens, width) -> int:
    """Bytes of the tokens a matcher must read from a padded grid: the
    first ``len`` of each row with ``0 <= len <= width``; a row wider than
    the grid matches nothing and is never read, the padding never."""
    return 4 * int(torch.where(lens <= width, lens.clamp(min=0), 0).sum())


def matcher_steps(torch, logs, lens, templates, t_lens) -> int:
    """DP steps of the wildcard_match kernel: every pair of a line with
    ``len <= T`` and a template with ``t_len >= 0``, read at ``len``."""
    runs = (lens <= logs.shape[1])[:, None] & (t_lens >= 0)[None, :]
    return dp_steps(torch, logs, lens.clamp(min=0), runs, templates, t_lens)


def first_hit_steps(torch, logs, lens, templates, t_lens, line_bucket, bucket_ptr, bucket_tpl,
                    star_tpl, assign) -> int:
    """DP steps the first-hit function needs: each line with ``len <= T``,
    read at ``max(len, 0)``, runs its candidates (its bucket's templates
    and the star-first ones) in ascending id up to its first hit, all of
    them where it has none. The steps a 32-wide group of the kernel runs
    past the hit are the design's cost, not the function's."""
    n, k = logs.shape[0], templates.shape[0]
    dev = logs.device
    sizes = (bucket_ptr[1:] - bucket_ptr[:-1]).to(torch.int64)
    tpl_bucket = torch.full((k,), -2, dtype=torch.int64, device=dev)
    tpl_bucket[bucket_tpl.to(torch.int64)] = torch.repeat_interleave(
        torch.arange(sizes.numel(), device=dev), sizes)
    is_star = torch.zeros(k, dtype=torch.bool, device=dev)
    is_star[star_tpl.to(torch.int64)] = True
    a = assign.to(torch.int64)
    last = torch.where(a >= 0, a, k - 1)
    kidx = torch.arange(k, device=dev)
    runs = (((tpl_bucket[None, :] == line_bucket.to(torch.int64)[:, None]) | is_star[None, :])
            & (kidx[None, :] <= last[:, None]) & (lens <= logs.shape[1])[:, None]
            & (t_lens >= 0)[None, :])
    return dp_steps(torch, logs, lens.clamp(min=0), runs, templates, t_lens)


def largest_bucket(torch, calls):
    """The largest single first-token bucket (or the star-first list over
    every line) of these ``wildcard_match_first`` calls, as the (N, K)
    kernel's input: (logs, lens, templates cut to the bucket's widest,
    t_lens), the bucket largest by the elements of those four."""
    best, best_size = None, -1
    for logs, lens, templates, t_lens, line_bucket, ptr, tpl, star in calls:
        n, t = logs.shape
        p = ptr.tolist()
        lists = [(line_bucket == b, tpl[p[b]:p[b + 1]]) for b in range(len(p) - 1)]
        lists.append((torch.ones(n, dtype=torch.bool, device=logs.device), star))
        for rows, ids in lists:
            nb, kb = int(rows.sum()), ids.numel()
            if not (nb and kb):
                continue
            ids = ids.to(torch.int64)
            tt = max(1, int(t_lens[ids].max()))
            size = nb * t + nb + kb * tt + kb
            if size > best_size:
                best_size = size
                best = (logs[rows].contiguous(), lens[rows].contiguous(),
                        templates[ids, :tt].contiguous(), t_lens[ids].contiguous())
    return best


def match_first_per_bucket(np, ops, ids, lens, templates, device):
    """The composition that ``ops.match_first_bucketed`` replaced, kept
    here only to measure against: for each first-token bucket (and the
    star-first list over every line), the lines gathered on the host, one
    (N, K) ``wildcard_match`` launch, the matrix copied back, then any /
    argmax / min on the host."""
    n, n_tpl = ids.shape[0], len(templates)
    best = np.full((n,), n_tpl, np.int64)
    buckets, star = {}, []
    for k, tpl in enumerate(templates):
        if len(tpl):
            (star if int(tpl[0]) == 1 else buckets.setdefault(int(tpl[0]), [])).append(k)

    def run(sel, tidx):
        sub = ops.wildcard_match_host(ids[sel], lens[sel], [templates[k] for k in tidx],
                                      device=device)
        any_m = sub.any(axis=1)
        cand = np.asarray(tidx, np.int64)[sub.argmax(axis=1)]
        best[sel[any_m]] = np.minimum(best[sel[any_m]], cand[any_m])

    first = ids[:, 0] if ids.shape[1] else np.zeros((n,), np.int32)
    for f, tidx in buckets.items():
        sel = np.nonzero(first == f)[0]
        if len(sel):
            run(sel, tidx)
    if star:
        run(np.arange(n), star)
    return np.where(best < n_tpl, best, -1).astype(np.int32)


def extract_steps(torch, logs, lens, templates, t_lens, assign) -> int:
    """DP steps of the match_extract kernel: each line, read at
    ``min(len, T)``, runs the templates in ascending id up to its assigned
    one (all of them when it has none), and the assigned template's walk
    back one step a token."""
    k, tt = templates.shape
    at = lens.clamp(max=logs.shape[1])
    a = assign.to(torch.int64)
    last = torch.where(a >= 0, a, k - 1)
    kidx = torch.arange(k, device=logs.device)
    runs = (at >= 0)[:, None] & (t_lens >= 0)[None, :] & (kidx[None, :] <= last[:, None])
    walk = t_lens.clamp(min=0, max=tt).to(torch.int64)[a[a >= 0]].sum()
    return dp_steps(torch, logs, at, runs, templates, t_lens) + int(walk)


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
                        (257, 64, 5, 65), (129, 65, 3, 160), (60, 255, 9, 100), (0, 5, 3, 4),
                        (5, 5, 0, 4)]:
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


def first_hit_cases(np, ops):
    """(name, logs, lens, templates, t_lens, line_bucket, bucket_ptr,
    bucket_tpl, star_tpl) cases for the first-hit matcher, its tables
    built by ``ops.bucket_tables``: first hits in candidate groups 1-3 and
    star ids that beat a bucket hit; random grids over a small vocabulary
    at T around the 32-bit column words up to 255, with lines of length
    0, T and T+1 and negative, lines whose first token has no bucket, a
    bucket no line starts with, ``t_len < 0``; a star-only list; N = 0, no
    templates, empty templates only."""
    rng = np.random.default_rng(29)
    cases = []

    def add(name, logs, lens, templates, negative=0):
        tmpl, tlens = ops.pack_templates(templates)
        tables = ops.bucket_tables(logs, tmpl, tlens)
        tlens[rng.permutation(len(tlens))[:negative]] = -1
        cases.append((name, logs, lens, tmpl, tlens, *tables))

    # one bucket of literal-first [2, 10 + id] with star-first ids 45, 70, 80
    tpls = [np.array([1, 60] if i == 45 else [1, 110] if i == 70 else [1, 1, 15] if i == 80
                     else [2, 10 + i], np.int32) for i in range(121)]
    tpls.append(np.array([9, 1], np.int32))                       # a bucket with no line
    rows = [[2, 10 + p] for p in (0, 5, 31, 32, 40, 63, 64, 69, 71, 99, 120, 300)]
    rows += [[2, 60], [2, 110], [7, 15], [7, 60], [2, 15], [2]] * 50
    logs = np.zeros((len(rows), 3), np.int32)
    lens = np.array([len(r) for r in rows], np.int32)
    for r, row in enumerate(rows):
        logs[r, :len(row)] = row
    add("groups 1-3, star beats bucket", logs, lens, tpls)

    for n, t, k, star_share in [(4000, 12, 700, 0.05), (3000, 31, 300, 0.2),
                                (3000, 32, 300, 0.2), (2000, 63, 200, 0.3),
                                (2000, 64, 200, 0.3), (1000, 127, 150, 0.3),
                                (1000, 128, 150, 0.3), (500, 255, 100, 0.3),
                                (1500, 20, 120, 1.0)]:
        vocab = 4  # template ids 2..5; lines also start with 6 and 7 (no bucket)
        tpls = []
        for _ in range(k):
            m = int(rng.integers(3, 9))
            tp = rng.integers(2, 2 + vocab, m).astype(np.int32)
            tp[rng.random(m) < 0.2] = 1
            tp[0] = 1 if rng.random() < star_share else rng.integers(2, 2 + vocab)
            tpls.append(tp)
        logs = rng.integers(2, 4 + vocab, (n, t)).astype(np.int32)
        lens = rng.integers(0, t + 2, n).astype(np.int32)
        for r in range(0, n, 2):                                  # planted matches
            row = []
            for tok in tpls[int(rng.integers(0, k))]:
                row += rng.integers(2, 2 + vocab, int(rng.integers(1, max(2, t // 3)))).tolist() \
                    if tok == 1 else [int(tok)]
            if len(row) <= t:
                logs[r, :len(row)] = row
                lens[r] = len(row)
        lens[:4] = [0, t, t + 1, -1]
        for r in range(n):
            logs[r, max(0, min(int(lens[r]), t)):] = 0
        name = "star-only" if star_share == 1.0 else "mixed"
        add(f"N={n} T={t} K={k} {name}", logs, lens, tpls, negative=k // 20)
    logs = rng.integers(2, 6, (9, 5)).astype(np.int32)
    lens = np.full(9, 5, np.int32)
    add("N=0", logs[:0], lens[:0], [np.array([2, 1], np.int32)])
    add("K=0", logs, lens, [])
    add("empty templates only", logs, lens, [np.zeros(0, np.int32)] * 3)
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


def tokenize_cases(np):
    """(name, blocks, lens) byte grids: empty rows, rows of delimiters
    only, lengths past B; widths whose tile of whole rows is a multiple
    of 16 bytes (1, 63, 125) and is not (64, 65, 300, 1001),
    a row that just fits a 2,048-byte chunk with its lead (2033), rows
    walked in two and three chunks (2034, 4097, 6000), row counts that
    leave a partial last tile, and N = 0."""
    rng = np.random.default_rng(13)
    delims = np.frombuffer(b" \t,;:=", np.uint8)
    other = np.array([b for b in range(1, 256) if b not in delims], np.uint8)
    cases = []
    for n, b in [(2000, 1), (2000, 63), (2000, 64), (2001, 65), (2003, 125), (777, 300),
                 (51, 1001), (40, 2033), (30, 2034), (300, 4097), (9, 6000), (0, 5)]:
        blocks = np.where(rng.random((n, b)) < 1 / 3, rng.choice(delims, (n, b)),
                          rng.choice(other, (n, b))).astype(np.uint8)
        lens = rng.integers(0, b + 3, (n,)).astype(np.int32)
        lens[::7] = 0                                   # empty rows
        blocks[3::7] = rng.choice(delims, blocks[3::7].shape)  # delimiters only
        lens[3::7] = b
        for r in range(n):
            blocks[r, min(int(lens[r]), b):] = 0
        cases.append((f"N={n} B={b}", blocks, lens))
    return cases


def simcount_cases(np):
    """(name, logs, templates) token grids: T around the 32-position word,
    all-PAD rows, K = 0, N = 0, a wide template tile; phase 5's shape (N =
    65,536, T = 16, K = 18, Tt = 15); K = 33 and 65 (two and three tiles
    of 32 templates); Tt = 1024 (MAX_TT: a tile of 4 templates fills the
    token table), its ids spread over all of int32 so that they collide
    in the table; templates that repeat a token; ids near 2**31 - 1 and
    negative."""
    rng = np.random.default_rng(17)
    cases = []
    for n, t, k, tt in [(3000, 31, 40, 31), (3000, 32, 33, 32), (3000, 33, 31, 33),
                        (2000, 128, 70, 128), (100, 16, 0, 5), (0, 8, 5, 5),
                        (500, 12, 9, 400), (65_536, 16, 18, 15), (3000, 16, 33, 15),
                        (3000, 20, 65, 12)]:
        logs = rng.integers(0, 12, (n, t)).astype(np.int32)
        for r, ln in enumerate(rng.integers(0, t + 1, (n,))):
            logs[r, ln:] = 0
        logs[::9] = 0                                   # all-PAD rows
        tmpl = rng.integers(0, 12, (k, tt)).astype(np.int32)
        cases.append((f"N={n} T={t} K={k} Tt={tt}", logs, tmpl))
    for n, t, k in [(2000, 40, 9), (1000, 16, 70)]:
        tmpl = rng.integers(-2**31, 2**31, (k, 1024), dtype=np.int64).astype(np.int32)
        tmpl[rng.random(tmpl.shape) < 0.05] = 1
        tmpl[:, 900:] = 0                               # PAD tails
        pool = np.concatenate([tmpl.ravel(), rng.integers(-2**31, 2**31, 4096).astype(np.int32)])
        logs = rng.choice(pool, (n, t)).astype(np.int32)
        cases.append((f"N={n} T={t} K={k} Tt=1024 ids over int32", logs, tmpl))
    extreme = np.array([2**31 - 1, 2**31 - 2, -2**31, -2**31 + 1, -1, -7, 2, 0, 1], np.int32)
    logs = rng.choice(extreme, (3000, 24)).astype(np.int32)
    tmpl = rng.choice(extreme, (40, 10)).astype(np.int32)
    tmpl[::3] = tmpl[::3, :1]                           # one token repeated over the row
    tmpl[1::3, 5:] = tmpl[1::3, :5]                     # the first half again
    cases.append(("N=3000 T=24 K=40 Tt=10 ids near 2**31 - 1 and negative, repeats", logs, tmpl))
    return cases


def match_extract_cases(np):
    """(name, logs, lens, templates, t_lens, n_slots) edge cases: all-star
    and zero-length templates, the over-length sentinel, len > T and
    negative lengths, T = 128 with Tt = 129, K = 0, N = 0; T at 32W - 1,
    32W and 32W + 1 for every column width W up to T = 255; line counts
    that leave a partial last tile; more templates than one shared-memory
    stage holds (32); fewer slots than the templates' stars."""
    rng = np.random.default_rng(19)
    cases = []
    shapes = [(3000, 16, 18, 15, None), (2000, 128, 9, 129, None), (1500, 31, 12, 40, None),
              (500, 5, 6, 4, None), (0, 5, 3, 4, None), (20, 5, 0, 1, None),
              (3001, 16, 300, 12, None), (1001, 64, 100, 65, None), (1500, 20, 30, 12, 2),
              (700, 40, 12, 30, 1)]
    shapes += [(301, t, 6, 2 * t // 3, None)
               for t in [32 * w + d for w in range(1, 9) for d in (-1, 0, 1)] if t <= 255]
    for n, t, k, tt, slots in shapes:
        vocab = 5
        logs = rng.integers(2, 2 + vocab, (n, t)).astype(np.int32)
        lens = rng.integers(-1, t + 3, (n,)).astype(np.int32)
        tmpl = rng.integers(2, 2 + vocab, (k, tt)).astype(np.int32)
        tmpl[rng.random((k, tt)) < 0.4] = 1
        t_lens = rng.integers(0, tt + 1, (k,)).astype(np.int32)
        if k >= 4:
            tmpl[1] = 1                                 # all stars
            t_lens[1] = tt
            t_lens[2] = 0                               # zero-length
            t_lens[3] = -1                              # over-length sentinel
        for r in range(k):
            tmpl[r, max(int(t_lens[r]), 0):] = 0
        for r in range(0, n, 2):                        # planted matches
            src = (r // 2) % max(k, 1)
            row = []
            for j in range(max(int(t_lens[src]), 0) if k else 0):
                tok = int(tmpl[src, j])
                row += [int(rng.integers(2, 2 + vocab))] * int(rng.integers(1, 3)) \
                    if tok == 1 else [tok]
            if len(row) <= t:
                logs[r, :len(row)] = row
                lens[r] = len(row)
        for r in range(n):
            logs[r, max(0, min(int(lens[r]), t)):] = 0
        in_len = np.arange(tt)[None, :] < t_lens[:, None]
        n_slots = slots or max([1] + ((tmpl == 1) & in_len).sum(axis=1).tolist())
        cases.append((f"N={n} T={t} K={k} Tt={tt}", logs, lens, tmpl, t_lens, n_slots))
    return cases


def distinct_counts_cases(np, small_rows):
    """(name, inv, weights, n_bins): row counts around the Pallas kernel's
    8-row tile, bin counts around its 128-bin bucket and on both sides of
    the shared-memory limit (12,288 bins are 48 KB; 60,000 do not fit in
    227 KB), -1 and out-of-range rows, and weights negative and near 2**31
    so that the int32 sums wrap; an LZJS chunk's 8,192 rows over 1, 2 and
    3,999 bins; every row in one bin, the weights wrapping; row counts on
    both sides of ``small_rows``, where the launcher goes from one
    thread-block cluster to a cooperative grid."""
    rng = np.random.default_rng(23)
    near = np.array([2**31 - 1, 2**31 - 2, -2**31, -7, 3], np.int32)
    cases = []
    for n in (1, 7, 8, 9, 4097, 1_000_000):
        for n_bins in (1, 127, 128, 129, 12_288, 12_289, 60_000):
            inv = rng.integers(-1, n_bins + 3, n).astype(np.int32)
            if n > 2:
                inv[::5] = -1
                inv[1::7] = n_bins + 1
            cases.append((f"N={n} n_bins={n_bins}", inv, rng.choice(near, n), n_bins))
    for n, n_bins in [(8192, 1), (8192, 2), (8192, 3999), (small_rows - 1, 2),
                      (small_rows, 40), (small_rows + 1, 40), (small_rows + 5, 60_000),
                      (4 * small_rows + 3, 2)]:
        inv = rng.integers(-1, n_bins + 1, n).astype(np.int32)
        cases.append((f"N={n} n_bins={n_bins}", inv, rng.choice(near, n), n_bins))
    for n in (8192, 1_000_000):
        inv = np.zeros(n, np.int32)
        cases.append((f"N={n} n_bins=5 every row in bin 0", inv,
                      np.full(n, 2**31 - 3, np.int32), 5))
    return cases


# ------------------------------------------------------------------- phases

NEW_KERNELS = ("tokenize_hash", "simcount", "match_extract")
KERNEL_NAMES = {"wildcard_match": "wildcard_match_kernel",
                "wildcard_match_first": "wildcard_first_kernel", "colcodec_transform": "colcodec_kernel",
                "tokenize_hash": "tokenize_hash_kernel", "simcount": "simcount_kernel",
                "match_extract": "match_extract_kernel", "distinct_counts": "distinct_counts_"}
# why no single PyTorch call stands beside a kernel as library_ms
LIBRARY_NOTE = {
    "wildcard_match": "none: no PyTorch call runs a wildcard reachability DP",
    "wildcard_match_first": "none: no PyTorch call runs a wildcard reachability DP, nor stops "
                            "a line at its first hit",
    "colcodec_transform": "none: no PyTorch call does the per-row delta / zigzag / FoR with masks",
    "tokenize_hash": "none: no PyTorch call gives masks, starts and two weighted prefix sums "
                     "(torch.cumsum would be one of the six passes)",
    "simcount": "none: no PyTorch call counts the tokens of each line found in each template",
    "match_extract": "none: no PyTorch call runs the wildcard DP with its walk back",
    "distinct_counts": "torch.zeros(n_bins, int32).index_add_(0, inv, w): the same sums, "
                       "for an inverse index that stays in [0, n_bins) as this one does",
}


def kernel_profile(prof) -> tuple[dict, dict]:
    """({kernel: device ms}, {kernel: launches the profiler saw})."""
    busy = device_us(prof)
    ms = {k: sum(us for name, (_, us) in busy.items() if kn in name) / 1e3
          for k, kn in KERNEL_NAMES.items()}
    seen = {k: sum(c for name, (c, _) in busy.items() if kn in name)
            for k, kn in KERNEL_NAMES.items()}
    return ms, seen


@contextlib.contextmanager
def capture_largest(ops, every=None, kernel="wildcard_match_first"):
    """Inside the block, keep by kernel the largest input its wrapper was
    given (through ``ops.input_hook``) -> {kernel: args}; with ``every``, a
    list, also append to it the input of each call of ``kernel``."""
    sizes: dict[str, int] = {}
    largest: dict[str, tuple] = {}

    def keep(name, args):
        size = sum(a.numel() for a in args if hasattr(a, "numel"))
        if size > sizes.get(name, -1):
            sizes[name], largest[name] = size, args
        if every is not None and name == kernel:
            every.append(args)

    ops.input_hook = keep
    try:
        yield largest
    finally:
        ops.input_hook = None


def ops_phase(np, torch, profile, activity):
    """Phase 5: the ops-layer device path on 1M Spark lines, then its
    checks against the host paths -> (launch counts, the largest input of
    each kernel, each kernel's device ms under the profiler)."""
    from repro_torch.core.ise import ISEConfig, iterative_structure_extraction
    from repro_torch.core.lcs import common_token_count
    from repro_torch.core.match import extract_spans, match_first
    from repro_torch.core.tokenizer import Vocab, tokenize
    from repro_torch.data.loggen import generate_lines
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    contents = [line.split(": ", 1)[-1]
                for line in generate_lines("Spark", OPS_LINES, seed=OPS_SEED)]
    raw_bytes = sum(len(c.encode("utf-8", "surrogateescape")) for c in contents)
    log(f"[ops] {len(contents)} Spark contents, {raw_bytes / 1e6:.1f} MB, generated in "
        f"{time.perf_counter() - t0:.1f} s")

    stages = {}
    vocab = Vocab()
    ops.reset_launch_counts()
    with capture_largest(ops) as largest, profile(activities=[activity.CUDA]) as prof:
        t0 = time.perf_counter()
        ids, lens = ops.device_encode_batch(contents, vocab, 48, device="cuda")
        stages["device_encode_batch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = iterative_structure_extraction(ids[:4000], lens[:4000], vocab_size=len(vocab),
                                             cfg=ISEConfig(min_sample=300), device="cuda")
        templates = res.templates
        stages["ise (first 4000 rows)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assign, spans = ops.match_extract(ids, lens, templates, device="cuda")
        stages["match_extract"] = time.perf_counter() - t0
        tm, _ = ops.pack_templates(templates)
        t0 = time.perf_counter()
        phi = ops.simcount(ids[:SIMCOUNT_ROWS], tm, device="cuda")
        stages["simcount"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    device_ms, seen = kernel_profile(prof)
    log(f"[ops] grid {ids.shape}, vocab {len(vocab)}, {len(templates)} templates, "
        f"n_slots {spans.shape[1]}, {int((assign >= 0).sum())} of {len(assign)} lines matched")
    log(f"[ops] stage seconds (under torch.profiler, CUDA activity only): "
        f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"[ops] launches: {json.dumps(counts)}")
    log(f"[ops] kernel device ms: {json.dumps({k: round(v, 4) for k, v in device_ms.items()})}")
    if seen != counts:
        log(f"[ops] the profiler saw {seen} launches of {counts}: its device ms undercount")
    if not all(counts[k] > 0 for k in NEW_KERNELS):
        raise AssertionError(f"the ops-layer path skipped a kernel: {counts}")
    if counts["tokenize_hash"] != 1 or counts["match_extract"] != 1:
        raise AssertionError(f"tokenize_hash and match_extract launch once a call: {counts}")

    t0 = time.perf_counter()
    host_vocab = Vocab()
    h_ids, h_lens = host_vocab.encode_batch([tokenize(c)[0] for c in contents], 48, tight=True)
    if not (np.array_equal(ids, h_ids) and np.array_equal(lens, h_lens)
            and vocab._to_str == host_vocab._to_str):
        raise AssertionError("device_encode_batch differs from Vocab.encode_batch(tokenize)")
    log(f"[ops] ids, lens and vocabulary equal the host encode ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    h_assign = match_first(ids, lens, templates, use_kernel=False)
    if not np.array_equal(assign, h_assign):
        raise AssertionError(f"match_extract assign differs from match_first on "
                             f"{int((assign != h_assign).sum())} lines")
    hit = assign >= 0
    for g in sorted(set(assign[hit].tolist())):
        rws = np.flatnonzero(assign == g)
        sp = extract_spans(ids[rws], lens[rws], templates[g])
        if not (np.array_equal(spans[rws, :sp.shape[1]], sp)
                and not spans[rws, sp.shape[1]:].any()):
            raise AssertionError(f"match_extract spans differ from extract_spans, template {g}")
    if spans[~hit].any():
        raise AssertionError("match_extract wrote spans on lines that matched nothing")
    log(f"[ops] assign equals match_first, spans equal extract_spans "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    h_phi = np.stack([common_token_count(row, tm) for row in ids[:SIMCOUNT_ROWS]])
    if not np.array_equal(phi, h_phi):
        raise AssertionError("simcount differs from common_token_count")
    log(f"[ops] simcount {phi.shape} equals common_token_count ({time.perf_counter() - t0:.1f} s)")
    # the wrappers' arguments that are not tensors
    extra = {"tokenize_hash": (tuple(ord(c) for c in ops.DEFAULT_DELIMITERS),),
             "match_extract": (spans.shape[1],)}
    return counts, {k: args + extra.get(k, ()) for k, args in largest.items()}, device_ms


def header_rows(lines, fmt_str):
    """Each line's header as {field: value}, None where it does not parse
    with the format (plain Python, independent of the codec)."""
    from repro_torch.core.tokenizer import LogFormat

    fmt = LogFormat(fmt_str)
    rows = []
    for line in lines:
        vals = fmt._parse_regex_line(line)
        rows.append(dict(zip(fmt.fields, vals)) if vals is not None else None)
    return rows


def header_truth(rows):
    """{aggregation name: its result} for the header-field aggregations,
    counted over parsed header rows."""
    import collections

    out = {}
    for f in ("Level", "Pid"):
        c = collections.Counter(r[f] for r in rows if r is not None)
        out[f"top_k {f}"] = sorted(c.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    hist = collections.Counter()
    for r in rows:
        m = re.search(r"[0-9]+", r["Time"]) if r is not None else None
        if m is not None:
            hist[int(m.group()) // 60] += 1
    out["time_histogram Time/60"] = dict(sorted(hist.items()))
    return out


def aggregations(query, blob, device):
    """The query path's aggregations on one archive -> {name: result},
    {name: seconds}, {name: QueryStats}."""
    res, secs, stats = {}, {}, {}

    def run(name, fn, **kw):
        st = query.QueryStats()
        t0 = time.perf_counter()
        res[name] = fn(blob, stats=st, device=device, **kw)
        secs[name], stats[name] = time.perf_counter() - t0, st

    run("count_by_template", query.count_by_template)
    run("top_k Level", query.top_k, field="Level")
    run("top_k Pid", query.top_k, field="Pid")
    cbt = res["count_by_template"]
    event = min(cbt, key=lambda g: (-cbt[g], g))
    run(f"top_k event={event} star=0", query.top_k, event=event, star=0)
    run("time_histogram Time/60", query.time_histogram, field="Time", bucket=60)
    return res, secs, stats


def query_phase(np, torch, profile, activity, lines, raw_bytes, fmt, lzjf, small_rows):
    """Phase 6: LZJS and LZJM on the card at real size, each against its
    device="cpu" twin, then the aggregations and searches on the three
    archives -> (launch counts of the aggregations, the largest input of
    each kernel they launched, each kernel's device ms under the profiler,
    {aggregation: its distinct_counts input on the LZJF}, {"fewest bins" /
    "most bins": a full LZJS chunk's distinct_counts input}, (the session's
    colcodec_transform launches, its largest input))."""
    import io

    from repro_torch.core import query
    from repro_torch.core.codec import LogzipConfig
    from repro_torch.core.parallel import compress_parallel, decompress_parallel
    from repro_torch.core.stream import LZJSReader, StreamingCompressor, decompress_lzjs
    from repro_torch.kernels import ops

    def session(device):
        buf, stages = io.BytesIO(), {}
        with StreamingCompressor(buf, LogzipConfig(format=fmt, device=device),
                                 chunk_lines=STREAM_CHUNK_LINES, stage_times=stages) as sc:
            sc.feed(lines)
        return buf.getvalue(), stages

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lzjs, stages = session("cuda")
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    rd = LZJSReader(io.BytesIO(lzjs))
    n_chunks, screened = len(rd), rd.footer.get("screens") is not None
    rd.close()
    log(f"[stream] LZJS v{lzjs[4]} (screens {screened}) on the card: {n_chunks} chunks, compress "
        f"{comp_s:.2f} s: {len(lines) / comp_s:.0f} lines/s, {raw_bytes / 1e6 / comp_s:.2f} MB/s, "
        f"ratio {raw_bytes / len(lzjs):.3f} ({len(lzjs)} bytes)")
    log(f"[stream] stage seconds: {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"[stream] launches: {json.dumps(counts)}")
    if not (counts["wildcard_match_first"] >= n_chunks and counts["colcodec_transform"] > 0
            and counts["wildcard_match"] == 0):
        raise AssertionError(f"the session skipped a kernel in some chunk: {counts}, "
                             f"{n_chunks} chunks")
    t0 = time.perf_counter()
    if decompress_lzjs(lzjs) != lines:
        raise AssertionError("decompress_lzjs(LZJS) != lines")
    dec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the twin's inputs equal the card's (the archives are equal): keep
    # its largest column-codec input for phase 7
    with capture_largest(ops) as twin_largest:
        twin = session("cpu")[0]
    if twin != lzjs:
        raise AssertionError("the card's LZJS differs from the device='cpu' session's")
    session_codec = (counts["colcodec_transform"],
                     tuple(a.cuda() for a in twin_largest["colcodec_transform"]))
    log(f"[stream] decompress {dec_s:.2f} s; archive byte-identical to the device='cpu' "
        f"session's ({time.perf_counter() - t0:.2f} s)")

    m_lines = lines[:LZJM_LINES]
    m_bytes = sum(len(line.encode("utf-8", "surrogateescape")) + 1 for line in m_lines)
    log(f"[lzjm] cut to the first {len(m_lines)} lines: with all {len(lines)} the script ran "
        f"711-800 s of its 1200 s on slower hosts")
    t0 = time.perf_counter()
    lzjm = compress_parallel(m_lines, LogzipConfig(format=fmt, device="cuda"),
                             n_workers=LZJM_WORKERS, chunk_lines=LZJM_CHUNK_LINES)
    comp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if decompress_parallel(lzjm, n_workers=LZJM_WORKERS) != m_lines:
        raise AssertionError("decompress_parallel(LZJM) != lines")
    dec_s = time.perf_counter() - t0
    log(f"[lzjm] {LZJM_WORKERS} spawned workers on the card, {LZJM_CHUNK_LINES}-line chunks: "
        f"compress {comp_s:.2f} s: {len(m_lines) / comp_s:.0f} lines/s, ratio "
        f"{m_bytes / len(lzjm):.3f} ({len(lzjm)} bytes); decompress {dec_s:.2f} s")
    t0 = time.perf_counter()
    if compress_parallel(m_lines, LogzipConfig(format=fmt, device="cpu"), n_workers=1,
                         chunk_lines=LZJM_CHUNK_LINES) != lzjm:
        raise AssertionError("the card's LZJM differs from compress_parallel(n_workers=1) "
                             "on device='cpu'")
    log(f"[lzjm] archive byte-identical to n_workers=1 on device='cpu' "
        f"({time.perf_counter() - t0:.2f} s)")

    archives = {"lzjf": lzjf, "lzjm": lzjm, "lzjs": lzjs}
    results = {}
    every: list = []  # each distinct_counts input, in call order
    starts: dict[str, int] = {}  # each archive's first in it
    ops.reset_launch_counts()
    with capture_largest(ops, every, "distinct_counts") as largest, \
            profile(activities=[activity.CUDA]) as prof:
        t0 = time.perf_counter()
        for kind, blob in archives.items():
            starts[kind] = len(every)
            results[kind] = aggregations(query, blob, "cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    device_ms, _ = kernel_profile(prof)
    busy = device_us(prof)
    busy_ms = sum(us for _, us in busy.values()) / 1e3
    log(f"[query] launches of the aggregations: {json.dumps(counts)}; distinct_counts device "
        f"ms under the profiler {device_ms['distinct_counts']:.4f}; device busy {busy_ms:.3f} "
        f"ms of {wall_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.6f})")
    if counts["distinct_counts"] == 0:
        raise AssertionError("the aggregations never launched distinct_counts")
    # one device op a call: no fill kernel or memset beside the kernel (a
    # cluster up to small_rows rows, a cooperative grid above)
    fills = sum(c for name, (c, _) in busy.items() if "fill" in name.lower())
    memsets = sum(c for name, (c, _) in busy.items() if "memset" in name.lower())
    grid_calls = sum(a[0].numel() > small_rows for a in every)
    log(f"[query] device activities of the aggregations [count, ms]: "
        f"{json.dumps({k[:60]: [c, round(us / 1e3, 4)] for k, (c, us) in busy.items()})}")
    log(f"[query] fill kernels {fills}, memsets {memsets}; {len(every)} distinct_counts calls, "
        f"{grid_calls} of them above {small_rows} rows")
    if fills or memsets or len(every) != counts["distinct_counts"]:
        raise AssertionError(f"a fill ({fills}) or memset ({memsets}) ran beside "
                             f"distinct_counts, or the capture missed calls ({len(every)} of "
                             f"{counts})")
    # the LZJS chunks' inputs: the fewest and the most bins among full
    # chunks (a chunk's rows are its lines that parse, about 8,180)
    lzjs_in = every[starts["lzjs"]:]
    full = max(a[0].numel() for a in lzjs_in)
    full_chunks = [a for a in lzjs_in if 10 * a[0].numel() >= 9 * full]
    chunk_inputs = {"fewest bins": min(full_chunks, key=lambda a: a[2]),
                    "most bins": max(full_chunks, key=lambda a: a[2])}
    del every
    # each aggregation's input on the LZJF (one chunk: one call each), for
    # timing the kernel at more than its largest input
    lzjf_args = []
    ops.input_hook = lambda name, args: lzjf_args.append(args)
    try:
        lzjf_inputs = dict(zip(aggregations(query, lzjf, "cuda")[0], lzjf_args))
    finally:
        ops.input_hook = None
    t0 = time.perf_counter()
    rows = header_rows(lines, fmt)
    truth = {"lzjf": header_truth(rows), "lzjm": header_truth(rows[:LZJM_LINES])}
    truth["lzjs"] = truth["lzjf"]
    log(f"[query] plain count of the header fields over the lines "
        f"({time.perf_counter() - t0:.1f} s)")
    for kind, blob in archives.items():
        got, secs, stats = results[kind]
        want, cpu_secs, _ = aggregations(query, blob, "cpu")
        if got != want:
            raise AssertionError(f"{kind}: an aggregation on the card differs from device='cpu'")
        for name, value in truth[kind].items():
            if got[name] != value:
                raise AssertionError(f"{kind}: {name} differs from the count over the lines")
        for name in got:
            st = stats[name]
            log(f"[query] {kind} {name}: {secs[name]:.3f} s on the card (profiled), "
                f"{cpu_secs[name]:.3f} s on cpu; chunks opened {st.chunks_opened} of "
                f"{st.chunks_total}, counted from manifests {st.chunks_counted_from_manifest}; "
                f"equal to device='cpu'")
    log("[query] header-field aggregations equal the plain count over the lines")

    t0 = time.perf_counter()
    needle = next(tok for tok in lines[len(lines) // 2].split() if tok.startswith("blk_"))
    for name, pred, test in (
            (f"Substring({needle!r})", query.Substring(needle), lambda i, l: needle in l),
            ("FieldEq(Level=WARN)", query.FieldEq("Level", "WARN"),
             lambda i, l: rows[i] is not None and rows[i]["Level"] == "WARN"),
            ("And(LineRange(400000, 400100), Substring('blk_'))",
             query.And(query.LineRange(400_000, 400_100), query.Substring("blk_")),
             lambda i, l: 400_000 <= i < 400_100 and "blk_" in l)):
        want = [(i, l) for i, l in enumerate(lines) if test(i, l)]
        st = query.QueryStats()
        t1 = time.perf_counter()
        hits = list(query.search(lzjs, pred, stats=st))
        search_s = time.perf_counter() - t1
        if hits != want or query.count(lzjs, pred) != len(want):
            raise AssertionError(f"search/count {name} differ from a plain grep")
        log(f"[search] lzjs {name}: {len(hits)} hits in {search_s:.2f} s, equal to a plain "
            f"grep; chunks opened {st.chunks_opened} of {st.chunks_total}, skipped by screen "
            f"{json.dumps(st.chunks_skipped_by)}, rows materialized {st.rows_materialized}")
    log(f"[search] ({time.perf_counter() - t0:.1f} s)")
    return counts, largest, device_ms, lzjf_inputs, chunk_inputs, session_codec


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
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
    from repro_torch.kernels import match_extract as me
    from repro_torch.kernels import scan as sn
    from repro_torch.kernels import simcount as sc
    from repro_torch.kernels import tokenize as tk
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
        # one line a source: its instantiations' registers, stack and spills
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", text))
        log(f"[build] {name}: {len(regs)} kernel(s), {min(regs)}-{max(regs)} registers, "
            f"stack frames {min(stack)}-{max(stack)} bytes, {spills} bytes spilled")
        if name in ("match_extract", "tokenize_hash"):  # redesigned: each instantiation
            each = []
            for part in text.split("Compiling entry function")[1:]:
                targs = ",".join(re.findall(r"Li(\d+)E", part.split("'")[1]))
                nregs = re.search(r"Used (\d+) registers", part)[1]
                frame = re.search(r"(\d+) bytes stack frame", part)[1]
                spill = re.search(r"(\d+) bytes spill stores", part)[1]
                each.append(f"<{targs}> {nregs} registers, {frame} B stack, {spill} B spilled")
            log(f"[build] {name} by instantiation: " + "; ".join(each))

    # -- 2: kernels against their plain versions on the card
    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mism = {"wildcard_match": 0, "wildcard_match_first": 0, "colcodec_transform": 0,
            "tokenize_hash": 0, "simcount": 0, "match_extract": 0, "distinct_counts": 0}
    for name, *arrs in wildcard_cases(np):
        args = [on(a) for a in arrs]
        got = wm.wildcard_match(*args)
        want = wm.wildcard_match_plain(*args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mism["wildcard_match"] += bad + (not torch.equal(got, want))
        log(f"[check] wildcard_match {name}: {bad} mismatches, {int(want.sum())} matches")
    for name, *arrs in first_hit_cases(np, ops):
        args = [on(a) for a in arrs]
        got = wm.wildcard_match_first(*args)
        want = wm.wildcard_match_first_plain(*args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mism["wildcard_match_first"] += bad + (not torch.equal(got, want))
        log(f"[check] wildcard_match_first {name}: {bad} mismatches, "
            f"{int((want >= 0).sum())} of {want.numel()} lines matched")
    for name, *arrs in colcodec_cases(np):
        args = [on(a) for a in arrs]
        # uint32 has few CUDA operators: compare the values as int64
        got = cc.colcodec_transform(*args).to(torch.int64)
        want = cc.colcodec_transform_plain(*args).to(torch.int64)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mism["colcodec_transform"] += bad + (not torch.equal(got, want))
        log(f"[check] colcodec_transform {name}: {bad} mismatches")
    delims = tuple(ord(c) for c in ops.DEFAULT_DELIMITERS)
    for name, blocks, lens in tokenize_cases(np):
        pws = tk.hash_powers(blocks.shape[1])
        args = [on(blocks), on(lens), on(pws[0][0]), on(pws[1][0])]
        variants = [("", args)]
        if blocks.size:  # the same grid 3 bytes past a 16-byte boundary: byte loads
            view = torch.zeros(blocks.size + 3, dtype=torch.uint8, device=dev)[3:]
            view = view.view(blocks.shape).copy_(args[0])
            variants.append((", input at byte offset 3", [view] + args[1:]))
        for tag, a in variants:
            got = tk.tokenize_hash(*a, delims)
            want = tk.tokenize_hash_plain(*a, delims)
            torch.cuda.synchronize()
            # uint32 has few CUDA operators: compare the values as int64
            bad = sum(int((g.to(torch.int64) != w.to(torch.int64)).sum())
                      for g, w in zip(got, want))
            mism["tokenize_hash"] += bad + (not all(
                torch.equal(g.to(torch.int64), w.to(torch.int64)) for g, w in zip(got, want)))
            log(f"[check] tokenize_hash {name}{tag}: {bad} mismatches, "
                f"{int(want[1].sum())} tokens")
    for name, *arrs in simcount_cases(np):
        args = [on(a) for a in arrs]
        got, want = sc.simcount(*args), sc.simcount_plain(*args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mism["simcount"] += bad + (not torch.equal(got, want))
        log(f"[check] simcount {name}: {bad} mismatches, {int(want.sum())} common tokens")
    for name, *arrs, n_slots in match_extract_cases(np):
        args = [on(a) for a in arrs]
        got, want = me.match_extract(*args, n_slots), me.match_extract_plain(*args, n_slots)
        torch.cuda.synchronize()
        bad = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        mism["match_extract"] += bad + (not (torch.equal(got[0], want[0])
                                             and torch.equal(got[1], want[1])))
        log(f"[check] match_extract {name} n_slots={n_slots}: {bad} mismatches, "
            f"{int((want[0] >= 0).sum())} lines matched")
    small = sn.small_rows()
    log(f"[check] distinct_counts: one cluster up to {small} rows, a cooperative grid above")
    for name, inv, w, n_bins in distinct_counts_cases(np, small):
        args = (on(inv), on(w), n_bins)
        variants = [("", args)]
        if len(inv) in (8192, small + 1, 1_000_000):  # one row past 16 bytes: 4-byte loads
            view = [torch.zeros(len(inv) + 1, dtype=torch.int32, device=dev)[1:].copy_(a)
                    for a in args[:2]]
            variants.append((", inputs at an offset of one row", (*view, n_bins)))
        for tag, a in variants:
            got, want = sn.distinct_counts(*a), sn.distinct_counts_plain(*a)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            mism["distinct_counts"] += bad + (not torch.equal(got, want))
            if len(inv) < 10_000 or n_bins in (2, 40, 129, 60_000) or tag:
                log(f"[check] distinct_counts {name}{tag}: {bad} mismatches, "
                    f"{int((want != 0).sum())} non-zero bins")
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
    if not (all(counts[k] > 0 for k in ("wildcard_match_first", "colcodec_transform"))
            and counts["wildcard_match"] == 0):
        raise AssertionError(f"the main path skipped a kernel or ran the (N, K) matcher: "
                             f"{counts}")
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
    ops.reset_launch_counts()
    first_calls: list = []
    with capture_largest(ops, first_calls) as largest, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_blob = compress(lines, cfg)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    if prof_blob != blob or ops.launch_counts() != counts:
        raise AssertionError("a second compress of the same lines gave another archive or "
                             f"other launches: {ops.launch_counts()} vs {counts}")
    busy = device_us(prof)
    device_ms, seen = kernel_profile(prof)
    busy_ms = sum(us for _, us in busy.values()) / 1e3
    if seen != counts:
        log(f"[profile] the profiler saw {seen} launches of {counts}: its device ms undercount")
    log(f"[profile] compress {prof_s:.2f} s under the profiler; kernel device ms: "
        f"{json.dumps({k: round(v, 3) for k, v in device_ms.items()})}")
    log(f"[profile] device busy {busy_ms:.3f} ms of {prof_s * 1e3:.1f} ms compress wall "
        f"(idle share {1 - busy_ms / (prof_s * 1e3):.6f}); by activity: "
        f"{json.dumps({k[:48]: [c, round(us / 1e3, 3)] for k, (c, us) in busy.items()})}")
    copies = {d: [sum(c for k, (c, _) in busy.items() if d in k),
                  round(sum(us for k, (_, us) in busy.items() if d in k) / 1e3, 3)]
              for d in ("DtoH", "HtoD")}
    log(f"[profile] copies under the profiler [count, device ms]: {json.dumps(copies)}; "
        f"{len(first_calls)} first-hit calls over N = {[a[0].shape[0] for a in first_calls]}")
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

    # -- 5: the ops-layer device path at real size
    ops_counts, ops_inputs, ops_device_ms = ops_phase(np, torch, profile, ProfilerActivity)
    inputs = dict(largest)
    # the (N, K) kernel no longer runs on any path: its input is the
    # largest single bucket of phase 3's first-hit calls, as it was given
    # when it ran once a bucket
    inputs["wildcard_match"] = largest_bucket(torch, first_calls)
    del first_calls
    for k in NEW_KERNELS:
        counts[k], inputs[k], device_ms[k] = ops_counts[k], ops_inputs[k], ops_device_ms[k]

    # -- 6: the streaming containers and the query path at real size
    t0 = time.perf_counter()
    q_counts, q_inputs, q_device_ms, lzjf_inputs, chunk_inputs, session_codec = query_phase(
        np, torch, profile, ProfilerActivity, lines, raw_bytes, fmt, blob, small)
    counts["distinct_counts"] = q_counts["distinct_counts"]
    device_ms["distinct_counts"] = q_device_ms["distinct_counts"]
    inputs["distinct_counts"] = q_inputs["distinct_counts"]
    log(f"[query] phase 6 took {time.perf_counter() - t0:.1f} s")

    # -- 7: each kernel at the largest input the main paths gave it
    # the card's empty-launch floor: one device op on one element, timed as
    # the kernels are (printed beside them, never as a kernel's time)
    one = torch.zeros(1, device=dev)
    floor_ms = kernel_device_ms(torch, one.fill_, (1,), 20)
    log(f"[bench] empty-launch floor: a one-element fill_, {floor_ms:.5f} ms a launch")
    rows = []
    for name, kernel, plain, src, replaces in (
            ("wildcard_match", wm.wildcard_match, wm.wildcard_match_plain,
             "src/repro_torch/csrc/wildcard_match.cu", "src/repro/kernels/wildcard_match.py:103"),
            ("wildcard_match_first", wm.wildcard_match_first, wm.wildcard_match_first_plain,
             "src/repro_torch/csrc/wildcard_match.cu", "src/repro/kernels/wildcard_match.py:103"),
            ("colcodec_transform", cc.colcodec_transform, cc.colcodec_transform_plain,
             "src/repro_torch/csrc/colcodec.cu", "src/repro/kernels/colcodec.py:85"),
            ("tokenize_hash", tk.tokenize_hash, tk.tokenize_hash_plain,
             "src/repro_torch/csrc/tokenize_hash.cu", "src/repro/kernels/tokenize.py:110"),
            ("simcount", sc.simcount, sc.simcount_plain,
             "src/repro_torch/csrc/simcount.cu", "src/repro/kernels/simcount.py:94"),
            ("match_extract", me.match_extract, me.match_extract_plain,
             "src/repro_torch/csrc/match_extract.cu", "src/repro/kernels/match_extract.py:145"),
            ("distinct_counts", sn.distinct_counts, sn.distinct_counts_plain,
             "src/repro_torch/csrc/distinct_counts.cu", "src/repro/kernels/scan.py:60")):
        args = inputs[name]
        got, want = kernel(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max((float((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel()
                   else 0.0) for g, w in zip(got, want))
        # outputs stay in the graph's pool: fewer launches for the widest grid
        ms = kernel_device_ms(torch, kernel, args, 5 if name == "tokenize_hash" else 20)
        plain_ms = time_ms(torch, plain, args, 3)
        library, library_ms = LIBRARY_NOTE[name], None
        if name == "wildcard_match":
            (n, t), (k, tt) = args[0].shape, args[2].shape
            steps = matcher_steps(torch, *args)
            # the lines' and templates' tokens up to their lengths, the
            # lengths, and one byte a pair out
            nbytes = (token_bytes(torch, args[1], t) + token_bytes(torch, args[3], tt)
                      + 4 * (n + k) + n * k)
            # one operation per column word per step run
            nops = steps * ((t + 32) // 32)
            shape = f"N={n} T={t} K={k} Tt={tt}"
            work = f"{steps} DP steps over {n * k} pairs"
        elif name == "wildcard_match_first":
            (n, t), (k, tt) = args[0].shape, args[2].shape
            n_b, n_lit, n_star = args[5].numel() - 1, args[6].numel(), args[7].numel()
            steps = first_hit_steps(torch, *args, got[0])
            # what the function needs: the lines' and templates' tokens up to
            # their lengths, the lengths, and the (N,) ids written once. The
            # bucket tables (line_bucket, bucket_ptr, bucket_tpl, star_tpl)
            # follow from the first tokens: they are the design's bytes
            nbytes = (token_bytes(torch, args[1], t) + token_bytes(torch, args[3], tt)
                      + 4 * (n + k) + 4 * n)
            design = 4 * (n + n_b + 1 + n_lit + n_star)
            nops = steps * ((t + 32) // 32)
            shape = f"N={n} T={t} K={k} Tt={tt} B={n_b} bucket ids={n_lit} S={n_star}"
            work = (f"{steps} DP steps over the candidates up to each line's first hit, "
                    f"{int((got[0] >= 0).sum())} of {n} lines matched; the bucket tables "
                    f"add {design} bytes, not counted")
            first_args = args
        elif name == "colcodec_transform":
            r, c = args[0].shape
            # two differences, the zigzag's shift and xor per element
            nbytes, nops = 8 * r * c + 12 * r, 4 * r * c
            shape = f"R={r} C={c}"
            work = f"{r * c} elements"
            s_launches, s_args = session_codec
            if not torch.equal(kernel(*s_args), plain(*s_args)):
                raise AssertionError("colcodec_transform differs from its plain version at the "
                                     "session's input")
            s_ms = kernel_device_ms(torch, kernel, s_args, 20)
            log(f"[bench] colcodec_transform at the LZJS session's largest chunk input "
                f"R={s_args[0].shape[0]} C={s_args[0].shape[1]}: {s_ms:.5f} ms; x "
                f"{s_launches} session launches = {s_launches * s_ms:.4f} ms of session device "
                f"time (at most: the other chunks' inputs are no larger); floor "
                f"{floor_ms:.5f} ms")
        elif name == "tokenize_hash":
            n, b = args[0].shape
            # the bytes before each row's min(len, B) in (the rest of a row is
            # never read: its outputs follow from the length), two int8 masks
            # and two uint32 sums out over the whole grid; the lengths and the
            # two power tables in
            read = int(args[1].clamp(0, b).sum())
            nbytes = read + 10 * n * b + 4 * n + 8 * b
            padded = 11 * n * b + 4 * n + 8 * b
            # per byte: the delimiter lookup and test, the token and start
            # bits (4); per lane the weight's multiply, five scan adds and
            # the carry add (7)
            nops = 18 * n * b
            shape = f"N={n} B={b}"
            work = (f"{n * b} bytes; {read} of them before min(len, B); the padded count "
                    f"{padded} bytes, {padded / HBM_BYTES_PER_S * 1e3:.6f} ms")
        elif name == "simcount":
            (n, t), (k, tt) = args[0].shape, args[1].shape
            nbytes = 4 * (n * t + k * tt + n * k)
            valid = int(((args[0] != 0) & (args[0] != 1)).sum())
            literals = int(((args[1] != 0) & (args[1] != 1)).sum())
            # the least the function needs: one set lookup a valid log token
            # (which of the templates hold it) and one count an output. The
            # compare design's valid tokens x literals is a design's cost
            nops = valid + n * k
            shape = f"N={n} T={t} K={k} Tt={tt}"
            work = (f"{valid} valid log tokens + {n * k} outputs; a compare design would make "
                    f"{valid} x {literals} template literals = {valid * literals}; floor "
                    f"{floor_ms:.5f} ms")
        elif name == "distinct_counts":
            inv, w, n_bins = args
            n = inv.numel()
            # inv and w read once, the bins written once; one add a row
            nbytes, nops = 8 * n + 4 * n_bins, n
            shape = f"N={n} n_bins={n_bins}"
            work = f"{n} rows"

            def library_call(inv, w, n_bins):
                return torch.zeros(n_bins, dtype=torch.int32, device=inv.device).index_add_(
                    0, inv, w)

            if not torch.equal(library_call(*args), got[0]):
                raise AssertionError("index_add_ differs from distinct_counts on the main "
                                     "path's input")
            library_ms = time_ms(torch, library_call, args, 20)
            library += f"; equal to the kernel on this input, {library_ms:.4f} ms"
            if ms >= library_ms:
                raise AssertionError("distinct_counts is slower than index_add_ on the main "
                                     "path's largest input")
            work += f"; floor {floor_ms:.5f} ms"
            others = [(f"the LZJF's {agg} input", lzjf_inputs[agg])
                      for agg in ("count_by_template", "top_k Pid")]
            others += [(f"an LZJS chunk's input, the {which}", a)
                       for which, a in chunk_inputs.items()]
            for label, a in others:
                if not torch.equal(kernel(*a), plain(*a)):
                    raise AssertionError(f"distinct_counts differs from its plain version at "
                                         f"{label}")
                lib_a = time_ms(torch, library_call, a, 20)
                kern_a = kernel_device_ms(torch, kernel, a, 20)
                log(f"[bench] distinct_counts at {label} N={a[0].numel()} n_bins={a[2]}: "
                    f"kernel {kern_a:.5f} ms, index_add_ {lib_a:.5f} ms, bound "
                    f"{(8 * a[0].numel() + 4 * a[2]) / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes), "
                    f"floor {floor_ms:.5f} ms")
                if kern_a >= lib_a:
                    raise AssertionError(f"distinct_counts is slower than index_add_ at {label}")
        else:
            (n, t), (k, tt), n_slots = args[0].shape, args[2].shape, args[4]
            steps = extract_steps(torch, *args[:4], got[0])
            # the first min(len, T) tokens of each line with len >= 0 (the
            # padding and the lines with len < 0 are never read), the
            # templates' tokens up to their lengths, the lengths, and assign
            # and the spans written once
            line_bytes = 4 * int(torch.where(args[1] >= 0, args[1].clamp(max=t), 0).sum())
            nbytes = (line_bytes + token_bytes(torch, args[3], tt) + 4 * (n + k)
                      + 4 * n * (1 + 2 * n_slots))
            padded = 4 * (n * t + n + k * tt + k) + 4 * n * (1 + 2 * n_slots)
            nops = steps * ((t + 32) // 32)
            shape = f"N={n} T={t} K={k} Tt={tt} n_slots={n_slots}"
            work = (f"{steps} DP steps (forward to the first hit, and the walk back); the "
                    f"padded count {padded} bytes, {padded / HBM_BYTES_PER_S * 1e3:.6f} ms")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / INT32_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": library_ms, "library": library, "shape": shape, "bytes": nbytes,
                     "operations": nops, "main_path_device_ms": device_ms[name]})
        if name in ("simcount", "distinct_counts"):  # beside the kernel, not its time
            rows[-1]["launch_floor_ms"] = floor_ms
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version on {shape}")
        log(f"[bench] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound: "
            f"{nbytes} bytes {bytes_ms:.6f} ms, {nops} int32 operations ({work}) "
            f"{ops_ms:.6f} ms; library: {library}")

    # the whole op at the first-hit kernel's largest call: one launch and
    # (N,) back, against one (N, K) launch a bucket with the matrices back
    ids_np = first_args[0].cpu().numpy()
    lens_np = first_args[1].cpu().numpy()
    tmpl_np, tlens_np = first_args[2].cpu().numpy(), first_args[3].cpu().numpy()
    tpl_list = [tmpl_np[i, :tlens_np[i]].copy() for i in range(len(tlens_np))]
    whole = {}
    for label, fn in (("match_first_bucketed (first-hit)", ops.match_first_bucketed),
                      ("per-bucket (N, K) + any/argmax/min", functools.partial(
                          match_first_per_bucket, np, ops)),
                      ("match_first_bucketed (first-hit) again", ops.match_first_bucketed),
                      ("per-bucket (N, K) + any/argmax/min again", functools.partial(
                          match_first_per_bucket, np, ops))):
        fn(ids_np, lens_np, tpl_list, device="cuda")  # warm up
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(ids_np, lens_np, tpl_list, device="cuda")
        whole[label] = ((time.perf_counter() - t0) * 1e3 / reps, out)
    a_new, a_old = whole["match_first_bucketed (first-hit)"][1], \
        whole["per-bucket (N, K) + any/argmax/min"][1]
    if not np.array_equal(a_new, a_old):
        raise AssertionError(f"match_first_bucketed differs from the per-bucket composition on "
                             f"{int((a_new != a_old).sum())} lines")
    log(f"[bench] whole op at N={ids_np.shape[0]} K={len(tpl_list)}, host clock, {reps} calls "
        f"each, in turns: " + "; ".join(f"{k} {v[0]:.3f} ms" for k, v in whole.items())
        + "; equal assignments")

    log(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
    log(f"[card] {card}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
