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
   ``distinct_counts`` also on inputs one row past a 16-byte boundary,
   ``colcodec_transform`` on inputs one element past one;
3. the main path at real size: 1,000,000 HDFS lines (loggen, seed 42)
   through ``compress`` on the card (level 3, gzip, typed columns,
   integrity) and back through ``decompress``; ``wildcard_match_first``
   (every ``match_first``) and ``colcodec_transform`` must have been
   launched (``colcodec_transform`` 6 times, once a kernel-safe integer
   column), the (N, K) ``wildcard_match`` never. The throughput comes
   from this run, with nothing measuring inside it. A second compress of
   the same lines runs under ``torch.profiler`` for each kernel's device
   time, the copies' and the device's idle share, and keeps the largest
   input each kernel was given and every first-hit call; its
   host-to-device copies must equal the wrappers' uploads, one a
   ``colcodec_transform`` call. Both archives must equal the port's
   ``device="cpu"`` archive byte for byte (a process of its own, beside
   phases 3-6, makes it from the same corpus file; checked after phase 6);
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
   HDFS lines of phase 3: a ``StreamingCompressor`` session on the card
   over the first 500,000, timed with nothing measuring inside it (LZJS
   v3 with screens, 8,192-line chunks; its ``colcodec_transform``
   launches printed) and
   ``compress_parallel`` over four spawned workers on the card (LZJM of
   the first 125,000 lines, a chunk per worker), each equal byte for byte
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
   input, times its launches, beside the floor; time
   ``ops.match_first_bucketed`` end to end against the per-bucket
   composition it replaced;
8. durability, on the first 60,000 lines of phase 3: sessions of the
   port's ``TenantStore`` (an empty archive first, then an append session
   that fsyncs each commit, every line journaled first), its archive
   written through a ``FaultyOpener``; a clean one on the card under
   ``torch.profiler``, whose host-to-device copies must equal the
   wrappers' uploads, one a ``colcodec_transform`` call, and whose bytes
   must equal a ``device="cpu"`` twin's, gives the cuts: torn halfway into
   chunk 4's record, at the end of chunk 6's commit record and 40 bytes
   before the end (inside the footer), each wreck the clean stream's bytes
   up to the cut and its ``recover.repair`` keeping every committed
   chunk's lines; the chunk-4 crash resumed by a new store from copies of
   its wreck and journal on the card and on the CPU (``ensure_clean``,
   the journal replayed from the committed lines, the client's re-send),
   all lines back in order, equal archives on both;
   ``wildcard_match_first`` and ``colcodec_transform`` must have been
   launched;
9. the ingest daemon, the lifecycle layer and the CLI on the card: one
   ``IngestDaemon`` with a ``RetentionManager``, four tenants of 12,500
   lines of phase 3's corpus over one unix socket, a client thread each,
   every line acked, then a drain that seals each session and compacts it
   into the sealed tier, each sealed archive decoding to its lines, no
   tenant failure and no open breaker, ``wildcard_match_first`` and
   ``colcodec_transform`` launched in the feed and in the drain; a tenant
   cut halfway by a forced abort and resumed by a fresh daemon from the
   handshake's watermark, every line once; phase 8's clean archive
   ``compact``-ed on the card and its ``device="cpu"`` twin's on the CPU
   (a process of its own), equal bytes; the CLI as processes with
   ``--device cuda``: ``serve --retention`` drained by SIGTERM, ``pack``
   / ``unpack`` byte-equal, ``agg`` equal to ``--device cpu``'s, each
   process printing its launch counts;
10. the LM data pipeline on the card: 100,000 Spark lines (loggen, seed
   0, ``examples/train_lm_on_logs.py``'s level 3 config) written by
   ``write_logzip_shards`` and ``write_logzip_stream`` on the card and on
   the CPU, every shard file, container and manifest equal byte for byte,
   ``wildcard_match_first`` and ``colcodec_transform`` launched in each
   card write; ``TokenBatcher`` batches on the card equal to the CPU's,
   also after a ``state_dict`` resume, in bytes and events mode;
   ``PrefetchLoader`` serving each shard once;
11. serving ``qwen3-1.7b`` at full width: the KV cache against
   ``forward`` in fp32 (TF32 off), a 2-layer full-width twin on the card
   against the CPU, a timed bf16 serve of 8 requests (prefill and decode
   ms, tokens/s, peak memory, the decode bound; the attention kernel
   launched once a layer a prefill, never in the decode), and ``python -m
   repro_torch.launch.serve --device cuda`` as a process;
12. serving the LM zoo's other families at full width: rwkv6-7b (32
   layers), jamba-v0.1-52b (8 of 32: one block of mamba, attention, MoE
   and dense FFN), dbrx-132b (2 of 40), internvl2-2b (24, a 256-patch
   prefix) and whisper-base (6 + 6, 1500 frames): for each the cache
   against ``forward`` in fp32, a full-width CPU twin, a timed bf16 serve
   (the decode bound, and the experts a MoE step routes to), then
   ``launch.serve`` as six processes at once, one for each non-dense arch;
13. training ``qwen1.5-0.5b`` (the training launcher's default arch) at
   full width: ``launch.train.main`` in this process for 10 steps of (8,
   256) after its 40,000-line shard write on the card
   (``wildcard_match_first`` and ``colcodec_transform`` launched), and the
   launcher as a process sent SIGTERM after its first step, whose
   preemption checkpoint is resumed to the same step: the two final
   checkpoints equal in the data cursor and the step, the parameters
   within AdamW's reach (two profiled steps launch the attention
   kernel's forward twice a layer, remat, and its backward once); the
   preemption checkpoint in the reference's layout; one train step of a
   2-layer fp32 twin on the card against the
   CPU; ms a step, tokens/s, peak memory, the checkpoint's bytes and
   seconds, the FLOP bound;
14. the distribution layer: (a) the sharding rules for all ten archs at
   full width on the (16, 16) and (2, 16, 16) meshes, on shapes; (b)
   ``wildcard_match_sharded`` on a one-rank NCCL mesh at the (N, K)
   kernel's phase-7 input, equal to ``wildcard_match`` and the plain
   version, its launch counted (row 1a's path) and timed; (c) qwen1.5-0.5b
   at full width in fp32, one train step as DTensors on that mesh against
   the plain step; (d) the cost model over one bf16 (8, 256) step on the
   card beside the measured ms; (e) the production dry-run cell
   (qwen1.5-0.5b x train_4k x 16 x 16, a fake group of 256 ranks) as a
   process, beside (a)-(d): memory per rank against 80 GB, cost terms.
15. the sharded decode path: (a) ``qwen3-1.7b`` at full width in fp32 on
   a one-rank NCCL mesh, a prefill and 8 decode steps as DTensors (the
   cache placed by ``cache_pspecs``) against the plain ``prefill`` /
   ``decode_step`` on the same tokens: logits within ``DECODE_REL`` of the
   largest |logit|, the caches equal, every cache leaf's placements as
   they came in after every step, ms a step of each; (b) three production
   dry-run cells (qwen2-7b x decode_32k, jamba-v0.1-52b x long_500k,
   qwen2-7b x prefill_32k, each on the (16, 16) mesh of 256 fake ranks)
   as one process started beside phase 14: memory per rank against 80 GB,
   the roofline terms, the collectives, and no all-gather of a cache
   block. The decode path reaches no CUDA kernel of the port.
16. the fused attention kernel (``kernels.attention``, CUDA C++) at the
   benchmark cells' shapes, causal bf16: its output and gradients
   against the plain version's, its forward and its forward plus
   backward beside their FLOP bounds, the plain version and
   ``F.scaled_dot_product_attention`` as a yardstick; row 7 carries the
   launches and device ms that phases 11 and 13 counted on the main path.
   Then print the ``kernels`` line (row 1a's launches are phase 3's and
   phase 14's; row 7 is phase 16's) and the result line.

It imports torch, numpy, the standard library and ``repro_torch`` only.
It exits non-zero, printing no result, when there is no CUDA device or
when it is not run from a checkout that holds ``src/repro_torch``.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# phase 6: the LZJS session takes the first half of the lines: with all
# 1,000,000 the script ran 1,230 s of its 1,200 beside phase 14 on a slower
# H100 80GB HBM3 host (phase 6 325.5 s there)
STREAM_LINES = 500_000
LZJM_WORKERS = 4
# the LZJM takes the first eighth of the lines, a chunk per worker: with
# all 1,000,000 the script ran 711-800 s of its 1200 s on slower hosts,
# with the first 500,000 beside phase 12 1,066 s on one H100 80GB HBM3
# host, with 250,000 beside phase 14 1,230 s on a slower one
LZJM_LINES = 125_000
LZJM_CHUNK_LINES = LZJM_LINES // LZJM_WORKERS
# phase 8: the first lines of phase 3's corpus; 100,000 (13 chunks) until
# the script with phase 12 ran 1,056-1,066 s on slower H100 80GB HBM3
# hosts; 60,000 keeps the 8 chunks its cuts need (chunk 6's commit)
DURABLE_LINES = 60_000
# phase 9: the feed's tenants split the first lines of phase 3's corpus.
# At 250,000 lines a tenant (all 1,000,000) the feed ran 349 s at 2,864
# lines/s and the phase 595 s on an H100 80GB HBM3 host: cut to 100,000;
# then to 12,500 (and the crash leg and the CLI's input halved), to keep
# the script under 1,050 s of its 1,200 beside phase 12 (at 50,000 and
# 25,000 it ran 1,066 and 1,056 s on slower H100 80GB HBM3 hosts)
INGEST_TENANTS = 4
INGEST_TENANT_LINES = 12_500
INGEST_CRASH_LINES = 25_000  # the crash leg's tenant
INGEST_CLI_LINES = 50_000  # pack / unpack / agg
SERVE_LINES = 20_000
INGEST_WAIT = 600.0  # seconds any one wait of phase 9 may take
# phase 10: the data pipeline, as examples/train_lm_on_logs.py:46-50 sets it
# up (level 3, the Spark format, ISEConfig(min_sample=300)) at 100,000 lines
PIPE_LINES = 100_000
PIPE_SHARD_LINES = 20_000
PIPE_BATCHES = 20  # (8, 256) batches a batcher, resumed at batch 10
# phase 11: serving qwen3-1.7b at full width
SERVE_ARCH = "qwen3-1.7b"
SERVE_SEED = 0
CACHE_REL = 1e-4  # (a): fp32 prefill + decode against forward, of max |logit|
TWIN_REL = 1e-4   # (b): fp32 on the card against the CPU, of max |logit|
# phase 12: the LM zoo's other families served on the card, each at its
# published widths; depth cut only where one card cannot hold the model:
# arch -> (layers on the card, the published config's shape)
FAMILIES = {
    "rwkv6-7b": (32, dict(n_layers=32, d_model=4096, n_rwkv_heads=64, rwkv_head_dim=64,
                          d_ff=14336, padded_vocab=65536, family="ssm")),
    "jamba-v0.1-52b": (8, dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
                               head_dim=128, d_ff=14336, padded_vocab=65536, family="hybrid",
                               n_experts=16, top_k=2, attn_every=8, moe_every=2, d_inner=8192,
                               ssm_state=16)),
    "dbrx-132b": (2, dict(n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                          d_ff=10752, padded_vocab=100352, family="moe", n_experts=16,
                          top_k=4)),
    "internvl2-2b": (24, dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
                              head_dim=128, d_ff=8192, padded_vocab=92672, family="vlm",
                              n_patches=256)),
    "whisper-base": (6, dict(n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
                             head_dim=64, d_ff=2048, padded_vocab=51968, family="audio",
                             n_frames=1500, tie_embeddings=True)),
}
# (d): the serve CLI on each non-dense arch's reduced config (grok-1 runs
# dbrx's code with 8 experts top-2: at 64 layers of 6,144 wide experts no
# part of it fits the card that dbrx's 2 layers do not already cover)
FAMILY_CLI = ["dbrx-132b", "grok-1-314b", "jamba-v0.1-52b", "internvl2-2b", "whisper-base",
              "rwkv6-7b"]
# phase 13: training the launcher's default arch at full width
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_STEPS = 10    # N: run A's steps, and run B's in all
TRAIN_BATCH, TRAIN_SEQ = 8, 256   # the launcher's defaults
TRAIN_TWIN_REL = 1e-4  # (b): fp32 on the card against the CPU, of the largest |value|
# phase 14: the distribution layer; (c) and (d) train the launcher's arch,
# (e) dry-runs its production cell (a fake group of 256 ranks, on shapes)
DIST_ARCH = TRAIN_ARCH
DRYRUN_CELL = ("qwen1.5-0.5b", "train_4k", "single")
DRYRUN_TIMEOUT = 300.0  # seconds the dry-run process may take beyond (a)-(d)
# phase 15: the sharded decode path. (a) serves SERVE_ARCH on a one-rank
# mesh: DECODE_BATCH prompts of DECODE_PROMPT tokens into a cache of
# DECODE_CAP, then DECODE_STEPS steps on fixed tokens (seed DECODE_SEED);
# (b) dry-runs DECODE_CELLS as one process beside phases 14 and 15 (a)
DECODE_BATCH, DECODE_PROMPT, DECODE_CAP, DECODE_STEPS = 4, 32, 64, 8
DECODE_SEED = 15
DECODE_REL = 1e-5  # (a): DTensor against plain, of the largest |logit|
DECODE_CELLS = [("qwen2-7b", "decode_32k", "single"), ("jamba-v0.1-52b", "long_500k", "single"),
                ("qwen2-7b", "prefill_32k", "single")]
DECODE_DRYRUN_TIMEOUT = 420.0  # seconds the cells may take beyond phases 14 and 15 (a)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
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
    """(name, vals, lens, mode, ref) grids: magnitudes at
    ``coltypes.KERNEL_SAFE`` - 1, every third value at +-(2**28 - 1); the
    LZJS session's widths (C = 8,185 and 8,192); C = 1, 2, 3, where a row
    holds no whole 16-byte group; R = 3 at C = 5, 4,097 and 1,000,001,
    whose rows start off a 16-byte boundary; lengths 0, 1 and 2 under every
    mode; and values over all of int32, where the uint32 arithmetic wraps."""
    rng = np.random.default_rng(11)
    lim = 1 << 28
    cases = []
    for r, c in [(1, 1), (3, 2), (8, 127), (9, 128), (5, 129), (4, 4096), (1, 1_000_000),
                 (3, 1_000_000), (1, 8185), (1, 8192), (1, 2), (1, 3), (4, 1), (4, 3), (3, 5),
                 (3, 4097), (3, 1_000_001)]:
        vals = rng.integers(-lim + 1, lim, (r, c)).astype(np.int32)
        vals[:, ::3] = np.where(rng.random((r, len(range(0, c, 3)))) < 0.5, lim - 1, -lim + 1)
        lens = rng.integers(0, c + 1, (r,)).astype(np.int32)
        lens[0] = c
        mode = (np.arange(r) % 3 + 1).astype(np.int32)
        ref = np.where(mode == 3, vals.min(axis=1), 0).astype(np.int32)
        cases.append((f"R={r} C={c}", vals, lens, mode, ref))
    for c in (3, 37, 4100):  # lengths 0, 1, 2 and C under modes 0-3
        lens = np.tile(np.array([0, 1, 2, c], np.int32), 4)
        mode = np.repeat(np.arange(4, dtype=np.int32), 4)
        vals = rng.integers(-lim + 1, lim, (16, c)).astype(np.int32)
        ref = rng.integers(-lim + 1, lim, 16).astype(np.int32)
        cases.append((f"R=16 C={c} lens 0, 1, 2, C under every mode", vals, lens, mode, ref))
    extreme = np.array([2**31 - 1, -2**31, -2**31 + 1, 2**31 - 2, -1, 0, 1, lim, -lim], np.int32)
    for r, c in [(8, 4099), (1, 998_027)]:  # past KERNEL_SAFE: the arithmetic wraps
        vals = rng.integers(-2**31, 2**31, (r, c), dtype=np.int64).astype(np.int32)
        vals[:, 1::2] = rng.choice(extreme, (r, len(range(1, c, 2))))
        lens = np.full(r, c, np.int32)
        lens[1::3] = rng.integers(0, c + 1, len(range(1, r, 3)))
        mode = (np.arange(r) % 4).astype(np.int32)
        ref = rng.choice(extreme, r).astype(np.int32)
        cases.append((f"R={r} C={c} values over all of int32", vals, lens, mode, ref))
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


def uploads(args) -> int:
    """Host-to-device copies that made a wrapper's inputs: one for each
    non-empty device buffer among them (views of one buffer share it)."""
    return len({a.untyped_storage().data_ptr() for a in args
                if hasattr(a, "numel") and a.numel()})


@contextlib.contextmanager
def capture_largest(ops, every=None, kernel="wildcard_match_first", copies=None):
    """Inside the block, keep by kernel the largest input its wrapper was
    given (through ``ops.input_hook``) -> {kernel: args}; with ``every``, a
    list, also append to it the input of each call of ``kernel``; with
    ``copies``, a dict, add to it by kernel the uploads of each call."""
    sizes: dict[str, int] = {}
    largest: dict[str, tuple] = {}

    def keep(name, args):
        size = sum(a.numel() for a in args if hasattr(a, "numel"))
        if size > sizes.get(name, -1):
            sizes[name], largest[name] = size, args
        if every is not None and name == kernel:
            every.append(args)
        if copies is not None:
            copies[name] = copies.get(name, 0) + uploads(args)

    ops.input_hook = keep
    try:
        yield largest
    finally:
        ops.input_hook = None


def ops_phase(np, torch, profile, activity, spark_lines):
    """Phase 5: the ops-layer device path on 1M Spark lines, then its
    checks against the host paths -> (launch counts, the largest input of
    each kernel, each kernel's device ms under the profiler)."""
    from repro_torch.core.ise import ISEConfig, iterative_structure_extraction
    from repro_torch.core.lcs import common_token_count
    from repro_torch.core.match import extract_spans, match_first
    from repro_torch.core.tokenizer import Vocab, tokenize
    from repro_torch.kernels import ops

    contents = [line.split(": ", 1)[-1] for line in spark_lines]
    raw_bytes = sum(len(c.encode("utf-8", "surrogateescape")) for c in contents)
    log(f"[ops] {len(contents)} Spark contents, {raw_bytes / 1e6:.1f} MB")

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


def query_phase(np, torch, profile, activity, lines, fmt, lzjf, small_rows):
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

    s_lines = lines[:STREAM_LINES]
    s_bytes = sum(len(line.encode("utf-8", "surrogateescape")) + 1 for line in s_lines)

    def session(device):
        buf, stages = io.BytesIO(), {}
        with StreamingCompressor(buf, LogzipConfig(format=fmt, device=device),
                                 chunk_lines=STREAM_CHUNK_LINES, stage_times=stages) as sc:
            sc.feed(s_lines)
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
    log(f"[stream] LZJS v{lzjs[4]} (screens {screened}) on the card, the first {len(s_lines)} "
        f"lines: {n_chunks} chunks, compress {comp_s:.2f} s: {len(s_lines) / comp_s:.0f} lines/s, "
        f"{s_bytes / 1e6 / comp_s:.2f} MB/s, ratio {s_bytes / len(lzjs):.3f} ({len(lzjs)} bytes)")
    log(f"[stream] stage seconds: {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    log(f"[stream] launches: {json.dumps(counts)}")
    log(f"[stream] colcodec_transform: {counts['colcodec_transform']} launches; this timed "
        f"session runs with nothing measuring inside it, so its host-to-device copies are "
        f"counted under the profiler in phase 8's clean session, on the same path")
    if not (counts["wildcard_match_first"] >= n_chunks and counts["colcodec_transform"] > 0
            and counts["wildcard_match"] == 0):
        raise AssertionError(f"the session skipped a kernel in some chunk: {counts}, "
                             f"{n_chunks} chunks")
    t0 = time.perf_counter()
    if decompress_lzjs(lzjs) != s_lines:
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
    log(f"[lzjm] cut to the first {len(m_lines)} lines (LZJM_LINES says why)")
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
    truth = {"lzjf": header_truth(rows), "lzjm": header_truth(rows[:LZJM_LINES]),
             "lzjs": header_truth(rows[:STREAM_LINES])}
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
    needle = next(tok for tok in s_lines[len(s_lines) // 2].split() if tok.startswith("blk_"))
    for name, pred, test in (
            (f"Substring({needle!r})", query.Substring(needle), lambda i, l: needle in l),
            ("FieldEq(Level=WARN)", query.FieldEq("Level", "WARN"),
             lambda i, l: rows[i] is not None and rows[i]["Level"] == "WARN"),
            ("And(LineRange(400000, 400100), Substring('blk_'))",
             query.And(query.LineRange(400_000, 400_100), query.Substring("blk_")),
             lambda i, l: 400_000 <= i < 400_100 and "blk_" in l)):
        want = [(i, l) for i, l in enumerate(s_lines) if test(i, l)]
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


def store_session(root, lines, cfg, budget=None, resend_from=0):
    """Phase 8's writer: the port's ``TenantStore`` of tenant ``t`` under
    ``root`` as the ingest daemon drives it, each 8,192-line batch
    journaled, synced and then handed to the archive session, which fsyncs
    each chunk's commit; the archive is written through a ``FaultyOpener``
    of ``budget`` bytes, the empty archive published first included. A
    store opened on a wreck heals it and replays its journal, and must
    resume at ``resend_from``, where the client re-sends from. At the
    first ``OSError`` the store drops its handles as a killed process
    drops them -> (the error or None, lines replayed, the journal's
    durable watermark: the lines acked to the client)."""
    from repro_torch.core.faultinject import FaultyOpener
    from repro_torch.ingest import TenantStore

    os.makedirs(root, exist_ok=True)
    st = TenantStore(root, "t", cfg, chunk_lines=STREAM_CHUNK_LINES,
                     archive_opener=FaultyOpener(budget), device=cfg.device)
    if st.next_seq != resend_from:
        raise AssertionError(f"the store resumes at {st.next_seq}, the client at {resend_from}")
    err = None
    try:
        for s in range(resend_from, len(lines), STREAM_CHUNK_LINES):
            for i in range(s, min(s + STREAM_CHUNK_LINES, len(lines))):
                st.submit(i, lines[i])
            st.ack_sync()
        st.seal()
    except OSError as e:
        err = e
        st.crash()
    return err, st.replayed, st.wal.durable_seq


def durability_phase(torch, profile, activity, lines, fmt, keep: Path, device="cuda") -> dict:
    """Phase 8: torn ``TenantStore`` sessions repaired, and a store resumed
    from its write-ahead journal, on ``device`` -> its launch counts. The
    clean session that gives the cuts runs under ``torch.profiler``: its
    host-to-device copies must equal the wrappers' uploads, one a
    ``colcodec_transform`` call (phase 6's timed session is not profiled);
    its bytes must equal a ``device="cpu"`` twin's, and both archives are
    left in ``keep`` (``main.lzjs``, ``cpu.lzjs``) for phase 9's
    ``compact``. Each torn session's wreckage must be the clean stream cut
    at its byte, and its repair must keep every committed chunk's lines.
    The resume runs on ``device`` and on the CPU from copies of one wreck
    and its journal, and must give equal archives.
    (``tests/test_torch_durability.py`` holds ``repair`` and ``fsck``
    against the reference byte for byte.)"""
    from repro_torch.core import recover, stream
    from repro_torch.core.codec import LogzipConfig
    from repro_torch.core.faultinject import FaultyOpener
    from repro_torch.core.stream import LZJSReader
    from repro_torch.kernels import ops

    def read(path):
        rd = LZJSReader(path)
        try:
            return rd.read_all()
        finally:
            rd.close()

    lines = lines[:DURABLE_LINES]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="durability-", dir=ROOT / "build"))
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    try:
        cfgs = {side: LogzipConfig(format=fmt, device=d)
                for side, d in (("main", device), ("twin", "cpu"))}
        clean = work / "clean-main" / "t.lzjs"
        wrapper_copies: dict[str, int] = {}
        t0 = time.perf_counter()
        with capture_largest(ops, copies=wrapper_copies), \
                profile(activities=[activity.CUDA]) as prof:
            store_session(str(clean.parent), lines, cfgs["main"])
            torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        h2d = sum(c for k, (c, _) in device_us(prof).items() if "HtoD" in k)
        log(f"[durable] clean session under the profiler: colcodec_transform "
            f"{counts['colcodec_transform']} launches, "
            f"{wrapper_copies.get('colcodec_transform', 0)} uploads; host-to-device copies "
            f"{h2d}, the wrappers' uploads {json.dumps(wrapper_copies)}")
        if wrapper_copies.get("colcodec_transform", 0) != counts["colcodec_transform"] \
                or not counts["colcodec_transform"] or h2d != sum(wrapper_copies.values()):
            raise AssertionError("colcodec_transform made other than one upload a call, or the "
                                 "session copied to the card outside the kernel wrappers")
        data = clean.read_bytes()
        if read(str(clean)) != lines:
            raise AssertionError("the clean session does not read back its lines")
        t0 = time.perf_counter()
        store_session(str(work / "clean-twin"), lines, cfgs["twin"])
        twin_s = time.perf_counter() - t0
        if (work / "clean-twin" / "t.lzjs").read_bytes() != data:
            raise AssertionError(f"the clean session differs between {device} and cpu")
        shutil.copyfile(clean, keep / "main.lzjs")
        shutil.copyfile(work / "clean-twin" / "t.lzjs", keep / "cpu.lzjs")
        rd = LZJSReader(str(clean))
        index, footer_at = [dict(e) for e in rd.index], rd.footer_offset
        rd.close()
        boot, probe = work / "boot.lzjs", FaultyOpener()
        stream.StreamingCompressor(str(boot), cfgs["twin"], opener=probe).close()
        rd = LZJSReader(str(boot))
        written_from = rd.footer_offset  # where the append session's writes begin
        rd.close()
        log(f"[durable] {len(lines)} lines, {len(index)} chunks of {STREAM_CHUNK_LINES}; clean "
            f"session {len(data)} bytes, footer at {footer_at}: {clean_s:.2f} s on {device} "
            f"(profiled), {twin_s:.2f} s on cpu, equal bytes")

        def commit_end(e):
            return e["sc"][0] if "sc" in e else e["offset"] + e["length"]

        e4 = index[4]
        torn4 = e4["offset"] + e4["length"] // 2
        cuts = {"halfway into chunk 4's record": torn4,
                "at the end of chunk 6's commit record": commit_end(index[6]),
                "40 bytes before the end, inside the footer": len(data) - 40}
        for n, (label, cut) in enumerate(cuts.items()):
            want = [line for e in index if commit_end(e) <= cut
                    for line in lines[e["line_start"]:e["line_start"] + e["n_lines"]]]
            path = work / f"torn-{n}" / "t.lzjs"
            t0 = time.perf_counter()
            # the empty archive's bytes, then the append session's up to the cut
            err, _, ack = store_session(str(path.parent), lines, cfgs["main"],
                                        probe.bytes_written + cut - written_from)
            secs = time.perf_counter() - t0
            wreck = path.read_bytes()
            if err is None or wreck != data[:cut]:
                raise AssertionError(f"{label}: the session did not stop at byte {cut} of the "
                                     f"clean stream ({err!r}, {len(wreck)} bytes landed)")
            if cut == torn4:  # the wreck and its journal, for the resume on both sides
                acked = ack
                for side in cfgs:
                    shutil.copytree(path.parent, work / f"resume-{side}")
            report = recover.repair(str(path))
            back = read(str(path))
            if back != want:
                raise AssertionError(f"{label}: {len(back)} lines read back after repair, "
                                     f"{len(want)} were committed before the cut")
            log(f"[durable] torn at byte {cut} ({label}): session {secs:.2f} s on {device}; "
                f"the wreckage is the clean stream's first {cut} bytes; repair keeps the "
                f"{len(want)} committed lines; report {json.dumps(report)}")

        got = {}
        for side, cfg in cfgs.items():
            root = work / f"resume-{side}"
            at_crash = sorted(p.name for p in (root / "t.lzjs.wal").iterdir())
            t0 = time.perf_counter()
            err, n_replayed, _ = store_session(str(root), lines, cfg, resend_from=acked)
            secs = time.perf_counter() - t0
            if err is not None:
                raise AssertionError(f"the resumed session failed on {cfg.device}: {err!r}")
            got[side] = ((root / "t.lzjs").read_bytes(), read(str(root / "t.lzjs")),
                         (root / "t.lzjs.wal").exists(), at_crash, n_replayed, secs)
        blob, back, journal_left, at_crash, n_replayed, secs = got["main"]
        if back != lines or journal_left:
            raise AssertionError(f"the resumed archive reads back {len(back)} lines, not the "
                                 f"{len(lines)} fed, or its sealed store kept its journal")
        if got["main"][:3] != got["twin"][:3]:
            raise AssertionError(f"the resumed archive differs between {device} and cpu")
        log(f"[durable] resume after the chunk-4 crash: {acked} lines acked, journal "
            f"segments {at_crash} at the crash; ensure_clean, then {n_replayed} lines replayed "
            f"from the journal and {len(lines) - acked} re-sent; {secs:.2f} s on {device}, "
            f"{got['twin'][5]:.2f} s on cpu; all {len(lines)} lines back in order, the archive "
            f"({len(blob)} bytes) equal on both, the sealed store's journal gone")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = ops.launch_counts()
    log(f"[durable] launches on {device}: {json.dumps(counts)}; phase 8 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


# the port's CLI as a user runs it, in a process of its own; at exit it
# prints the process's kernel launches on its standard error
CLI_MAIN = """import atexit, json, runpy, sys
from repro_torch.kernels import ops
atexit.register(lambda: print("[launches] " + json.dumps(ops.launch_counts()),
                              file=sys.stderr, flush=True))
runpy.run_module("repro_torch.launch.compress", run_name="__main__", alter_sys=True)
"""


def cli(*args: str, timeout: float | None = None, background: bool = False):
    """``python -m repro_torch.launch.compress ARGS`` -> (exit code,
    stdout, stderr, the process's launch counts), or the process itself
    when ``background``."""
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_MAIN, *args], cwd=str(ROOT), text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc if background else cli_result(proc, timeout)


def cli_result(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    tagged = [ln for ln in err.splitlines() if ln.startswith("[launches] ")]
    counts = json.loads(tagged[-1][len("[launches] "):]) if tagged else {}
    return proc.returncode, out, err, counts


def corpus_writer(dataset: str, n: int, seed: int, path: Path):
    """A process that writes loggen's ``dataset`` corpus to ``path``, one
    line a line (it is killed at exit if still running)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; from repro_torch.data.loggen import write_dataset; "
         "write_dataset(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))",
         dataset, str(path), str(n), str(seed)],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    atexit.register(proc.kill)
    return proc


def corpus_read(proc, path: Path, keep: bool = False) -> list[str]:
    """The lines ``proc`` (a ``corpus_writer``) wrote, once it is done; the
    file is deleted unless ``keep``."""
    if proc.wait(timeout=600) != 0:
        raise RuntimeError(f"writing {path.name} failed (exit {proc.returncode})")
    with open(path, encoding="utf-8", newline="") as f:
        lines = f.read().split("\n")
    if not keep:
        path.unlink()
    return lines


def cpu_twin(corpus: Path, out: Path):
    """Phase 3's ``device="cpu"`` compress of the corpus file's lines (read
    as ``corpus_read`` reads them) as a process of its own, beside phases
    3-6, writing the archive to ``out`` and its seconds to stdout."""
    code = ("import sys, time; from repro_torch.core.codec import LogzipConfig, compress; "
            "from repro_torch.data.loggen import DATASETS; "
            "lines = open(sys.argv[1], encoding='utf-8', newline='').read().split('\\n'); "
            "t0 = time.perf_counter(); "
            "blob = compress(lines, LogzipConfig(format=DATASETS['HDFS']['format'], "
            "device='cpu')); print(time.perf_counter() - t0); "
            "open(sys.argv[2], 'wb').write(blob)")
    proc = subprocess.Popen([sys.executable, "-c", code, str(corpus), str(out)], cwd=str(ROOT),
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)
    return proc


# the CPU side of phase 9's compact twin, in a process of its own:
# argv[1] compacted into argv[2] -> its seconds
TWIN_MAIN = """import json, sys, time
from repro_torch.lifecycle import compact
t0 = time.perf_counter()
compact([sys.argv[1]], sys.argv[2], device="cpu")
print(json.dumps(time.perf_counter() - t0))
"""


def socket_in(directory: Path) -> str:
    """A unix socket path in ``directory``, or in the temporary directory
    where that path would pass the ~108-byte limit."""
    path = directory / "ingest.sock"
    if len(str(path)) > 100:
        path = Path(tempfile.mkdtemp(prefix="lzsock-")) / "ingest.sock"
    return str(path)


def ingest_phase(torch, lines, fmt, twins: Path, device="cuda") -> dict:
    """Phase 9: the ingest daemon, the lifecycle layer and the CLI on
    ``device``, on phase 3's lines -> the launch counts of the feed.

    The feed: one ``IngestDaemon`` with a ``RetentionManager``, ``INGEST_TENANTS``
    tenants of ``INGEST_TENANT_LINES`` lines each, one ``IngestClient`` thread a
    tenant; every line acked, then a drain that seals each session and rolls
    it (``compact``, lzma, 16,384-line chunks) into the sealed tier. The
    crash leg: a tenant cut by a forced abort halfway through its acks and
    resumed by a fresh daemon from the handshake's watermark. The twin:
    phase 8's clean archive (``twins / "main.lzjs"``) compacted on
    ``device`` and its CPU twin's (``cpu.lzjs``, the same bytes) on the
    CPU, equal bytes. The CLI: ``serve --retention``
    drained by SIGTERM, ``pack`` / ``unpack`` and ``agg`` against
    ``--device cpu``, each a process of its own."""
    import signal
    import threading

    from repro_torch.core.stream import LZJSReader
    from repro_torch.ingest import IngestClient, IngestDaemon, ProtocolError
    from repro_torch.kernels import ops
    from repro_torch.lifecycle import RetentionManager, RetentionPolicy, compact

    def read(path):
        rd = LZJSReader(str(path))
        try:
            return rd.read_all()
        finally:
            rd.close()

    def healthy(daemon, what):
        """Raise on any tenant failure the daemon or its supervisor shows."""
        stats, status = daemon.stats(), daemon.supervisor.status()
        failed = {t: s["failed"] for t, s in stats.items() if s["failed"] is not None}
        tripped = {t: s for t, s in status.items() if s["failures"] or s["open"]}
        if failed or tripped:
            raise AssertionError(f"{what}: tenant failures {failed}, breakers {tripped}")

    def used_kernels(counts, what):
        if not (counts.get("wildcard_match_first", 0) > 0
                and counts.get("colcodec_transform", 0) > 0):
            raise AssertionError(f"{what} skipped a kernel: {counts}")

    hello = {"format": fmt}
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ingest-", dir=ROOT / "build"))
    t_phase = time.perf_counter()
    try:
        # -- the feed: tenants over one socket, each session sealed and compacted
        root = work / "feed"
        root.mkdir()
        tenants = {f"tenant{i}": lines[i * INGEST_TENANT_LINES:(i + 1) * INGEST_TENANT_LINES]
                   for i in range(INGEST_TENANTS)}
        retention = RetentionManager(str(root), RetentionPolicy(rollup_after=2))
        roll_s, rolled = {}, {}
        real_roll = retention.roll_tenant

        def timed_roll(tenant, **kw):  # the daemon's hook, timed
            t0 = time.perf_counter()
            rolled[tenant] = real_roll(tenant, **kw)
            roll_s[tenant] = time.perf_counter() - t0
            return rolled[tenant]

        retention.roll_tenant = timed_roll
        ops.reset_launch_counts()
        daemon = IngestDaemon(str(root), socket_in(root), device=device,
                              chunk_lines=STREAM_CHUNK_LINES, retention=retention).start()
        acked, errors = {}, {}

        def feed(tid, tl):
            try:
                with IngestClient(daemon.address, tid, cfg=hello, timeout=INGEST_WAIT) as c:
                    for line in tl:
                        c.send(line)
                    acked[tid] = c.wait_ack(len(tl) - 1, timeout=INGEST_WAIT)
                    if c.error is not None:
                        errors[tid] = c.error
            except (ProtocolError, OSError) as e:
                errors[tid] = e

        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=feed, args=item) for item in tenants.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join(INGEST_WAIT)
            feed_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            feed_counts = ops.launch_counts()
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"the feed failed: {errors}")
            for tid, tl in tenants.items():
                if acked.get(tid) != len(tl):  # the watermark passes the last line sent
                    raise AssertionError(f"{tid}: acked {acked.get(tid)} of {len(tl)} lines")
            healthy(daemon, "the feed")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            drained = daemon.shutdown(timeout=INGEST_WAIT)
            torch.cuda.synchronize()
            drain_s = time.perf_counter() - t0
        finally:
            daemon.shutdown(timeout=INGEST_WAIT)
        drain_counts = ops.launch_counts()
        healthy(daemon, "the drain")
        if not drained:
            raise AssertionError("a tenant worker did not finish its drain in time")
        used_kernels(feed_counts, "the daemon's feed")
        used_kernels(drain_counts, "the drain and its compactions")
        n_fed = sum(len(tl) for tl in tenants.values())
        for tid, tl in tenants.items():
            res = rolled.get(tid) or {}
            if "sealed" not in res:
                raise AssertionError(f"{tid}: the retention hook did not seal it: {res}")
            if read(res["sealed"]) != tl:
                raise AssertionError(f"{tid}: the sealed archive does not decode to its lines")
        sizes = {tid: rolled[tid]["report"]["bytes_out"] for tid in tenants}
        log(f"[ingest] feed: {len(tenants)} tenants x {INGEST_TENANT_LINES} HDFS lines over "
            f"one unix socket on {device}, {feed_s:.2f} s, {n_fed / feed_s:.0f} lines/s, every "
            f"line acked; drain (seal, then compact into the sealed tier) {drain_s:.2f} s; "
            f"seconds per compaction {json.dumps({t: round(v, 2) for t, v in roll_s.items()})}; "
            f"sealed bytes {json.dumps(sizes)}; each sealed archive decodes to its lines; no "
            f"tenant failure, no breaker open")
        log(f"[ingest] launches in the feed: {json.dumps(feed_counts)}; in the drain: "
            f"{json.dumps(drain_counts)}")

        # -- the CLI, each verb a process of its own: serve and pack start
        # here and run beside the crash leg and the twin
        t_cli = time.perf_counter()
        cdir = work / "cli"
        sroot = cdir / "serve"
        sroot.mkdir(parents=True)
        tl = lines[:INGEST_CLI_LINES]
        src = cdir / "in.log"
        src.write_text("\n".join(tl), encoding="utf-8", errors="surrogateescape")
        ssock = socket_in(sroot)
        serve = cli("serve", str(sroot), "--socket", ssock, "--chunk-lines",
                    str(STREAM_CHUNK_LINES), "--retention", "--rollup-after", "2",
                    "--device", device, background=True)
        pack = None
        try:
            pack = cli("pack", str(src), str(cdir / "a.lzj"), "--format", fmt,
                       "--device", device, background=True)
            # -- the crash leg: a forced abort halfway, a fresh daemon, a resend
            croot = work / "crash"
            croot.mkdir()
            csock = socket_in(croot)
            cl = lines[:INGEST_CRASH_LINES]
            t0 = time.perf_counter()
            d1 = IngestDaemon(str(croot), csock, device=device,
                              chunk_lines=STREAM_CHUNK_LINES).start()
            c = IngestClient(csock, "crash", cfg=hello, timeout=INGEST_WAIT)
            sent = []

            def send_all():
                try:
                    for line in cl:
                        c.send(line)
                        sent.append(1)
                except (ProtocolError, OSError):
                    pass  # the abort closed the connection under the sender

            sender = threading.Thread(target=send_all)
            try:
                sender.start()
                deadline = time.monotonic() + INGEST_WAIT
                while c.acked < len(cl) // 2:
                    if time.monotonic() > deadline or c.error is not None:
                        raise AssertionError(f"the crash tenant's acks stalled at {c.acked}")
                    time.sleep(0.01)
                first = threading.Thread(target=d1.shutdown, args=(INGEST_WAIT,))
                first.start()  # the first signal drains ...
                d1.shutdown(INGEST_WAIT)  # ... the second aborts, crash-equivalent
                first.join(INGEST_WAIT)
                sender.join(INGEST_WAIT)
                at_abort = c.acked
            finally:
                d1.shutdown(INGEST_WAIT)
                c.close()
            d2 = IngestDaemon(str(croot), csock, device=device,
                              chunk_lines=STREAM_CHUNK_LINES).start()
            try:
                with IngestClient(csock, "crash", cfg=hello, timeout=INGEST_WAIT) as c2:
                    resume_at = c2.next_seq
                    if not (c2.resumed and at_abort <= resume_at <= len(cl)):
                        raise AssertionError(f"the handshake resumes at {resume_at}, "
                                             f"{at_abort} lines were acked")
                    for line in cl[resume_at:]:
                        c2.send(line)
                    c2.wait_ack(len(cl) - 1, timeout=INGEST_WAIT)
                healthy(d2, "the resumed daemon")
            finally:
                if not d2.shutdown(INGEST_WAIT):
                    raise AssertionError("the resumed daemon did not drain in time")
            if read(croot / "crash.lzjs") != cl:
                raise AssertionError("the resumed tenant's archive does not hold every line once")
            log(f"[ingest] crash leg: {len(cl)} lines, {len(sent)} sent when both signals came at "
                f"{at_abort} acked; a fresh daemon's handshake resumed at {resume_at}, "
                f"{len(cl) - resume_at} lines re-sent; the archive holds every line once, in "
                f"order ({time.perf_counter() - t0:.2f} s)")

            # -- the twin: phase 8's clean archive compacted on the card and, at
            # the same time in a process of its own, its CPU twin's on the CPU
            twin_cpu = subprocess.Popen(
                [sys.executable, "-c", TWIN_MAIN, str(twins / "cpu.lzjs"),
                 str(twins / "cpu-compact.lzjs")],
                cwd=str(ROOT), text=True,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            try:
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                compact([str(twins / "main.lzjs")], str(twins / "main-compact.lzjs"),
                        device=device)
                main_s = time.perf_counter() - t0
                compact_counts = ops.launch_counts()
                out, err = twin_cpu.communicate(timeout=INGEST_WAIT)
            finally:
                if twin_cpu.poll() is None:
                    twin_cpu.kill()
                    twin_cpu.communicate()
            if twin_cpu.returncode != 0:
                raise AssertionError(f"the CPU twin failed: {err[-2000:]}")
            cpu_s = json.loads(out.splitlines()[-1])
            used_kernels(compact_counts, "the twin's compact")
            blob = (twins / "main-compact.lzjs").read_bytes()
            if blob != (twins / "cpu-compact.lzjs").read_bytes():
                raise AssertionError(f"compact's archive differs between {device} and cpu")
            if read(twins / "main-compact.lzjs") != lines[:DURABLE_LINES]:
                raise AssertionError("the compacted twin does not decode to its lines")
            log(f"[ingest] twin: phase 8's clean archive ({DURABLE_LINES} lines) compacted in "
                f"{main_s:.2f} s on {device}, {cpu_s:.2f} s on cpu, {len(blob)} equal bytes; "
                f"launches {json.dumps(compact_counts)}")

            rc, out, err, packed = cli_result(pack, INGEST_WAIT)
            if rc != 0:
                raise AssertionError(f"pack exited {rc}: {err[-2000:]}")
            used_kernels(packed, "pack")
            log(f"[ingest] cli pack --device {device}: {out.strip()}")
            after = {"unpack": cli("unpack", str(cdir / "a.lzj"), str(cdir / "back.log"),
                                   background=True)}
            after.update({d: cli("agg", str(cdir / "a.lzj"), "--by-template", "--device", d,
                                 background=True) for d in (device, "cpu")})
            after = {k: cli_result(p, INGEST_WAIT) for k, p in after.items()}
            if after["unpack"][0] != 0 or (cdir / "back.log").read_bytes() != src.read_bytes():
                raise AssertionError(f"unpack exited {after['unpack'][0]} or its output "
                                     f"differs from the input: {after['unpack'][2][-2000:]}")
            agg = after[device]
            if agg[0] != 0 or agg[1] != after["cpu"][1] or not agg[3].get("distinct_counts"):
                raise AssertionError(f"agg --device {device} differs from --device cpu or "
                                     f"launched no distinct_counts: {agg[2][-2000:]}")
            log(f"[ingest] cli unpack: equal bytes; agg --by-template: "
                f"{len(agg[1].splitlines())} rows, equal to --device cpu's; launches "
                f"{json.dumps(agg[3])}")
            deadline = time.monotonic() + INGEST_WAIT
            while not Path(ssock).exists():
                if serve.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("serve never bound its socket")
                time.sleep(0.05)
            sl = lines[:SERVE_LINES]
            with IngestClient(ssock, "t", cfg=hello, timeout=INGEST_WAIT) as c3:
                for line in sl:
                    c3.send(line)
                c3.wait_ack(len(sl) - 1, timeout=INGEST_WAIT)
        finally:
            if pack is not None and pack.poll() is None:
                pack.kill()
                pack.communicate()
            if serve.poll() is None:
                serve.send_signal(signal.SIGTERM)  # the first signal drains
            rc, out, err, served = cli_result(serve, INGEST_WAIT)
        if rc != 0 or not out.rstrip().endswith("drained"):
            raise AssertionError(f"serve exited {rc} after SIGTERM: {out[-500:]} {err[-2000:]}")
        used_kernels(served, "serve")
        if read(sroot / "sealed" / "t.00000.lzjs") != sl:
            raise AssertionError("serve's sealed archive does not decode to its lines")
        log(f"[ingest] cli serve --retention --device {device}: {len(sl)} lines acked, SIGTERM "
            f"-> exit 0, 'drained', the sealed archive decodes to the lines; launches "
            f"{json.dumps(served)}; from serve's start {time.perf_counter() - t_cli:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[ingest] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return feed_counts


def pipeline_phase(torch) -> dict:
    """Phase 10: ``data.pipeline`` on the card -> the launch counts of the
    two writes on "cuda".

    ``PIPE_LINES`` Spark lines (loggen, seed 0) through
    ``write_logzip_shards`` and ``write_logzip_stream``, once on "cuda" and
    once on "cpu": every shard file, the LZJS container and both manifests
    equal byte for byte; ``wildcard_match_first`` and
    ``colcodec_transform`` launched in each card write. A ``TokenBatcher``
    on the card, bytes mode, against its ``device="cpu"`` twin over
    ``PIPE_BATCHES`` (8, 256) batches, and resumed from its ``state_dict``
    at batch 10; events mode the same. ``PrefetchLoader`` serves every
    shard of both layouts once."""
    from repro_torch.core.codec import LogzipConfig
    from repro_torch.core.ise import ISEConfig
    from repro_torch.data import pipeline
    from repro_torch.data.loggen import DATASETS, generate_lines
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    lines = list(generate_lines("Spark", PIPE_LINES, seed=0))
    root = Path(tempfile.mkdtemp(prefix="pipeline-", dir=ROOT / "build"))
    try:
        written, counts = {}, {}
        for device in ("cuda", "cpu"):
            cfg = LogzipConfig(level=3, format=DATASETS["Spark"]["format"],
                               ise=ISEConfig(min_sample=300), device=device)
            for kind, writer in (("files", pipeline.write_logzip_shards),
                                 ("stream", pipeline.write_logzip_stream)):
                out = root / device / kind
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                manifest = writer(iter(lines), str(out), shard_lines=PIPE_SHARD_LINES, cfg=cfg)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if device == "cuda":
                    counts[kind] = ops.launch_counts()
                written[device, kind] = (out, manifest)
                log(f"[pipeline] {writer.__name__} on {device}: {len(lines)} lines, "
                    f"{len(manifest['shards'])} shards, {manifest['compressed_bytes']} bytes "
                    f"(ratio {manifest['raw_bytes'] / manifest['compressed_bytes']:.3f}) in "
                    f"{dt:.3f} s, {len(lines) / dt:.0f} lines/s"
                    + (f"; launches {json.dumps(counts[kind])}" if device == "cuda" else ""))
        for kind in ("files", "stream"):
            (gd, gman), (cd, cman) = written["cuda", kind], written["cpu", kind]
            if gman != cman:
                raise AssertionError(f"the {kind} manifests differ between cuda and cpu")
            names = sorted(os.listdir(gd))
            if names != sorted(os.listdir(cd)):
                raise AssertionError(f"the {kind} writes made different files: {names}")
            for name in names:
                if (gd / name).read_bytes() != (cd / name).read_bytes():
                    raise AssertionError(f"{kind}/{name} differs between cuda and cpu")
            need = [k for k in ("wildcard_match_first", "colcodec_transform")
                    if counts[kind][k] == 0]
            if need:
                raise AssertionError(f"the {kind} write on the card launched no {need}")
            log(f"[pipeline] {kind}: {len(names)} files equal byte for byte on cuda and cpu, "
                f"manifests equal")

        for kind in ("files", "stream"):
            for mode in ("bytes", "events"):
                card = pipeline.TokenBatcher(str(written["cuda", kind][0]), mode=mode, seed=0,
                                             device="cuda")
                host = pipeline.TokenBatcher(str(written["cpu", kind][0]), mode=mode, seed=0,
                                             device="cpu")
                got, state = [], None
                for i in range(PIPE_BATCHES):
                    if i == PIPE_BATCHES // 2:
                        state = card.state_dict()
                        if state != host.state_dict():
                            raise AssertionError(f"{kind}/{mode}: batcher states differ")
                    g, h = card.next_batch(8, 256), host.next_batch(8, 256)
                    for key in ("tokens", "labels"):
                        t = g[key]
                        if not (t.is_cuda and t.dtype == torch.int32 and t.shape == (8, 256)):
                            raise AssertionError(f"{kind}/{mode}: a {key} batch is {t.dtype} "
                                                 f"{tuple(t.shape)} on {t.device}")
                        if not torch.equal(t.cpu(), h[key]):
                            raise AssertionError(f"{kind}/{mode}: batch {i} {key} differs")
                    got.append(g)
                again = pipeline.TokenBatcher(str(written["cuda", kind][0]), mode=mode, seed=0,
                                              device="cuda")
                again.load_state_dict(state)
                for i in range(PIPE_BATCHES // 2, PIPE_BATCHES):
                    g = again.next_batch(8, 256)
                    if not (torch.equal(g["tokens"], got[i]["tokens"])
                            and torch.equal(g["labels"], got[i]["labels"])):
                        raise AssertionError(f"{kind}/{mode}: the resumed batch {i} differs")
                log(f"[pipeline] TokenBatcher {kind}/{mode}: {PIPE_BATCHES} (8, 256) int32 "
                    f"batches on the card equal to device='cpu', and from a resume at batch "
                    f"{PIPE_BATCHES // 2}")

        paths = [str(written["cuda", kind][0] / s["file"]) for kind in ("files", "stream")
                 for s in written["cuda", kind][1]["shards"]]
        n_lines = {str(written["cuda", kind][0] / s["file"]): s["n_lines"]
                   for kind in ("files", "stream") for s in written["cuda", kind][1]["shards"]}
        loader = pipeline.PrefetchLoader(paths, pipeline.read_shard, depth=2, workers=2)
        served = []
        for path, data in loader:
            served.append(path)
            if len(data) != n_lines[path]:
                raise AssertionError(f"PrefetchLoader served {len(data)} lines of {path}")
        loader.close()
        if sorted(served) != sorted(paths):
            raise AssertionError(f"PrefetchLoader served {served}, not each of {paths} once")
        log(f"[pipeline] PrefetchLoader served each of {len(paths)} shards once "
            f"({json.dumps(loader.stats)})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[pipeline] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def serving_phase(np, torch, profile, activity, card: str) -> dict:
    """Phase 11: ``SERVE_ARCH`` at full width on the card -> the serve's
    figures.

    (a) fp32 weights: prefill half of a (2, 64) prompt and decode the
    rest; the logits equal ``forward``'s at the same positions within
    ``CACHE_REL`` of the largest |logit|, TF32 off. (b) the full width at
    2 layers in fp32, carried to the CPU through ``weights``: prefill and
    8 greedy decode steps on both, logits within ``TWIN_REL``, tokens
    equal. (c) bf16: 8 requests as 2 batches of 4, prompt 512, 32 new
    tokens, greedy, through ``launch.serve.serve_requests``, after one
    untimed batch; then 8 decode steps of a batch under ``torch.profiler``
    for the device's busy time and idle share. (d) ``python -m repro_torch.launch.serve --device cuda
    --requests 8`` as a process."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as fa
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.models.weights import from_reference, to_reference

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             cfg.qk_norm, cfg.padded_vocab, cfg.family, cfg.dtype)
    if shape != (28, 2048, 16, 8, 128, True, 152_064, "dense", "bfloat16"):
        raise AssertionError(f"{SERVE_ARCH} is not the full-width config: {shape}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: fp32 parity would not hold")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(SERVE_SEED)

    def gen():
        return torch.Generator(device=dev).manual_seed(SERVE_SEED)

    # (a) the cache against the forward, 28 layers in fp32
    t0 = time.perf_counter()
    model = init_params(cfg32, gen(), device=dev)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 64)).astype(np.int32)).to(dev)
    full, _ = forward(model, {"tokens": toks})
    logits, cache = prefill(model, {"tokens": toks[:, :32]}, 64)
    seq = [logits]
    for t in range(32, 64):
        logits, cache = decode_step(model, cache, toks[:, t:t + 1])
        seq.append(logits)
    got, want = torch.stack(seq[:-1], dim=1), full[:, 31:63]
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not (torch.isfinite(got).all() and err <= CACHE_REL * scale):
        raise AssertionError(f"(a) prefill + decode differ from forward by {err} "
                             f"(max |logit| {scale}, tolerance {CACHE_REL} of it)")
    torch.cuda.synchronize()
    log(f"[serve] (a) {SERVE_ARCH} full width, fp32, TF32 off: prefill 32 + 32 decode steps "
        f"against forward over (2, 64): max |diff| {err:.3e}, {err / scale:.3e} of max |logit| "
        f"{scale:.3f} (tolerance {CACHE_REL}); {time.perf_counter() - t0:.1f} s on {card}")
    prompt32 = toks[:, :32]
    del model, full, cache, seq, got, want

    # (b) the CPU twin: 2 layers at full width, fp32, the same weights
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg32, n_layers=2)
    on_card = init_params(cfg2, gen(), device=dev)
    on_host = from_reference(cfg2, to_reference(on_card), device="cpu")
    outs = {}
    for label, model in (("cuda", on_card), ("cpu", on_host)):
        logits, cache = prefill(model, {"tokens": prompt32.to(model.device)}, 48)
        steps, tokens = [logits.cpu()], []
        for _ in range(8):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            tokens.append(tok.cpu())
            logits, cache = decode_step(model, cache, tok)
            steps.append(logits.cpu())
        outs[label] = (torch.stack(steps, dim=1), torch.cat(tokens, dim=1))
    (lg, tg), (lc, tc) = outs["cuda"], outs["cpu"]
    err, scale = float((lg - lc).abs().max()), float(lc.abs().max())
    if not (torch.equal(tg, tc) and err <= TWIN_REL * scale):
        raise AssertionError(f"(b) card and CPU differ: tokens equal {torch.equal(tg, tc)}, "
                             f"max |diff| {err} (max |logit| {scale}, tolerance {TWIN_REL})")
    log(f"[serve] (b) 2 layers at full width, fp32, card against CPU: prefill + 8 decode "
        f"steps, max |diff| {err:.3e}, {err / scale:.3e} of max |logit| (tolerance "
        f"{TWIN_REL}); greedy tokens equal {tg.tolist()}; {time.perf_counter() - t0:.1f} s on "
        f"{card}")
    del on_card, on_host, outs

    # (c) the timed serve in bf16
    t0 = time.perf_counter()
    model = init_params(cfg, gen(), device=dev)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    serve_requests(model, 4, 4, 512, 4, np.random.default_rng(1), log=lambda m: None)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    out = serve_requests(model, 8, 4, 512, 32, np.random.default_rng(SERVE_SEED),
                         log=lambda m: log(f"[serve] (c) {m}"))
    peak = torch.cuda.max_memory_allocated()
    attn_launches = (fa.forward_launches(), fa.backward_launches())
    toks = torch.cat(out["tokens"])
    if not (toks.shape == (8, 32) and int(toks.min()) >= 0 and
            int(toks.max()) < cfg.padded_vocab):
        raise AssertionError(f"(c) served tokens out of range: {tuple(toks.shape)}")
    n_batches = len(out["tokens"])
    # a prefill runs the attention kernel once a layer, the decode never
    if attn_launches != (n_batches * cfg.n_layers, 0):
        raise AssertionError(f"(c) {n_batches} prefills of {cfg.n_layers} layers launched the "
                             f"attention kernel (forward, backward) {attn_launches} times")
    # the bytes a decode step must move: every weight but the embedding
    # table, of which it gathers B rows (the table is read whole as the
    # unembedding when tied); each layer's K/V: kv_len - 1 valid slots read
    # and the new one written, kv_len = pos + 1 averaged over this run's
    # steps (513..543); the logits written
    bsz, plen, new = 4, 512, 32
    elt = model.embed.element_size()
    embed_bytes = model.embed.numel() * elt
    kv_len_mean = plen + 1 + (new - 2) / 2
    slot = cfg.n_kv_heads * cfg.head_dim * elt
    step_bytes = (weight_bytes - (0 if cfg.tie_embeddings else embed_bytes)
                  + bsz * cfg.d_model * elt
                  + cfg.n_layers * 2 * bsz * slot * kv_len_mean
                  + bsz * cfg.padded_vocab * elt)
    stats = {"prefill_ms": out["prefill_s"] / n_batches * 1e3,
             "decode_ms_a_step": out["decode_s"] / out["decode_steps"] * 1e3,
             "tok_per_s": out["tok_per_s"], "seconds": out["seconds"],
             "weight_bytes": weight_bytes, "params": n_params, "peak_bytes": peak,
             "decode_step_bytes": step_bytes,
             "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
             "weights_over_hbm_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    log(f"[serve] (c) {SERVE_ARCH} bf16, {n_params} parameters, 8 requests as 2 batches of "
        f"4, prompt 512, 32 new tokens, greedy, on {card}: prefill "
        f"{stats['prefill_ms']:.3f} ms a batch of 4 x 512, decode "
        f"{stats['decode_ms_a_step']:.3f} ms a step of 4, {stats['tok_per_s']:.1f} tokens/s "
        f"over {out['seconds']:.3f} s; weights {weight_bytes} bytes; "
        f"max_memory_allocated {peak} bytes; decode bound (the {step_bytes:.0f} bytes a step "
        f"reads and writes over 3.35 TB/s: weights but the embedding table, 4 of its rows, "
        f"K/V at a mean kv_len of {kv_len_mean}) {stats['decode_bound_ms']:.4f} ms a step, the "
        f"step at {stats['decode_ms_a_step'] / stats['decode_bound_ms']:.2f}x it (all the "
        f"weights' bytes over 3.35 TB/s: {stats['weights_over_hbm_ms']:.4f} ms, "
        f"{stats['decode_ms_a_step'] / stats['weights_over_hbm_ms']:.2f}x); "
        f"{time.perf_counter() - t0:.1f} s with set-up")

    # decode_attention's fp32 copy of the whole cache, at the timed serve's
    # cache (4 x 544 slots) and mean kv_len: device time of one layer's
    # call and of its two cache converts alone (CUDA graph, CUDA events),
    # times the layers for a step
    from repro_torch.models.layers import decode_attention
    gcache = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    kv_shape = (bsz, plen + new, cfg.n_kv_heads, cfg.head_dim)
    kc, vc = (torch.randn(kv_shape, generator=gcache, device=dev).to(torch.bfloat16)
              for _ in range(2))
    q1 = torch.randn((bsz, 1, cfg.n_heads, cfg.head_dim), generator=gcache,
                     device=dev).to(torch.bfloat16)
    kvl = torch.full((bsz,), int(kv_len_mean), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        attn_ms = kernel_device_ms(torch, decode_attention, (q1, kc, vc, kvl), 20)
        conv_ms = kernel_device_ms(torch, lambda k, v: (k.float(), v.float()), (kc, vc), 20)
    stats.update(decode_attention_ms_a_step=attn_ms * cfg.n_layers,
                 cache_convert_ms_a_step=conv_ms * cfg.n_layers)
    log(f"[serve] (c) decode_attention at a (4, 544, 8, 128) bf16 cache, kv_len "
        f"{int(kv_len_mean)}: {attn_ms:.5f} ms a layer, of which the fp32 copy of K and V "
        f"{conv_ms:.5f} ms; x {cfg.n_layers} layers {attn_ms * cfg.n_layers:.4f} and "
        f"{conv_ms * cfg.n_layers:.4f} ms a step (CUDA graph, CUDA events); on {card}")
    del kc, vc, q1

    # the card's share of a decode step: 8 steps under the profiler
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (4, 512)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    fa.reset_launches()
    with profile(activities=[activity.CUDA]) as prof:  # the prefill's attention on the card
        logits, cache = prefill(model, {"tokens": prompt}, 512 + 9)
        torch.cuda.synchronize()
    attn = {name: cu for name, cu in device_us(prof).items() if "attn_fwd" in name}
    seen = sum(c for c, _ in attn.values())
    if fa.forward_launches() != cfg.n_layers or seen != cfg.n_layers:
        raise AssertionError(f"a prefill of {cfg.n_layers} layers: {fa.forward_launches()} "
                             f"attention launches counted, {seen} seen by the profiler")
    stats["attention"] = {"launches": attn_launches[0], "prefills": n_batches,
                          "profiled_prefill_launches": seen,
                          "profiled_prefill_device_ms": sum(us for _, us in attn.values()) / 1e3}
    log(f"[serve] (c) the attention kernel: {attn_launches[0]} forward launches in the timed "
        f"serve's {n_batches} prefills, {attn_launches[1]} backward; one prefill of (4, 512) "
        f"under torch.profiler: {seen} launches, "
        f"{stats['attention']['profiled_prefill_device_ms']:.4f} device ms; on {card}")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[activity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            logits, cache = decode_step(model, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_us(prof)
    busy_ms = sum(us for _, us in busy.values()) / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1][1])[:5]
    stats.update(profiled_decode_ms_a_step=wall_ms / 8, device_busy_ms_a_step=busy_ms / 8,
                 decode_idle_share=1 - busy_ms / wall_ms)
    log(f"[serve] (c) 8 decode steps under torch.profiler: {wall_ms / 8:.3f} ms a step, the "
        f"device busy {busy_ms / 8:.3f} ms of it (idle share {1 - busy_ms / wall_ms:.4f}; "
        f"{sum(c for c, _ in busy.values())} device ops); the busiest: "
        + "; ".join(f"{name[:60]} x{c} {us / 1e3:.3f} ms" for name, (c, us) in top)
        + f"; on {card}")
    del model, cache

    # (d) the serve CLI as a process
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cuda",
                           "--requests", "8"], cwd=str(ROOT), capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"(d) the serve CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"[serve] (d) python -m repro_torch.launch.serve --device cuda --requests 8: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s on {card}; {proc.stdout.strip().splitlines()[-1]}")
    log(f"[serve] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return stats


def _flat_leaves(tree, prefix=""):
    """A checkpoint tree (nested dicts) -> {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _train_argv(workdir: Path) -> list[str]:
    """Phase 13's launcher flags: the default arch at full width on the card,
    no checkpoint before the end but a preemption's."""
    return ["--device", "cuda", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--workdir", str(workdir),
            "--ckpt-every", str(TRAIN_STEPS + 1)]


def _train_process(workdir: Path):
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                             *_train_argv(workdir)], cwd=str(ROOT),
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def training_phase(np, torch, profile, activity, card: str) -> dict:
    """Phase 13: ``TRAIN_ARCH`` trained at full width on the card by the
    port's launcher -> the phase's figures.

    (a) Run A: ``launch.train.main`` in this process, ``TRAIN_STEPS`` steps
    of (8, 256) uninterrupted, after its 40,000-line shard write on the card
    (``wildcard_match_first`` and ``colcodec_transform`` must launch; the
    counts set to 0 just before). Run B, a process on a copy of A's shards:
    SIGTERM after its first step line, a preemption checkpoint at step
    k + 1 < N and exit 0, relaunched to N. The final checkpoints: the data
    cursor and ``opt/step`` equal; every parameter within twice the most
    AdamW can move it over the run, 2 sum(lr_t) (1 + wd max|p|), plus one
    bf16 ulp of the leaf's largest |value| (the embedding's backward
    accumulates with atomics, so the two runs' gradients may differ in
    their last bits, and an element whose gradient is that small can take
    an AdamW step of the other sign). B's preemption checkpoint, which the
    relaunch reads with ``load_checkpoint``, has the leaf names, shapes and
    dtypes of the reference's tree of the model (``weights.to_reference``,
    the moments fp32, ``opt/step`` int32). (b) The arch cut to 2 layers at fp32, one
    init carried to the CPU: the gradients of one batch, then one
    ``make_train_step`` step (lr 6e-4), on the card and on the CPU: each
    within ``TRAIN_TWIN_REL`` of its leaf's largest |value|, the updated
    parameters too but where the CPU's gradient is below 1e-4 of the
    largest (an AdamW first step is lr * sign(g) there: within 2 lr).
    (c) ms a step (median after the first), tokens/s, peak memory, the
    checkpoint's bytes and seconds, the FLOP bound (8 N_params tokens:
    forward, remat forward, backward, over 989 TFLOP/s); a step split into
    its gradients and its update, and two steps under ``torch.profiler``
    (the card's busy time and idle share)."""
    import signal
    import threading

    from repro_torch.checkpoint.ckpt import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenBatcher
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import Transformer, init_params, loss_fn
    from repro_torch.models.weights import to_reference
    from repro_torch.optim.adamw import (
        AdamWHyper,
        adamw_init,
        adamw_update,
        clip_by_global_norm,
    )
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.padded_vocab,
             cfg.qkv_bias, cfg.tie_embeddings, cfg.remat, cfg.dtype)
    if shape != (24, 1024, 16, 64, 2816, 152_064, True, False, True, "bfloat16"):
        raise AssertionError(f"{TRAIN_ARCH} is not the full-width config: {shape}")
    empty = Transformer(cfg, dev)
    n_params = sum(p.numel() for p in empty.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in empty.parameters())
    del empty
    ckpt_bytes = param_bytes + 8 * n_params  # the parameters and two fp32 moments
    (ROOT / "build").mkdir(exist_ok=True)
    free = shutil.disk_usage(ROOT / "build").free
    # at most two checkpoints on disk at once: run A's is read and deleted first
    if free < 2 * ckpt_bytes + 2e9:
        raise RuntimeError(f"phase 13 needs {2 * ckpt_bytes + 2e9:.0f} bytes of disk, "
                           f"{free} are free")
    work = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "build"))
    stats = {"params": n_params, "ckpt_bytes_expected": ckpt_bytes}
    try:
        # (a) run A, in this process, uninterrupted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ran = train_main(_train_argv(work / "a"))
        torch.cuda.synchronize()
        a_seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if not (counts["wildcard_match_first"] > 0 and counts["colcodec_transform"] > 0):
            raise AssertionError(f"run A's shard write launched no kernel: {counts}")
        if not (len(ran["losses"]) == TRAIN_STEPS and all(np.isfinite(ran["losses"]))):
            raise AssertionError(f"run A's losses: {ran['losses']}")
        step_ms = float(np.median(ran["step_seconds"][1:])) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        final_a = work / "a" / "ckpt" / f"step-{TRAIN_STEPS:08d}"
        written = sum(f.stat().st_size for f in final_a.iterdir())
        bound_ms = 8 * n_params * tokens / BF16_FLOP_PER_S * 1e3
        stats.update(launches=counts, run_a_seconds=a_seconds, losses_a=ran["losses"],
                     step_ms=step_ms, first_step_ms=ran["step_seconds"][0] * 1e3,
                     tokens_per_s=tokens / step_ms * 1e3, peak_bytes=peak,
                     ckpt_bytes=written, ckpt_seconds=ran["ckpt_seconds"],
                     flop_bound_ms=bound_ms)
        log(f"[train] (a) run A: {TRAIN_ARCH} full width ({n_params} parameters, bf16), "
            f"{TRAIN_STEPS} steps of ({TRAIN_BATCH}, {TRAIN_SEQ}) through launch.train.main in "
            f"{a_seconds:.1f} s with its 40,000-line shard write; launches "
            f"{json.dumps(counts)}; losses {[round(x, 4) for x in ran['losses']]}; on {card}")
        log(f"[train] (c) {step_ms:.3f} ms a step (median of steps 2-{TRAIN_STEPS}; the first "
            f"{ran['step_seconds'][0] * 1e3:.1f} ms), {tokens / step_ms * 1e3:.1f} tokens/s; "
            f"FLOP bound 8 x {n_params} x {tokens} over 989 TFLOP/s = {bound_ms:.4f} ms, the "
            f"step at {step_ms / bound_ms:.2f}x it; max_memory_allocated {peak} bytes; the "
            f"final checkpoint {written} bytes written in {ran['ckpt_seconds']:.3f} s "
            f"({written / ran['ckpt_seconds'] / 1e9:.3f} GB/s, the device-to-host copy "
            f"included); on {card}")
        # where a step's time goes: the gradients against the update, and the
        # card's busy share of two steps under the profiler
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        opt = adamw_init(model)
        hyper = AdamWHyper(lr=6e-4)
        step = make_train_step(cfg, hyper)
        batch = TokenBatcher(str(work / "a" / "shards"), device=dev).next_batch(TRAIN_BATCH,
                                                                              TRAIN_SEQ)
        model, opt, _ = step(model, opt, batch)  # warm up
        torch.cuda.synchronize()
        params = dict(model.named_parameters())
        t0 = time.perf_counter()
        grads = torch.autograd.grad(loss_fn(model, batch)[0], list(params.values()))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        clipped, _ = clip_by_global_norm(dict(zip(params, grads)), hyper.grad_clip)
        opt = adamw_update(clipped, opt, model, hyper)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads, clipped
        fa.reset_launches()
        with profile(activities=[activity.CUDA]) as prof:
            t3 = time.perf_counter()
            for _ in range(2):
                model, opt, _ = step(model, opt, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t3) * 1e3 / 2
        busy = device_us(prof)
        # a step runs each layer's attention forward twice (the remat
        # recomputes it) and its backward once
        attn_launches = (fa.forward_launches(), fa.backward_launches())
        want = (2 * (2 if cfg.remat else 1) * cfg.n_layers, 2 * cfg.n_layers)
        attn = {name: cu for name, cu in busy.items() if "attn_" in name}
        seen = sum(c for c, _ in attn.values())
        if attn_launches != want or seen != want[0] + 3 * want[1]:
            raise AssertionError(f"two steps launched the attention kernel (forward, backward) "
                                 f"{attn_launches} times, not {want}; the profiler saw {seen} "
                                 f"of its kernels")
        stats["attention"] = {"launches": attn_launches, "profiled_steps": 2,
                              "profiled_kernels": seen,
                              "device_ms_a_step": sum(us for _, us in attn.values()) / 2e3}
        log(f"[train] (c) the attention kernel over two profiled steps: {attn_launches[0]} "
            f"forward launches, {attn_launches[1]} backward passes ({seen} kernels seen by the "
            f"profiler), {stats['attention']['device_ms_a_step']:.4f} device ms a step; on "
            f"{card}")
        busy_ms = sum(us for _, us in busy.values()) / 1e3 / 2
        n_ops = sum(c for c, _ in busy.values()) // 2
        top = sorted(busy.items(), key=lambda kv: -kv[1][1])[:5]
        stats.update(grad_ms=(t1 - t0) * 1e3, update_ms=(t2 - t1) * 1e3,
                     profiled_step_ms=wall_ms, device_busy_ms_a_step=busy_ms,
                     idle_share=1 - busy_ms / wall_ms, device_ops_a_step=n_ops)
        log(f"[train] (c) a step's parts, synchronised: loss and gradients {(t1 - t0) * 1e3:.3f} "
            f"ms, clipping and AdamW over {len(params)} leaves {(t2 - t1) * 1e3:.3f} ms; two steps "
            f"under torch.profiler: {wall_ms:.3f} ms a step, the device busy {busy_ms:.3f} ms of "
            f"it (idle share {1 - busy_ms / wall_ms:.4f}, {n_ops} device ops a step); the "
            f"busiest: " + "; ".join(f"{name[:60]} x{c // 2} {us / 2e3:.3f} ms"
                                     for name, (c, us) in top) + f"; on {card}")
        del model, opt, params, batch, prof
        torch.cuda.empty_cache()

        # run B: a process preempted by SIGTERM after its first step line, then
        # resumed; run A's final checkpoint is read meanwhile, then deleted
        shutil.copytree(work / "a" / "shards", work / "b" / "shards")
        got_a, got_b = {}, {}

        def read(ckpt: Path, into: dict):
            tree, into["extra"], into["step"] = load_checkpoint(str(ckpt), device="cpu")
            into["leaves"] = _flat_leaves(tree)

        reader = threading.Thread(target=read, args=(work / "a" / "ckpt", got_a))
        t0 = time.perf_counter()
        proc = _train_process(work / "b")
        reader.start()
        try:
            first = proc.stdout.readline()
            if not first.startswith("step     0"):
                raise AssertionError(f"run B printed {first!r} first: {proc.stderr.read()[-2000:]}")
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        pre = [ln for ln in out.splitlines() if ln.startswith("preemption checkpoint at step ")]
        if proc.returncode != 0 or len(pre) != 1:
            raise AssertionError(f"run B's preemption: exit {proc.returncode}, {out[-1000:]} "
                                 f"{err[-2000:]}")
        k1 = int(pre[0].split()[4])
        if not 0 < k1 < TRAIN_STEPS:
            raise AssertionError(f"run B's preemption checkpoint is at step {k1}")
        b1_seconds = time.perf_counter() - t0
        reader.join()
        if "leaves" not in got_a:
            raise AssertionError("run A's final checkpoint could not be read")
        shutil.rmtree(work / "a" / "ckpt")
        t0 = time.perf_counter()
        proc = _train_process(work / "b")
        out2, err2 = proc.communicate(timeout=300)
        if proc.returncode != 0 or f"resumed from step {k1} (sample-exact)" not in out2:
            raise AssertionError(f"run B's resume: exit {proc.returncode}, {out2[-1000:]} "
                                 f"{err2[-2000:]}")
        b2_seconds = time.perf_counter() - t0
        stats.update(preempted_at=k1, run_b_seconds=[b1_seconds, b2_seconds])
        log(f"[train] (a) run B: SIGTERM after its first step line, preemption checkpoint at "
            f"step {k1}, exit 0 ({b1_seconds:.1f} s); relaunched, resumed from step {k1} to "
            f"{TRAIN_STEPS} ({b2_seconds:.1f} s); on {card}")
        # run B's final checkpoint is read while (b) runs
        reader = threading.Thread(target=read, args=(work / "b" / "ckpt", got_b))
        reader.start()

        # B's preemption checkpoint, which the relaunch read with load_checkpoint
        # (its leaves' shapes and dtypes held to the model's): the reference's layout
        with open(work / "b" / "ckpt" / f"step-{k1:08d}" / "manifest.json") as f:
            manifest = json.load(f)["leaves"]
        model = Transformer(cfg, dev)  # the shapes and dtypes; no values needed
        kind = {name.rsplit(".", 1)[-1]: str(p.dtype).replace("torch.", "")
                for name, p in model.named_parameters()}
        ref = _flat_leaves(to_reference(model))
        del model
        want = {}
        for path, a in ref.items():
            want[f"params/{path}"] = [list(a.shape), kind[path.rsplit("/", 1)[-1]]]
            want[f"opt/mu/{path}"] = want[f"opt/nu/{path}"] = [list(a.shape), "float32"]
        want["opt/step"] = [[], "int32"]
        got = {k: [v["shape"], v["dtype"]] for k, v in manifest.items()}
        if got != want:
            bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
            raise AssertionError(f"run B's preemption checkpoint is not in the reference's "
                                 f"layout: {bad[:8]}")
        log(f"[train] (a) run B's preemption checkpoint (step {k1}): {len(manifest)} leaves "
            f"with the names, shapes and dtypes of the reference's tree of the model "
            f"(bf16 parameters, fp32 norms and moments, opt/step int32); the relaunch read it "
            f"with load_checkpoint")

        stats.update(_train_twin(np, torch, cfg, card))  # (b)

        reader.join()
        if "leaves" not in got_b:
            raise AssertionError("run B's final checkpoint could not be read")
        stats.update(_compare_runs(torch, got_a, got_b, hyper, card))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[train] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return stats


def _compare_runs(torch, got_a: dict, got_b: dict, hyper, card: str) -> dict:
    """Phase 13 (a): run A's final checkpoint against run B's: the data
    cursor and the step exact, each parameter within twice the most AdamW
    can move it over the run, plus a bf16 ulp of its leaf's largest
    |value|."""
    (la, ea, sa), (lb, eb, sb) = ((g["leaves"], g["extra"], g["step"]) for g in (got_a, got_b))
    if not (sa == sb == TRAIN_STEPS and ea == eb
            and int(la["opt/step"]) == int(lb["opt/step"]) == TRAIN_STEPS):
        raise AssertionError(f"runs A and B end apart: steps {sa}, {sb}, data {ea} / {eb}")
    if la.keys() != lb.keys():
        raise AssertionError("runs A and B saved different leaves")
    lr_sum = sum(hyper.lr * t / 20 for t in range(TRAIN_STEPS))  # cosine_schedule's warmup
    worst, differ, identical = 0.0, 0, True
    for k in la:
        a, b = la[k], lb[k]
        if a.dtype != b.dtype:
            raise AssertionError(f"{k}: {a.dtype} in run A, {b.dtype} in run B")
        if torch.equal(a, b):
            continue
        identical = False
        if k.startswith("params/"):
            d = float((a.float() - b.float()).abs().max())
            top = float(a.float().abs().max())
            tol = 2 * lr_sum * (1 + hyper.weight_decay * top) + top * 2.0 ** -7
            if d > tol:
                raise AssertionError(f"{k}: runs A and B differ by {d} (tolerance {tol})")
            worst = max(worst, d / tol)
            differ += 1
    mom = max(float((la[k].float() - lb[k].float()).abs().max()
                    / max(float(la[k].float().abs().max()), 1e-30))
              for k in la if k.startswith("opt/mu/") or k.startswith("opt/nu/"))
    data = ea["data"]
    cursor = (data["epoch"], data["shard_pos"], data["line_pos"], len(data["carry"]))
    log(f"[train] (a) final checkpoints of A and B: data cursor (epoch, shard, line, carry) "
        f"{cursor} and opt/step {TRAIN_STEPS} equal; bit-identical {identical}; {differ} "
        f"parameter leaves differ, the worst at {worst:.3e} of its tolerance (2 sum(lr) (1 + wd "
        f"max|p|) + a bf16 ulp of max|p|, sum(lr) {lr_sum:.3e}); the moments' largest "
        f"difference {mom:.3e} of their leaf's max; on {card}")
    return {"a_b_bit_identical": identical, "a_b_param_leaves_differing": differ,
            "a_b_worst_share_of_tolerance": worst, "a_b_moment_rel": mom}


def _train_twin(np, torch, cfg, card: str) -> dict:
    """Phase 13 (b): the arch cut to 2 layers at fp32, one init on the card
    carried to the CPU: the gradients of one batch and one
    ``make_train_step`` step (lr 6e-4) on both, held within
    ``TRAIN_TWIN_REL`` of each leaf's largest |value|, the updated
    parameters too but where the CPU's gradient is below 1e-4 of the
    largest (an AdamW first step is lr * sign(g) there: within 2 lr)."""
    import dataclasses

    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.weights import from_reference, to_reference
    from repro_torch.optim.adamw import AdamWHyper, adamw_init
    from repro_torch.train.steps import make_train_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: fp32 parity would not hold")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    on_card = init_params(cfg2, torch.Generator(device=dev).manual_seed(0), device=dev)
    on_host = from_reference(cfg2, to_reference(on_card), device="cpu")
    rng = np.random.default_rng(13)
    toks = rng.integers(3, 259, (2, 65)).astype(np.int32)  # byte tokens, as the launcher's
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    hyper = AdamWHyper(lr=6e-4)
    res = {}
    for label, model in (("cuda", on_card), ("cpu", on_host)):
        tb = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss_fn(model, tb)[0], list(params.values()))
        grads = {k: g.cpu() for k, g in zip(params, grads)}
        model, opt, m = make_train_step(cfg2, hyper)(model, adamw_init(model), tb)
        res[label] = (grads, {k: p.detach().cpu() for k, p in model.named_parameters()},
                      float(m["loss"]), float(m["grad_norm"]))
    del on_card, on_host, model, opt
    (gg, pg, lg, ng), (gc, pc, lc, nc) = res["cuda"], res["cpu"]
    if not (abs(lg - lc) <= TRAIN_TWIN_REL * abs(lc) and abs(ng - nc) <= TRAIN_TWIN_REL * nc):
        raise AssertionError(f"(b) loss {lg} / {lc}, grad norm {ng} / {nc} (card / CPU)")
    top_g = max(float(g.abs().max()) for g in gc.values())
    g_err = p_err = 0.0
    flips = 0
    for k in gc:
        scale = float(gc[k].abs().max())
        e = float((gg[k] - gc[k]).abs().max())
        if e > TRAIN_TWIN_REL * scale + 1e-30:
            raise AssertionError(f"(b) gradient of {k}: card and CPU differ by {e} "
                                 f"(max {scale}, tolerance {TRAIN_TWIN_REL} of it)")
        g_err = max(g_err, e / max(scale, 1e-30))
        diff = (pg[k] - pc[k]).abs()
        small = gc[k].abs() < 1e-4 * top_g
        ptop = float(pc[k].abs().max())
        e = float(diff[~small].max()) if bool((~small).any()) else 0.0
        e_small = float(diff[small].max()) if bool(small.any()) else 0.0
        if e > TRAIN_TWIN_REL * ptop or e_small > 2 * hyper.lr + TRAIN_TWIN_REL * ptop:
            raise AssertionError(f"(b) updated {k}: card and CPU differ by {e} (max {ptop}), "
                                 f"{e_small} where |g| < 1e-4 of the largest")
        p_err = max(p_err, e / max(ptop, 1e-30))
        flips += int((diff[small] > TRAIN_TWIN_REL * ptop).sum())
    log(f"[train] (b) 2 layers at full width, fp32, card against CPU, one batch of (2, 64): "
        f"loss {lg:.6f} / {lc:.6f}, grad norm {ng:.6f} / {nc:.6f}; every gradient within "
        f"{g_err:.3e} of its leaf's max (tolerance {TRAIN_TWIN_REL}); after one "
        f"make_train_step step (lr 6e-4) the parameters within {p_err:.3e} of their leaf's "
        f"max where |g| >= 1e-4 of the largest, {flips} smaller-gradient elements off by more "
        f"(each within 2 lr); {time.perf_counter() - t0:.1f} s on {card}")
    return {"twin_loss": [lg, lc], "twin_grad_norm": [ng, nc], "twin_grad_rel": g_err,
            "twin_param_rel": p_err, "twin_small_grad_flips": flips}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dryrun_process(out_dir: Path):
    """Phase 14 (e): the production dry-run cell as a process of its own
    (its fake process group of 256 ranks is process-wide)."""
    arch, shape, mesh = DRYRUN_CELL
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", mesh, "--device", "cuda", "--out", str(out_dir)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


_CELLS = r"""
import subprocess, sys
out = sys.argv[1]
for arch, shape, mesh in zip(*[iter(sys.argv[2:])] * 3):  # a process a cell
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", mesh, "--device", "cuda", "--out", out],
                       capture_output=True, text=True)
    print(f"cell {arch} {shape} {mesh}: exit {p.returncode}", flush=True)
    if p.returncode:
        sys.stderr.write(p.stdout[-1000:] + p.stderr[-3000:])
        sys.exit(1)
"""


def _decode_cells_process(out_dir: Path):
    """Phase 15 (b): ``DECODE_CELLS`` as one process, a child a cell (the
    fake process group is process-wide)."""
    return subprocess.Popen(
        [sys.executable, "-c", _CELLS, str(out_dir)] + [x for c in DECODE_CELLS for x in c],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _cache_leaves(cache) -> list:
    """A decode cache's leaves (or its specs'), in tree order."""
    if isinstance(cache, dict):
        return [t for k in cache for t in _cache_leaves(cache[k])]
    if isinstance(cache, list):
        return [t for v in cache for t in _cache_leaves(v)]
    return [cache]


def decode_phase(np, torch, card: str, cells, cells_dir: Path, t_cells: float) -> dict:
    """Phase 15: the sharded decode path -> the phase's figures.

    (a) ``SERVE_ARCH`` at full width in fp32 (TF32 off), one set of
    weights: ``DECODE_BATCH`` prompts of ``DECODE_PROMPT`` tokens (seed
    ``DECODE_SEED``) prefilled into a cache of ``DECODE_CAP`` and
    ``DECODE_STEPS`` decode steps on fixed tokens, plain; then the same
    weights as DTensors on a one-rank NCCL mesh (``param_pspecs``, the
    mesh installed), the prompt placed by ``batch_pspecs``, the prefill's
    cache placed by ``cache_pspecs`` (``shard_cache``), each step's tokens
    placed likewise. Every step's logits within ``DECODE_REL`` of the
    plain step's largest |logit|, the final caches ``torch.equal`` leaf
    for leaf, every leaf's placements after every step those it came in
    with (``to_placements(cache_pspecs(...))``); the prefill's and each
    step's seconds of both. (b) ``cells`` (the ``DECODE_CELLS`` process
    started beside phase 14) collected: each artifact's memory per rank
    against 80 GB, roofline terms, collectives, and ``cache_all_gathers``
    0."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.act_shard import install_mesh
    from repro_torch.distributed.sharding import (
        batch_pspecs,
        cache_pspecs,
        param_pspecs,
        shard_batch,
        shard_cache,
        shard_model,
        to_placements,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import decode_step, init_params, prefill

    t_phase = time.perf_counter()
    stats = {}
    try:
        # (a) the sharded decode on a one-rank mesh against the plain one
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 matmuls are on: fp32 parity would not hold")
        dev = torch.device("cuda")
        cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="float32")
        rng = np.random.default_rng(DECODE_SEED)
        toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (
            DECODE_BATCH, DECODE_PROMPT + DECODE_STEPS)).astype(np.int32)).to(dev)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SERVE_SEED),
                            device=dev)

        def run(place_batch, place_cache, check):
            """Prefill and the decode steps -> (logits on the host, the
            cache, the prefill's and every step's seconds)."""
            pre = place_batch({"tokens": toks[:, :DECODE_PROMPT]})["tokens"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = prefill(model, {"tokens": pre}, DECODE_CAP)
            cache = place_cache(cache)
            torch.cuda.synchronize()
            secs = [time.perf_counter() - t0]
            got = [lg]
            for t in range(DECODE_PROMPT, DECODE_PROMPT + DECODE_STEPS):
                tok = place_batch({"tokens": toks[:, t:t + 1]})["tokens"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = decode_step(model, cache, tok)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                check(cache)
                got.append(lg)
            logits = [(g.full_tensor() if hasattr(g, "full_tensor") else g).float().cpu()
                      for g in got]
            return logits, cache, secs

        want, plain_cache, plain_s = run(lambda b: b, lambda c: c, lambda c: None)
        plain_cache = [t.clone() for t in _cache_leaves(plain_cache)]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
        mesh = make_local_mesh(1, device="cuda")
        shard_model(model, mesh, param_pspecs(model, cfg, mesh))
        placed = {}

        def placements(cache):
            return [tuple(t.placements) for t in _cache_leaves(cache)]

        def place_cache(cache):
            cache = shard_cache(cache, mesh, cache_pspecs(cache, cfg, mesh))
            placed["in"] = placements(cache)
            spec = _cache_leaves(cache_pspecs(cache, cfg, mesh))
            if placed["in"] != [tuple(to_placements(sp, mesh)) for sp in spec]:
                raise AssertionError("(a) the prefill's cache is not placed by cache_pspecs")
            return cache

        def check(cache):
            if placements(cache) != placed["in"]:
                raise AssertionError("(a) a decode step changed a cache leaf's placements")

        install_mesh(mesh)
        try:
            got, cache, sharded_s = run(lambda b: shard_batch(b, mesh, batch_pspecs(b, mesh)),
                                        place_cache, check)
        finally:
            install_mesh(None)
        worst = 0.0
        for i, (a, b) in enumerate(zip(want, got)):
            scale = float(a.abs().max())
            err = float((a - b).abs().max())
            if err > DECODE_REL * scale:
                raise AssertionError(f"(a) step {i}: DTensor logits off by {err} (max {scale})")
            worst = max(worst, err / scale)
        leaves = _cache_leaves(cache)
        same = all(torch.equal(a, b.to_local()) for a, b in zip(plain_cache, leaves))
        if not (same and len(leaves) == len(plain_cache)):
            raise AssertionError("(a) the DTensor cache differs from the plain cache")
        n_leaves = len(leaves)
        kinds = sorted({str(p) for pl in placed["in"] for p in pl})
        del model, cache, plain_cache, leaves
        torch.cuda.empty_cache()
        later_plain = float(np.median(plain_s[2:])) * 1e3
        later_sharded = float(np.median(sharded_s[2:])) * 1e3
        stats.update(decode_logit_rel=worst, decode_prefill_s=[sharded_s[0], plain_s[0]],
                     decode_first_step_ms=[sharded_s[1] * 1e3, plain_s[1] * 1e3],
                     decode_step_ms=[later_sharded, later_plain], decode_cache_leaves=n_leaves)
        log(f"[decode] (a) {SERVE_ARCH} full width in fp32 (TF32 off) on a one-rank NCCL mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: prefill of ({DECODE_BATCH}, "
            f"{DECODE_PROMPT}) into a cache of {DECODE_CAP} and {DECODE_STEPS} decode steps as "
            f"DTensors against the plain path: logits within {worst:.3e} of the largest |logit| "
            f"(tolerance {DECODE_REL}), the {n_leaves} cache leaves torch.equal, every leaf placed "
            f"as it came in after every step ({kinds}); prefill {sharded_s[0]:.3f} s DTensor / "
            f"{plain_s[0]:.3f} s plain, the first step {sharded_s[1] * 1e3:.1f} / "
            f"{plain_s[1] * 1e3:.1f} ms, a later step (median of {DECODE_STEPS - 1}) "
            f"{later_sharded:.2f} / {later_plain:.2f} ms; on {card}")

        # (b) the production dry-run cells
        out, err = cells.communicate(timeout=DECODE_DRYRUN_TIMEOUT)
        cells_s = time.perf_counter() - t_cells
        if cells.returncode != 0:
            raise AssertionError(f"(b) a dry-run cell failed: exit {cells.returncode}, "
                                 f"{out[-1000:]} {err[-3000:]}")
        arts = []
        for arch, shape, mesh_kind in DECODE_CELLS:
            art = json.loads((cells_dir / f"{arch}__{shape}__{mesh_kind}.json").read_text())
            mem, hc, rf = art["memory"], art["hlo_cost"], art["roofline"]
            if not (hc["flops_per_device"] > 0 and art["cache_all_gathers"] == 0):
                raise AssertionError(f"(b) {arch} x {shape}: {hc['flops_per_device']} FLOPs, "
                                     f"{art['cache_all_gathers']} all-gathers of a cache block")
            arts.append({k: art[k] for k in ("arch", "shape", "mesh", "chips", "mode", "memory",
                                              "roofline", "cache_all_gathers", "trace_s")}
                        | {"collective_count": hc["collective_count"],
                           "collective_bytes": hc["collective_bytes"],
                           "flops_per_device": hc["flops_per_device"]})
            log(f"[decode] (b) dry run {arch} x {shape} x {mesh_kind} ({art['chips']} fake ranks, "
                f"mode {art['mode']}): per rank arguments {mem['argument_bytes']} + temporaries "
                f"{mem['temp_bytes']} = {mem['peak_bytes']} bytes against 80e9 (fits: "
                f"{mem['fits_hbm']}), outputs {mem['output_bytes']}, aliased "
                f"{mem['alias_bytes']}; FLOPs {hc['flops_per_device']:.6e} a rank (useful "
                f"{art['useful_flops_ratio']:.4f}), bytes {hc['hbm_bytes_per_device']:.6e}; "
                f"collectives {hc['collective_count']} {hc['collective_bytes']}; all-gathers of a "
                f"cache block {art['cache_all_gathers']}; roofline compute "
                f"{rf['t_compute_s'] * 1e3:.4f} ms, memory {rf['t_memory_s'] * 1e3:.4f} ms, "
                f"collective {rf['t_collective_s'] * 1e3:.4f} ms ({rf['dominant']}); the traced "
                f"step {art['trace_s']} s")
        stats.update(dryrun_cells=arts, dryrun_cells_s=cells_s)
        log(f"[decode] (b) the {len(arts)} cells as one process took {cells_s:.1f} s beside "
            f"phases 14 and 15 (a); the device type of their mesh cuda, nothing on the card")
    finally:
        if cells.poll() is None:
            cells.kill()
            cells.communicate()
        install_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[decode] phase 15 took {stats['seconds']:.1f} s")
    return stats


def _rules_at_full_width(card: str) -> dict:
    """Phase 14 (a): ``param_pspecs`` for all ten archs (heads padded to
    16) on both production mesh shapes, built on shapes only."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.distributed.sharding import AbstractMesh, param_pspecs
    from repro_torch.models import Transformer, tp_pad

    t0 = time.perf_counter()
    leaves = big = 0
    for arch in ARCH_IDS:
        cfg = tp_pad(get_config(arch), 16)
        model = Transformer(cfg, "meta")
        names = {n: p for n, p in model.named_parameters()}
        for sizes, axes in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
            ax = dict(zip(axes, sizes))
            specs = param_pspecs(model, cfg, AbstractMesh(sizes, axes))
            if set(specs) != set(names):
                raise AssertionError(f"(a) {arch} {axes}: specs cover {len(specs)} of "
                                     f"{len(names)} leaves")
            for name, p in names.items():
                for dim, e in zip(p.shape, specs[name]):
                    n = 1
                    for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
                        n *= ax[a]
                    if dim % n:
                        raise AssertionError(f"(a) {arch} {name} {tuple(p.shape)} "
                                             f"{specs[name]}: does not divide")
                if p.numel() > 1e6:
                    big += 1
                    if all(e is None for e in specs[name]):
                        raise AssertionError(f"(a) {arch} {name} {tuple(p.shape)} is not sharded")
                leaves += 1
        del model
    seconds = time.perf_counter() - t0
    log(f"[dist] (a) sharding rules, 10 archs at full width (heads padded to 16) x the (16, 16) "
        f"and (2, 16, 16) meshes, on shapes: {leaves} leaves covered and dividing, {big} above "
        f"1e6 elements each sharded on some axis; {seconds:.2f} s")
    return {"rule_leaves": leaves, "rule_big_leaves": big, "rules_s": seconds}


def distribution_phase(np, torch, card: str, match_args) -> dict:
    """Phase 14: the distribution layer on the card -> the phase's figures.

    (a) ``_rules_at_full_width``. (b) ``ops.wildcard_match_sharded`` on a
    one-rank NCCL mesh (``make_local_mesh(1)``) at row 1a's input (the
    largest first-token bucket of phase 3, ``match_args``): ``torch.equal``
    to ``ops.wildcard_match`` and to the plain version; launches counted
    from 0 around the call (exactly 1), the kernel's device time under
    ``torch.profiler``. (c) ``DIST_ARCH`` at full width in fp32 (TF32
    off), one ``make_train_step`` step of a (8, 256) batch of byte tokens
    (seed 14) plain and as DTensors on that mesh (params, moments and
    batch placed by ``param_pspecs`` / ``batch_pspecs``, the mesh
    installed): loss and grad norm within ``TRAIN_TWIN_REL``, every
    updated parameter within it of its leaf's largest |value| but where
    the plain gradient is below 1e-4 of the largest (within 2 lr), as
    phase 13 (b); the first and a later step's seconds of each. (d) the
    cost model (``hlo_cost.CostModel``) over one bf16 step of
    ``DIST_ARCH`` (8, 256) on the card: FLOPs beside 8 N tokens, bytes,
    convert bytes, the roofline terms beside the measured ms a step
    (median of 3, nothing measuring). (e) ``DRYRUN_CELL`` as a process
    (``launch.dryrun``, started first, beside (a)-(d)): memory per rank
    against 80 GB, the cost terms, its seconds."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.act_shard import install_mesh
    from repro_torch.distributed.sharding import (
        batch_pspecs,
        param_pspecs,
        shard_batch,
        shard_model,
        shard_opt_state,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels import wildcard_match as wm
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim.adamw import AdamWHyper, adamw_init
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="dryrun-", dir=ROOT / "build"))
    t_dry = time.perf_counter()
    dry = _dryrun_process(work)
    stats = {}
    try:
        stats.update(_rules_at_full_width(card))  # (a)

        # (b) the sharded match on a one-rank NCCL mesh
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
        mesh = make_local_mesh(1, device="cuda")
        logs, lens, tmpl, tl = (a.cpu().numpy() for a in match_args)
        n, t = logs.shape
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = ops.wildcard_match_sharded(logs, lens, tmpl, tl, mesh)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts["wildcard_match"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"(b) the sharded match launched {counts}")
        local = got.to_local()
        want = torch.from_numpy(ops.wildcard_match(logs, lens, tmpl, tl, device="cuda"))
        plain = wm.wildcard_match_plain(*match_args) & (match_args[1] <= t)[:, None]
        if not (tuple(got.shape) == (n, tmpl.shape[0]) and torch.equal(local.cpu(), want)
                and torch.equal(local, plain)):
            raise AssertionError("(b) wildcard_match_sharded differs from wildcard_match or "
                                 "the plain version")
        # the kernel's device time on the tensors the sharded call gives it
        given = []
        ops.input_hook = lambda name, args: given.append(args)
        try:
            ops.wildcard_match_sharded(logs, lens, tmpl, tl, mesh)
        finally:
            ops.input_hook = None
        kernel_ms = kernel_device_ms(torch, wm.wildcard_match, given[0], 20)
        if not (len(given) == 1 and kernel_ms > 0):
            raise AssertionError(f"(b) {len(given)} kernel inputs, {kernel_ms} ms")
        call_ms = time_ms(torch, ops.wildcard_match_sharded, (logs, lens, tmpl, tl, mesh), 3)
        stats.update(sharded_match_launches=counts["wildcard_match"],
                     sharded_match_kernel_ms=kernel_ms, sharded_match_call_ms=call_ms,
                     sharded_match_hits=int(local.sum()))
        log(f"[dist] (b) wildcard_match_sharded on a one-rank NCCL mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"at N={n} T={t} K={tmpl.shape[0]} Tt={tmpl.shape[1]}: launches {counts['wildcard_match']} "
            f"(counted from 0 around the call), torch.equal to wildcard_match and to the plain "
            f"version ({int(local.sum())} hits); the kernel {kernel_ms:.4f} ms a launch on the "
            f"rank's inputs (CUDA graph, CUDA events), the whole call {call_ms:.3f} ms with its "
            f"uploads; on {card}")

        # (c) the DTensor train step against the plain one, full width, fp32
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 matmuls are on: fp32 parity would not hold")
        dev = torch.device("cuda")
        cfg = dataclasses.replace(get_config(DIST_ARCH), dtype="float32")
        hyper = AdamWHyper(lr=6e-4)
        step = make_train_step(cfg, hyper)
        toks = np.random.default_rng(14).integers(3, 259, (TRAIN_BATCH, TRAIN_SEQ + 1))
        batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev)}
        one = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        params = dict(one.named_parameters())
        g_abs = {k: g.abs() for k, g in zip(params, torch.autograd.grad(
            loss_fn(one, batch)[0], list(params.values())))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one, opt1, m1 = step(one, adamw_init(one), batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        two = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        specs = param_pspecs(two, cfg, mesh)
        opt2 = shard_opt_state(adamw_init(two), mesh, specs)
        shard_model(two, mesh, specs)
        install_mesh(mesh)
        try:
            sb = shard_batch(batch, mesh, batch_pspecs(batch, mesh))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            two, opt2, m2 = step(two, opt2, sb)
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t0
            l1, l2 = float(m1["loss"]), float(m2["loss"])
            n1, n2 = float(m1["grad_norm"]), float(m2["grad_norm"])
            if not (abs(l1 - l2) <= TRAIN_TWIN_REL * abs(l1)
                    and abs(n1 - n2) <= TRAIN_TWIN_REL * n1):
                raise AssertionError(f"(c) loss {l2} / {l1}, grad norm {n2} / {n1} (DTensor / "
                                     "plain)")
            top_g = max(float(g.max()) for g in g_abs.values())
            worst = worst_small = 0.0
            for k, p2 in two.named_parameters():
                p1 = params[k]
                diff = (p2.detach().to_local() - p1.detach()).abs()
                small = g_abs[k] < 1e-4 * top_g
                scale = float(p1.detach().abs().max())
                e = float(diff[~small].max()) if bool((~small).any()) else 0.0
                e_small = float(diff[small].max()) if bool(small.any()) else 0.0
                if e > TRAIN_TWIN_REL * scale or e_small > 2 * hyper.lr + TRAIN_TWIN_REL * scale:
                    raise AssertionError(f"(c) {k}: DTensor and plain steps differ by {e} "
                                         f"(max {scale}), {e_small} where |g| < 1e-4 of the "
                                         "largest")
                worst = max(worst, e / max(scale, 1e-30))
                worst_small = max(worst_small, e_small)
            del g_abs
            # a later step of each, timed (the first pays DTensor's sharding
            # propagation for every op's shapes)
            times = {}
            for label, model, opt, b in (("plain", one, opt1, batch), ("DTensor", two, opt2, sb)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(model, opt, b)
                torch.cuda.synchronize()
                times[label] = time.perf_counter() - t0
        finally:
            install_mesh(None)
        stats.update(dtensor_step_loss=[l2, l1], dtensor_step_param_rel=worst,
                     dtensor_step_small_grad_max=worst_small, plain_step_first_s=plain_s,
                     dtensor_step_first_s=sharded_s, plain_step_s=times["plain"],
                     dtensor_step_s=times["DTensor"])
        log(f"[dist] (c) {DIST_ARCH} full width in fp32 (TF32 off), one make_train_step step "
            f"of ({TRAIN_BATCH}, {TRAIN_SEQ}), DTensor on the one-rank mesh against plain: loss "
            f"{l2:.7f} / {l1:.7f}, grad norm {n2:.6f} / {n1:.6f}; every updated parameter within "
            f"{worst:.3e} of its leaf's max where |g| >= 1e-4 of the largest (tolerance "
            f"{TRAIN_TWIN_REL}), {worst_small:.3e} elsewhere (within 2 lr); the first step "
            f"{sharded_s:.2f} s DTensor / {plain_s:.2f} s plain, a later one "
            f"{times['DTensor']:.3f} / {times['plain']:.3f} s; on {card}")
        del one, two, opt1, opt2, params, batch, sb, m1, m2
        torch.cuda.empty_cache()

        # (d) the cost model over one bf16 step on the card
        cfg = get_config(DIST_ARCH)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        opt = adamw_init(model)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev)}
        step = make_train_step(cfg, hyper)
        model, opt, _ = step(model, opt, batch)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        costs = hlo_cost.analyze(step, model, opt, batch)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        step_ms = float(np.median(ms))
        n_params = sum(p.numel() for p in model.parameters())
        tokens = TRAIN_BATCH * TRAIN_SEQ
        terms = hlo_cost.roofline_terms(costs)
        stats.update(cost_model={k: v for k, v in costs.items()}, roofline=terms,
                     analytic_flops=8 * n_params * tokens, measured_step_ms=step_ms,
                     traced_step_s=traced_s)
        log(f"[dist] (d) cost model over one bf16 {DIST_ARCH} ({TRAIN_BATCH}, {TRAIN_SEQ}) step "
            f"on the card: {costs['op_count']} ops, {costs['dot_count']} products, FLOPs "
            f"{costs['flops']:.6e} against 8 N tokens = 8 x {n_params} x {tokens} = "
            f"{8 * n_params * tokens:.6e} ({costs['flops'] / (8 * n_params * tokens):.4f}x); "
            f"bytes {costs['hbm_bytes']:.6e}, of which convert {costs['convert_bytes']:.6e}; "
            f"peak live {costs['peak_live_bytes']} bytes; roofline t_compute "
            f"{terms['t_compute_s'] * 1e3:.4f} ms, t_memory {terms['t_memory_s'] * 1e3:.4f} ms "
            f"({terms['dominant']}) against {step_ms:.3f} ms a step measured (median of 3, "
            f"{[round(x, 3) for x in ms]}), the step at {step_ms / 1e3 / terms['step_time_lower_bound_s']:.2f}x "
            f"the bound; the traced step {traced_s:.2f} s; on {card}")
        del model, opt, batch
        torch.cuda.empty_cache()

        # (e) the production dry-run cell
        out, err = dry.communicate(timeout=DRYRUN_TIMEOUT)
        dry_s = time.perf_counter() - t_dry
        arch, shape, mesh_kind = DRYRUN_CELL
        art_path = work / f"{arch}__{shape}__{mesh_kind}.json"
        if dry.returncode != 0 or not art_path.exists():
            raise AssertionError(f"(e) the dry-run cell failed: exit {dry.returncode}, "
                                 f"{out[-1000:]} {err[-3000:]}")
        art = json.loads(art_path.read_text())
        mem, hc, rf = art["memory"], art["hlo_cost"], art["roofline"]
        if not (hc["flops_per_device"] > 0 and mem["temp_bytes"] > 0
                and hc["collective_bytes_total"] > 0):
            raise AssertionError(f"(e) the dry-run cell counted nothing: {art}")
        stats.update(dryrun=art, dryrun_s=dry_s)
        log(f"[dist] (e) dry run {arch} x {shape} x {mesh_kind} ({art['chips']} fake ranks, mode "
            f"{art['mode']}, {art['microbatches']} microbatch) as a process, {dry_s:.1f} s beside "
            f"(a)-(d) (lowering {art['lower_s']} s, the traced step {art['trace_s']} s): per rank "
            f"arguments {mem['argument_bytes']} + temporaries {mem['temp_bytes']} = "
            f"{mem['peak_bytes']} bytes against 80e9 (fits: {mem['fits_hbm']}), outputs "
            f"{mem['output_bytes']}, aliased {mem['alias_bytes']}; FLOPs "
            f"{hc['flops_per_device']:.6e} a rank (useful {art['useful_flops_ratio']:.4f}), "
            f"bytes {hc['hbm_bytes_per_device']:.6e}, collectives {hc['collective_bytes']} "
            f"({hc['collective_count']}); roofline compute {rf['t_compute_s'] * 1e3:.3f} ms, "
            f"memory {rf['t_memory_s'] * 1e3:.3f} ms, collective "
            f"{rf['t_collective_s'] * 1e3:.3f} ms ({rf['dominant']}); the device type of its "
            f"mesh cuda, nothing on the card")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
        install_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[dist] phase 14 took {stats['seconds']:.1f} s")
    return stats


def decode_bytes(cfg, model, bsz: int, kv_len: float) -> float:
    """The bytes one decode step of ``bsz`` rows must move, at a mean
    self-attention length ``kv_len``: every weight but the embedding table,
    of which it gathers ``bsz`` rows (read whole as the unembedding when
    tied); each layer's state read and written (K/V: kv_len - 1 valid slots
    read and one written; mamba's conv and fp32 ssm states; RWKV's fp32 wkv
    state and its two shifts; whisper's cross-attention K/V read); the
    logits written. MoE weights count every expert: the dispatch runs them
    all."""
    elt = model.embed.element_size()
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        n -= model.embed.numel() * elt
    n += bsz * cfg.d_model * elt
    for block in model.blocks:
        for sub in block.values():
            if sub.kind == "attn":
                n += 2 * bsz * cfg.n_kv_heads * cfg.head_dim * elt * kv_len
            elif sub.kind == "mamba":
                n += 2 * bsz * ((cfg.ssm_conv - 1) * cfg.d_inner * elt
                                + cfg.d_inner * cfg.ssm_state * 4)
            else:
                n += 2 * bsz * (cfg.n_rwkv_heads * cfg.rwkv_head_dim ** 2 * 4
                                + 2 * cfg.d_model * elt)
    if cfg.n_enc_layers:
        n += cfg.n_layers * 2 * bsz * cfg.n_frames * cfg.n_kv_heads * cfg.head_dim * elt
    return n + bsz * cfg.padded_vocab * elt


def greedy(torch, model, batch: dict, max_len: int, steps: int):
    """Prefill and ``steps`` greedy decode steps through the entry points
    -> (logits (B, steps + 1, V) fp32 on the host, tokens (B, steps))."""
    from repro_torch.models import decode_step, prefill

    logits, cache = prefill(model, batch, max_len)
    outs, toks = [logits.float().cpu()], []
    for _ in range(steps):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        toks.append(tok.cpu())
        logits, cache = decode_step(model, cache, tok)
        outs.append(logits.float().cpu())
    return torch.stack(outs, dim=1), torch.cat(toks, dim=1)


def greedy_by_sublayer(torch, model, tokens, max_len: int, card_tokens):
    """(b)'s CPU side for a model the host should not hold whole: the
    prompt and the card's greedy tokens (fed in turn) through each
    sub-layer, whose weights alone are on the host at a time, with the
    serving path's own sub-layer steps -> logits (B, steps + 1, V) and the
    CPU's greedy tokens."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.serving import decode_sublayer, prefill_sublayer
    from repro_torch.models.transformer import Sublayer

    cfg = model.cfg
    with torch.inference_mode():
        embed = model.embed.detach().cpu()
        b, s = tokens.shape
        xs = [embed[tokens.cpu().long()]] + [embed[card_tokens[:, k:k + 1].long()]
                                            for k in range(card_tokens.shape[1])]
        positions = torch.arange(s).expand(b, s)
        for block in model.blocks:
            for j in range(cfg.block_period):
                sub = block[f"sub{j}"]
                host = Sublayer(cfg, torch.float32, "cpu", sub.kind, sub.ffn_kind == "moe")
                host.load_state_dict(sub.state_dict())
                xs[0], state = prefill_sublayer(xs[0], host, cfg, positions, max_len)
                for k in range(1, len(xs)):
                    pos = s + k - 1
                    xs[k] = decode_sublayer(
                        xs[k], host, state, cfg, torch.full((b, 1), pos),
                        torch.tensor([min(pos, max_len - 1)]),
                        torch.full((b,), pos + 1, dtype=torch.int32))
                del host, state
        ln_f, unembed = model.ln_f.detach().cpu(), model.unembedding().detach().cpu()
        logits = torch.stack([rms_norm(x[:, -1], ln_f, cfg.norm_eps) @ unembed for x in xs],
                             dim=1)
    return logits, logits[:, :-1].argmax(-1).to(torch.int32)


def families_phase(np, torch, card: str) -> dict:
    """Phase 12: the LM zoo's other families at their published widths on
    the card (``FAMILIES``: depth cut where one card cannot hold the
    model), each built from seed 0 and freed before the next -> the serve
    figures per arch.

    (a) fp32, TF32 off: prefill half of a (2, 128) prompt (after a (2,
    256, d) patch prefix for the VLM, with (2, 1500, d) frames for whisper)
    and decode the rest; the logits equal ``forward``'s at the same
    positions within ``CACHE_REL`` of max |logit|. A MoE drops slots by a
    capacity that depends on the tokens of a call, so a decode step drops
    other slots than the forward (the reference's rule): here every expert
    has room for every slot (capacity factor E / top_k). RWKV's chunked
    form clamps the cumulative log-decay within a chunk, which decode's
    recurrence does not (the reference's, copied): its gap at the published
    64-step chunk is printed, and the check holds with one-step chunks,
    which clamp as decode does. (b) the CPU twin at full width in fp32:
    prefill of a 64-token prompt and 8 greedy decode steps, logits within
    ``TWIN_REL``, tokens equal; one block whole for rwkv6, internvl2 and
    whisper, and sub-layer by sub-layer on (a)'s model for the MoE archs
    (one sub-layer's weights on the host at a time, the card's tokens fed
    in turn). (c) bf16: 8 requests as 2 batches of 4, 32 new tokens, greedy,
    prompt 512 (64 for whisper), through ``serve_requests`` after one
    untimed batch; the decode step's bound, and for a MoE the experts a
    step routes to (counted over 8 steps). (d) ``python -m
    repro_torch.launch.serve --arch <arch> --device cuda --requests 4`` for
    each of ``FAMILY_CLI``, all at once."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as fa
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.models import moe as moe_module
    from repro_torch.models.transformer import Transformer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: fp32 parity would not hold")
    out = {}
    for arch, (depth, published) in FAMILIES.items():
        t_arch = time.perf_counter()
        full_cfg = get_config(arch)
        shape = {k: getattr(full_cfg, k) for k in published}
        if shape != published:
            raise AssertionError(f"{arch} is not the published config: {shape}")
        cfg = dataclasses.replace(full_cfg, n_layers=depth)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rng = np.random.default_rng(SERVE_SEED)
        p = cfg.n_patches
        stats = {"layers": depth, "published_layers": full_cfg.n_layers}

        def gen():
            return torch.Generator(device=dev).manual_seed(SERVE_SEED)

        def stubs(b):
            """The modality inputs, random (zeros would hide them)."""
            extra = {}
            if cfg.n_patches:
                extra["vision"] = torch.from_numpy(rng.standard_normal(
                    (b, cfg.n_patches, cfg.d_model), dtype=np.float32)).to(dev)
            if cfg.n_enc_layers:
                extra["frames"] = torch.from_numpy(rng.standard_normal(
                    (b, cfg.n_frames, cfg.d_model), dtype=np.float32)).to(dev)
            return extra

        # (a) the cache against the forward, at the table's depth in fp32
        t0 = time.perf_counter()
        acfg = cfg32
        if cfg.n_experts:
            acfg = dataclasses.replace(acfg, capacity_factor=cfg.n_experts / cfg.top_k)
        model = init_params(acfg, gen(), device=dev)
        toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 128)).astype(np.int32)).to(dev)
        extra = stubs(2)

        def cache_gap():
            full, _ = forward(model, {"tokens": toks, **extra})
            logits, cache = prefill(model, {"tokens": toks[:, :64], **extra}, 128 + p)
            seq = [logits]
            for t in range(64, 128):
                logits, cache = decode_step(model, cache, toks[:, t:t + 1])
                seq.append(logits)
            got, want = torch.stack(seq[:-1], dim=1), full[:, p + 63:p + 127]
            return (bool(torch.isfinite(got).all()), float((got - want).abs().max()),
                    float(want.abs().max()))

        finite, err, scale = cache_gap()
        note = ""
        if cfg.ssm_kind == "rwkv6" and not cfg.attn_every:
            note = (f"; at the published {cfg.ssm_chunk}-step chunk {err / scale:.3e} of max "
                    f"|logit| (the chunk's clamped cumulative decay), held with 1-step chunks")
            stats["cache_rel_published_chunk"] = err / scale
            model.cfg = dataclasses.replace(acfg, ssm_chunk=1)
            finite, err, scale = cache_gap()
            model.cfg = acfg
        if not (finite and err <= CACHE_REL * scale):
            raise AssertionError(f"(a) {arch}: prefill + decode differ from forward by {err} "
                                 f"(max |logit| {scale}, tolerance {CACHE_REL} of it){note}")
        stats["cache_rel"] = err / scale
        torch.cuda.synchronize()
        log(f"[family] {arch} (a) {depth} of {full_cfg.n_layers} layers at full width, fp32, "
            f"TF32 off{', capacity for every slot' if cfg.n_experts else ''}: prefill 64 + 64 "
            f"decode steps against forward over (2, 128){f' after {p} patches' if p else ''}"
            f"{f' with {cfg.n_frames} frames' if cfg.n_enc_layers else ''}: max |diff| "
            f"{err:.3e}, {err / scale:.3e} of max |logit| {scale:.3f} (tolerance {CACHE_REL})"
            f"{note}; {time.perf_counter() - t0:.1f} s on {card}")

        # (b) the CPU twin at full width, fp32
        t0 = time.perf_counter()
        prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 64)).astype(np.int32)).to(dev)
        extra = stubs(2)
        max_len = 64 + 9 + p
        if cfg.n_experts:
            model.cfg = cfg32  # the config's own capacity
            lg, tg = greedy(torch, model, {"tokens": prompt}, max_len, 8)
            lc, tc = greedy_by_sublayer(torch, model, prompt, max_len, tg)
            how = f"sub-layer by sub-layer over (a)'s {depth} layers"
        else:
            del model
            torch.cuda.empty_cache()
            one = dataclasses.replace(cfg32, n_layers=cfg.block_period)
            model = init_params(one, gen(), device=dev)
            host = Transformer(one, "cpu")
            host.load_state_dict(model.state_dict())
            lg, tg = greedy(torch, model, {"tokens": prompt, **extra}, max_len, 8)
            lc, tc = greedy(torch, host, {"tokens": prompt.cpu(),
                                          **{k: v.cpu() for k, v in extra.items()}}, max_len, 8)
            del host
            how = f"one block ({cfg.block_period} layer{'s' * (cfg.block_period > 1)}) whole"
        err, scale = float((lg - lc).abs().max()), float(lc.abs().max())
        if not (torch.equal(tg, tc) and err <= TWIN_REL * scale):
            raise AssertionError(f"(b) {arch}: card and CPU differ: tokens equal "
                                 f"{torch.equal(tg, tc)}, max |diff| {err} (max |logit| {scale}, "
                                 f"tolerance {TWIN_REL})")
        stats["twin_rel"] = err / scale
        log(f"[family] {arch} (b) {how}, full width, fp32, card against CPU: prefill 64 + 8 "
            f"greedy steps, max |diff| {err:.3e}, {err / scale:.3e} of max |logit| (tolerance "
            f"{TWIN_REL}); tokens equal {tg.tolist()}; {time.perf_counter() - t0:.1f} s on {card}")
        del model
        torch.cuda.empty_cache()

        # (c) the timed serve in bf16
        t0 = time.perf_counter()
        model = init_params(cfg, gen(), device=dev)
        weight_bytes = sum(q.numel() * q.element_size() for q in model.parameters())
        n_params = sum(q.numel() for q in model.parameters())
        plen = 64 if cfg.n_enc_layers else 512
        serve_requests(model, 4, 4, plen, 4, np.random.default_rng(1), log=lambda m: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = serve_requests(model, 8, 4, plen, 32, np.random.default_rng(SERVE_SEED),
                             log=lambda m: None)
        peak = torch.cuda.max_memory_allocated()
        served = torch.cat(res["tokens"])
        if not (served.shape == (8, 32) and int(served.min()) >= 0
                and int(served.max()) < cfg.padded_vocab):
            raise AssertionError(f"(c) {arch}: served tokens out of range: {tuple(served.shape)}")
        kv_len = plen + p + 1 + (32 - 2) / 2
        step_bytes = decode_bytes(cfg, model, 4, kv_len)
        stats.update(params=n_params, weight_bytes=weight_bytes, peak_bytes=peak,
                     prefill_ms=res["prefill_s"] / len(res["tokens"]) * 1e3,
                     decode_ms_a_step=res["decode_s"] / res["decode_steps"] * 1e3,
                     tok_per_s=res["tok_per_s"], decode_step_bytes=step_bytes,
                     decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)
        routed = ""
        if cfg.n_experts:
            # the experts each MoE call of 8 decode steps routes to, counted
            # by a wrapper of the router (this measurement only)
            seen, router = [], moe_module._router

            def counting(x, wg, top_k):
                gates, experts, aux = router(x, wg, top_k)
                seen.append(int(experts.unique().numel()))
                return gates, experts, aux

            batch = {"tokens": torch.from_numpy(
                rng.integers(3, cfg.vocab_size, (4, plen)).astype(np.int32)).to(dev)}
            logits, cache = prefill(model, batch, plen + 9)
            seen.clear()
            moe_module._router = counting
            try:
                for _ in range(8):
                    logits, cache = decode_step(
                        model, cache, logits.argmax(-1)[:, None].to(torch.int32))
            finally:
                moe_module._router = router
            del cache
            expert_bytes = ((3 if cfg.ffn_act == "swiglu" else 2) * cfg.d_model * cfg.d_ff
                            * model.embed.element_size())
            distinct = sum(seen) / len(seen)
            routed_bytes = step_bytes - len(seen) / 8 * (cfg.n_experts - distinct) * expert_bytes
            stats.update(experts_routed_a_call=distinct, routed_step_bytes=routed_bytes,
                         routed_bound_ms=routed_bytes / HBM_BYTES_PER_S * 1e3)
            routed = (f"; a step routes its 4 tokens to {distinct:.2f} of {cfg.n_experts} "
                      f"experts a MoE layer (8 steps): {routed_bytes:.0f} bytes, "
                      f"{stats['routed_bound_ms']:.4f} ms")
        log(f"[family] {arch} (c) bf16, {depth} layers, {n_params} parameters, 8 requests as 2 "
            f"batches of 4, prompt {plen}{f' after {p} zero patches' if p else ''}"
            f"{f' with {cfg.n_frames} zero frames' if cfg.n_enc_layers else ''}, 32 new tokens, "
            f"greedy, on {card}: prefill {stats['prefill_ms']:.3f} ms a batch, decode "
            f"{stats['decode_ms_a_step']:.3f} ms a step of 4, {res['tok_per_s']:.1f} tokens/s "
            f"over {res['seconds']:.3f} s; weights {weight_bytes} bytes; max_memory_allocated "
            f"{peak} bytes; decode bound (the {step_bytes:.0f} bytes a step moves over 3.35 "
            f"TB/s, every expert counted, K/V at a mean kv_len of {kv_len}) "
            f"{stats['decode_bound_ms']:.4f} ms, the step at "
            f"{stats['decode_ms_a_step'] / stats['decode_bound_ms']:.2f}x it{routed}; "
            f"{time.perf_counter() - t0:.1f} s with set-up")
        del model
        torch.cuda.empty_cache()
        stats["seconds"] = time.perf_counter() - t_arch
        out[arch] = stats

    # (d) the serve CLI on each non-dense arch's reduced config, all at once
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cuda",
         "--requests", "4"], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch in FAMILY_CLI}
    try:
        for arch, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"(d) the serve CLI on {arch} exited {proc.returncode}: "
                                     f"{stderr[-2000:]}")
            log(f"[family] (d) python -m repro_torch.launch.serve --arch {arch} --device cuda "
                f"--requests 4: exit 0; {stdout.strip().splitlines()[-1]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[family] (d) {len(procs)} processes at once in {time.perf_counter() - t0:.1f} s on "
        f"{card}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[family] phase 12 took {out['seconds']:.1f} s")
    return out


# phase 16: the fused attention kernel at the benchmark cells' shapes,
# causal, bf16: (batch, sequence, heads, KV heads, head dim)
ATTN_SHAPES = {"serve.qwen3-1.7b.triage prefill": (32, 2048, 16, 8, 128),
               "train.qwen1.5-0.5b.spark step": (8, 2048, 16, 16, 64)}
# the kernel's bf16 o, dq, dk and dv against the plain version's, norm-wise:
# ||got - want|| / ||want||, a few 1e-3 from the roundings of P, dS and
# the outputs; a kernel that left out one block of keys a row errs by
# several 1e-2
ATTN_REL = 1e-2


def attention_phase(torch, card: str, main_path: dict) -> dict:
    """Phase 16: ``kernels.attention.flash_attention`` -> row 7 of the
    kernel table. At each shape of ``ATTN_SHAPES`` (inputs from seed 0
    on the card): o, dq, dk and dv against the plain version
    ``models.layers._attention`` (autograd through its loop), each within
    ``ATTN_REL`` norm-wise; the forward as serving runs it (no grad; its
    device time from a CUDA graph of launches) and the forward plus
    backward as training runs it (autograd, CUDA events), each beside its
    bound (the causal FLOPs over 989 TFLOP/s; the backward counted at
    twice the forward, as ``bench/counts.py`` counts it, without
    recompute), the plain version and, as ``library_ms``,
    ``F.scaled_dot_product_attention`` with K/V heads repeated beforehand
    (a yardstick only: the port never calls it); one forward launch a
    forward, one backward pass a backward. ``main_path``: the launches and
    device ms that phases 11 and 13 counted on the serve's prefill and the
    training step."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention as fa
    from repro_torch.models import layers

    def plain(q, k, v):
        rep = q.shape[2] // k.shape[2]
        return layers._attention(q, layers._repeat_kv(k, rep), layers._repeat_kv(v, rep), None,
                                 causal=True, k_chunk=1024)

    def library(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def train(fn, args, do):  # a forward with the graph, then its backward
        leaves = [a.detach().requires_grad_() for a in args]
        fn(*leaves).backward(do)
        return leaves

    def outputs(fn, args, do):  # o, dq, dk, dv
        leaves = [a.detach().requires_grad_() for a in args]
        o = fn(*leaves)
        o.backward(do)
        return [o.detach()] + [t.grad for t in leaves]

    def rel(got, want) -> float:
        return float((got.float() - want.float()).norm() / want.float().norm())

    row = {"name": "attention", "route": "cuda",
           "source": "src/repro_torch/csrc/attention.cu",
           "replaces": "none: the JAX package leaves src/repro/models/layers.py::attention "
                       "(lax.scan) to XLA", "shapes": {},
           "launches": {"serve prefills (phase 11)": main_path["serve"]["launches"],
                        "train steps (phase 13)": main_path["train"]["launches"]},
           "main_path_device_ms": {
               "a (4, 512) prefill of 28 layers (phase 11)":
                   main_path["serve"]["profiled_prefill_device_ms"],
               "a (8, 256) train step of 24 layers (phase 13)":
                   main_path["train"]["device_ms_a_step"]}}
    for label, (b, s, h, kv, hd) in ATTN_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((b, s, heads, hd), generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for heads in (h, kv, kv, h))
        # SDPA's layout (B, H, S, hd), K/V heads repeated outside its timing
        lib_args = [t.transpose(1, 2) for t in (q, k.repeat_interleave(h // kv, 2),
                                                v.repeat_interleave(h // kv, 2))]
        kernel = functools.partial(fa.flash_attention, causal=True)
        flops = 4 * b * h * hd * (s * (s + 1) // 2)
        fa.reset_launches()
        want = outputs(plain, (q, k, v), do)
        got = outputs(kernel, (q, k, v), do)
        errs = {name: rel(g, w) for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)}
        del got, want
        if (fa.forward_launches(), fa.backward_launches()) != (1, 1) or \
                max(errs.values()) > ATTN_REL:
            raise AssertionError(f"attention at {label}: {errs} off the plain version (norm-wise, "
                                 f"tolerance {ATTN_REL}); launches (forward, backward) "
                                 f"{(fa.forward_launches(), fa.backward_launches())} for one pass")
        torch.cuda.empty_cache()
        with torch.inference_mode():
            fa.reset_launches()
            fwd_ms = kernel_device_ms(torch, kernel, (q, k, v), 10)
            launches = fa.forward_launches()
            plain_ms = time_ms(torch, plain, (q, k, v), 2)
            lib_ms = time_ms(torch, library, lib_args, 10)
        if launches != 11:
            raise AssertionError(f"attention at {label}: {launches} forward launches for 11 calls")
        fa.reset_launches()
        both_ms = time_ms(torch, functools.partial(train, kernel), ((q, k, v), do), 5)
        counts = (fa.forward_launches(), fa.backward_launches())
        if counts != (6, 6):
            raise AssertionError(f"attention at {label}: {counts} launches for 6 passes")
        plain_both_ms = time_ms(torch, functools.partial(train, plain), ((q, k, v), do), 1)
        torch.cuda.empty_cache()
        lib_both_ms = time_ms(torch, functools.partial(train, library),
                              (lib_args, do.transpose(1, 2)), 5)
        bound = flops / BF16_FLOP_PER_S * 1e3
        row["shapes"][label] = {
            "shape": f"B={b} S={s} H={h} KV={kv} hd={hd} causal bf16", "flops_forward": flops,
            "rel_to_plain": errs, "ms": fwd_ms, "bound_ms": bound, "plain_ms": plain_ms,
            "library_ms": lib_ms, "fwd_bwd_ms": both_ms, "fwd_bwd_bound_ms": 3 * bound,
            "plain_fwd_bwd_ms": plain_both_ms, "library_fwd_bwd_ms": lib_both_ms}
        log(f"[attention] {label} (B={b} S={s} H={h} KV={kv} hd={hd}, causal, bf16): forward "
            f"{fwd_ms:.4f} ms, bound {bound:.4f} ms ({bound / fwd_ms:.1%} of it), plain "
            f"{plain_ms:.2f} ms, library {lib_ms:.4f} ms; forward + backward {both_ms:.4f} ms, "
            f"bound {3 * bound:.4f} ms ({3 * bound / both_ms:.1%}), plain {plain_both_ms:.2f} "
            f"ms, library {lib_both_ms:.4f} ms; off the plain version (norm-wise) "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (tolerance {ATTN_REL}); {card}")
        del q, k, v, do, lib_args
        torch.cuda.empty_cache()
    return row


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

    # the two corpora are written by processes of their own beside work that
    # times nothing, the build and phase 2; phase 3's device="cpu" twin runs
    # as a process beside phases 3 (after its timed compress) to 6
    (ROOT / "build").mkdir(exist_ok=True)
    corpora = Path(tempfile.mkdtemp(prefix="corpus-", dir=ROOT / "build"))
    atexit.register(shutil.rmtree, corpora, True)
    hdfs_writer = corpus_writer("HDFS", N_LINES, SEED, corpora / "hdfs.log")
    spark_writer = corpus_writer("Spark", OPS_LINES, OPS_SEED, corpora / "spark.log")

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
        # the same grid one element past a 16-byte boundary: its rows and
        # the output's are on different phases, so every group is scalar
        view = torch.zeros(args[0].numel() + 1, dtype=torch.int32, device=dev)[1:]
        view = view.view(args[0].shape).copy_(args[0])
        for tag, a in (("", args), (", input at an offset of one element", [view] + args[1:])):
            # uint32 has few CUDA operators: compare the values as int64
            got = cc.colcodec_transform(*a).to(torch.int64)
            want = cc.colcodec_transform_plain(*a).to(torch.int64)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            mism["colcodec_transform"] += bad + (not torch.equal(got, want))
            log(f"[check] colcodec_transform {name}{tag}: {bad} mismatches")
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
    lines = corpus_read(hdfs_writer, corpora / "hdfs.log", keep=True)
    raw_bytes = sum(len(l.encode("utf-8", "surrogateescape")) + 1 for l in lines)
    log(f"[main] {len(lines)} HDFS lines, {raw_bytes / 1e6:.1f} MB, generated beside phases "
        f"1-2, waited for and read in {time.perf_counter() - t0:.1f} s")
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
    if counts["colcodec_transform"] != 6:  # one a kernel-safe integer column
        raise AssertionError(f"colcodec_transform launched {counts['colcodec_transform']} "
                             f"times, not 6")
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
    twin = cpu_twin(corpora / "hdfs.log", corpora / "hdfs.cpu.lzj")

    # the same compress under the profiler, keeping each kernel's largest input
    ops.reset_launch_counts()
    first_calls: list = []
    wrapper_copies: dict[str, int] = {}
    with capture_largest(ops, first_calls, copies=wrapper_copies) as largest, \
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
        f"{json.dumps({k[:60]: [c, round(us / 1e3, 3)] for k, (c, us) in busy.items()})}")
    copies = {d: [sum(c for k, (c, _) in busy.items() if d in k),
                  round(sum(us for k, (_, us) in busy.items() if d in k) / 1e3, 3)]
              for d in ("DtoH", "HtoD")}
    log(f"[profile] copies under the profiler [count, device ms]: {json.dumps(copies)}; "
        f"{len(first_calls)} first-hit calls over N = {[a[0].shape[0] for a in first_calls]}")
    log(f"[profile] host-to-device copies {copies['HtoD'][0]} (31 with four uploads a "
        f"colcodec_transform call); the wrappers' uploads {json.dumps(wrapper_copies)}")
    if wrapper_copies["colcodec_transform"] != counts["colcodec_transform"] \
            or copies["HtoD"][0] != sum(wrapper_copies.values()):
        raise AssertionError("colcodec_transform made other than one upload a call, or the "
                             "compress copied to the card outside the kernel wrappers")

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
    t0 = time.perf_counter()
    spark = corpus_read(spark_writer, corpora / "spark.log")
    log(f"[ops] {len(spark)} Spark lines, generated beside the build and phase 2, "
        f"waited for and read in {time.perf_counter() - t0:.1f} s")
    ops_counts, ops_inputs, ops_device_ms = ops_phase(np, torch, profile, ProfilerActivity,
                                                      spark)
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
        np, torch, profile, ProfilerActivity, lines, fmt, blob, small)
    counts["distinct_counts"] = q_counts["distinct_counts"]
    device_ms["distinct_counts"] = q_device_ms["distinct_counts"]
    inputs["distinct_counts"] = q_inputs["distinct_counts"]
    log(f"[query] phase 6 took {time.perf_counter() - t0:.1f} s")

    # phase 3's device="cpu" twin, a process beside phases 3-6
    t0 = time.perf_counter()
    out, err = twin.communicate(timeout=900)
    if twin.returncode != 0:
        raise AssertionError(f"the device='cpu' compress failed: {err[-2000:]}")
    cpu_blob = (corpora / "hdfs.cpu.lzj").read_bytes()
    log(f"[main] device='cpu' archive in {float(out.split()[-1]):.2f} s, a process beside "
        f"phases 3-6 (waited for {time.perf_counter() - t0:.1f} s)")
    if cpu_blob != blob:
        raise AssertionError("the card's archive differs from the device='cpu' archive")
    log("[main] archive byte-identical to the device='cpu' archive")
    (corpora / "hdfs.log").unlink()

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
                f"{floor_ms:.5f} ms, the launch at {s_ms / floor_ms:.2f}x it")
            work += f"; at the session's largest input {s_ms:.5f} ms; floor {floor_ms:.5f} ms"
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
        if name in ("colcodec_transform", "simcount", "distinct_counts"):  # not its time
            rows[-1]["launch_floor_ms"] = floor_ms
        if name == "colcodec_transform":
            rows[-1]["session_input_ms"] = s_ms
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

    # -- 8: durability: torn sessions repaired, a session resumed from its journal
    (ROOT / "build").mkdir(exist_ok=True)
    twins = Path(tempfile.mkdtemp(prefix="clean-", dir=ROOT / "build"))
    try:
        d_counts = durability_phase(torch, profile, ProfilerActivity, lines, fmt, twins)
        if not (d_counts["wildcard_match_first"] > 0 and d_counts["colcodec_transform"] > 0):
            raise AssertionError(f"the durability phase skipped a kernel: {d_counts}")

        # -- 9: the ingest daemon, retention and the CLI
        i_counts = ingest_phase(torch, lines, fmt, twins)
    finally:
        shutil.rmtree(twins, ignore_errors=True)
    log(f"[ingest] launches per kernel in the feed: {json.dumps(i_counts)}")

    # -- 10: the data pipeline on the card
    p_counts = pipeline_phase(torch)
    log(f"[pipeline] launches per kernel in the card writes: {json.dumps(p_counts)}")

    # -- 11: serving qwen3-1.7b at full width
    s_stats = serving_phase(np, torch, profile, ProfilerActivity, card)
    log(f"[serve] {json.dumps(s_stats)}; {card}")

    # -- 12: the LM zoo's other families at full width
    f_stats = families_phase(np, torch, card)
    log(f"[family] {json.dumps(f_stats)}; {card}")

    # -- 13: training qwen1.5-0.5b at full width, preempted and resumed
    t_stats = training_phase(np, torch, profile, ProfilerActivity, card)
    log(f"[train] {json.dumps(t_stats)}; {card}")

    # -- 14: distribution: the rules, the sharded match and train step, the
    # cost model, the dry run
    (ROOT / "build").mkdir(exist_ok=True)
    cells_dir = Path(tempfile.mkdtemp(prefix="decode-cells-", dir=ROOT / "build"))
    atexit.register(shutil.rmtree, cells_dir, True)
    t_cells = time.perf_counter()
    cells = _decode_cells_process(cells_dir)  # phase 15 (b), beside 14 and 15 (a)
    try:
        x_stats = distribution_phase(np, torch, card, inputs["wildcard_match"])
    except BaseException:
        cells.kill()
        cells.communicate()
        raise

    # -- 15: the sharded decode path: a one-rank mesh against the plain path,
    # the production decode and prefill cells of the dry run
    d_stats = decode_phase(np, torch, card, cells, cells_dir, t_cells)
    log(f"[decode] {json.dumps({k: v for k, v in d_stats.items() if k != 'dryrun_cells'})}; "
        f"{card}")
    row = next(r for r in rows if r["name"] == "wildcard_match")
    row["launches_by_path"] = {"compress (phase 3)": row["launches"],
                               "wildcard_match_sharded (phase 14)":
                                   x_stats["sharded_match_launches"]}
    row["launches"] += x_stats["sharded_match_launches"]
    row["sharded_match_kernel_ms"] = x_stats["sharded_match_kernel_ms"]
    log(f"[dist] {json.dumps({k: v for k, v in x_stats.items() if k != 'dryrun'})}; {card}")

    # -- 16: the fused attention kernel at the benchmark cells' shapes
    rows.append(attention_phase(torch, card, {"serve": s_stats["attention"],
                                              "train": t_stats["attention"]}))

    log(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
    log(f"[card] {card}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
