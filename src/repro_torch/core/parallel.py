"""Chunked, multi-worker logzip (paper §V-D, Fig 7).

The file is split into chunks; each worker compresses its chunk
independently (sampling+clustering+matching are per-chunk, so the whole
pipeline is embarrassingly parallel — the paper's design). Chunking
slightly hurts CR (no cross-chunk template sharing), exactly as the paper
reports; ``shared_store=True`` recovers most of that loss by running ISE
*once* over a bounded corpus sample (paper §III-E: extraction is a
one-off) and handing every worker the same frozen ``TemplateStore`` —
chunks then compress by matching alone, with store-global EventIDs that
agree across all chunks.

Workers are processes opened with the ``spawn`` start method: a forked
child of a parent that has touched CUDA cannot use the card. Each worker
runs ``compress`` on the ``cfg.device`` it is given; a CUDA error in a
worker raises there and surfaces here, never as a retry on the CPU.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import multiprocessing
import random
import time
from dataclasses import replace

import numpy as np

from . import integrity
from .codec import FILE_MAGIC, LogzipConfig, compress, decompress
from .encode import write_varint
from .stages import pack_stage, run_stages
from .timing import StageTimer

MULTI_MAGIC = b"LZJM"
MULTI_TRAILER = b"LZJE"  # v3: optional CRC32C seal after the last member
STREAM_MAGIC = b"LZJS"  # handled by core.stream; dispatched here too

# worker-pool degradation knobs (DESIGN.md §13): transient failures are
# retried with jittered exponential backoff, then the work runs inline
RETRY_ATTEMPTS = 3
RETRY_BASE_DELAY = 0.05  # seconds; doubled per attempt, +/-50% jitter
TASK_TIMEOUT = 300.0  # per-task result deadline, seconds

# worker was killed / pool broke / task deadline passed / OS-level hiccup;
# ValueError and friends are deterministic and propagate immediately
# (BrokenProcessPool subclasses BrokenExecutor)
_TRANSIENT = (cf.TimeoutError, TimeoutError, OSError, cf.BrokenExecutor)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff schedule with injectable timing (DESIGN.md §15).

    ``sleep`` and ``rng`` default to the real clock / global RNG; fault
    tests inject deterministic substitutes so retry paths are asserted
    on exact delays instead of wall-clock races. The ingestion
    supervisor's circuit breakers reuse the same policy object, so one
    knob tunes both worker-pool and per-tenant resilience."""

    attempts: int = RETRY_ATTEMPTS
    base_delay: float = RETRY_BASE_DELAY
    task_timeout: float = TASK_TIMEOUT
    sleep: object = time.sleep
    rng: object = random.random

    def delay(self, attempt: int) -> float:
        """Jittered exponential delay after failed round ``attempt``
        (0-based): base * 2^attempt, +/-50% jitter from ``rng``."""
        return self.base_delay * (2 ** attempt) * (0.5 + self.rng())

    def backoff(self, attempt: int) -> float:
        """Sleep for ``delay(attempt)`` via the injected clock; returns
        the delay actually slept."""
        d = self.delay(attempt)
        self.sleep(d)
        return d


DEFAULT_RETRY_POLICY = RetryPolicy()


def _map_resilient(fn, items: list, n_workers: int,
                   policy: RetryPolicy | None = None) -> list:
    """``ex.map`` with bounded retries: each failed-transient task is
    retried in a fresh pool with jittered exponential backoff, and
    whatever still fails after ``policy.attempts`` rounds runs inline in
    this process — a dead pool degrades throughput, never correctness.
    Deterministic errors (``ValueError`` from corrupt input) raise on
    the first attempt."""
    policy = policy or DEFAULT_RETRY_POLICY
    results: list = [None] * len(items)
    pending = list(range(len(items)))
    for attempt in range(policy.attempts):
        if not pending:
            return results
        ex = cf.ProcessPoolExecutor(max_workers=min(n_workers, len(pending)),
                                    mp_context=multiprocessing.get_context("spawn"))
        try:
            futs = {i: ex.submit(fn, items[i]) for i in pending}
            still = []
            for i in pending:
                try:
                    results[i] = futs[i].result(timeout=policy.task_timeout)
                except _TRANSIENT:
                    still.append(i)
            pending = still
        except _TRANSIENT:
            pass  # pool itself broke mid-submit: everything retries
        finally:
            # wait=False: a hung worker must not wedge the retry loop
            ex.shutdown(wait=False, cancel_futures=True)
        if pending:
            policy.backoff(attempt)
    for i in pending:  # last resort: inline, no pool to break
        results[i] = fn(items[i])
    return results


def seed_template_store(lines: list[str], cfg: LogzipConfig, max_sample: int = 8000):
    """One-off ISE over a bounded, deterministic sample -> shared store.

    The sample is an evenly-strided slice of the corpus (deterministic,
    covers drift along the file) capped at ``max_sample`` lines, so the
    seeding cost stays O(max_sample) regardless of corpus size.
    """
    from .templates import extract_templates

    n = len(lines)
    k = min(n, max_sample, max(4 * cfg.ise.min_sample,
                               int(round(cfg.ise.sample_rate * n))))
    if 0 < k < n:
        idx = np.linspace(0, n - 1, k).astype(np.int64)
        sample = [lines[int(i)] for i in idx]
    else:
        sample = list(lines)
    return extract_templates(sample, cfg.format, cfg.ise, device=cfg.device)


def _compress_chunk(args) -> bytes:
    lines, cfg = args
    return compress(lines, cfg)


def compress_parallel(
    lines: list[str],
    cfg: LogzipConfig | None = None,
    n_workers: int = 1,
    chunk_lines: int | None = None,
    shared_store: bool = False,
) -> bytes:
    """Compress with ``n_workers`` processes over line chunks.

    ``shared_store=True`` seeds one ``TemplateStore`` from a corpus
    sample and shares it across every chunk (match-only workers,
    cross-chunk template sharing, store-global EventIDs)."""
    cfg = cfg or LogzipConfig()
    if chunk_lines is None:
        chunk_lines = max(1, (len(lines) + n_workers - 1) // max(n_workers, 1))
    chunks = [lines[i : i + chunk_lines] for i in range(0, len(lines), chunk_lines)] or [[]]

    if shared_store and cfg.level >= 2 and cfg.template_store is None and len(chunks) > 1:
        cfg = replace(cfg, template_store=seed_template_store(lines, cfg))

    if n_workers <= 1 or len(chunks) == 1:
        blobs = _compress_chunks_pipelined(chunks, cfg)
    else:
        blobs = _map_resilient(_compress_chunk, [(c, cfg) for c in chunks],
                               n_workers)
    return frame_multi(blobs, seal=cfg.integrity)


def _compress_chunks_pipelined(chunks: list[list[str]], cfg: LogzipConfig) -> list[bytes]:
    """Sequential chunk compression with the entropy kernel double-
    buffered onto one worker thread (DESIGN.md §10.4): gzip of chunk k
    overlaps the parse/tokenize/match of chunk k+1. Blob order (and
    bytes) are identical to the serial loop."""
    if len(chunks) == 1:
        return [compress(chunks[0], cfg)]
    with cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="lzjm-pack") as ex:
        futs = []
        for c in chunks:
            ch = run_stages(c, cfg)
            if len(futs) >= 2:
                futs[-2].result()  # double buffer: at most 2 chunks in flight
            futs.append(ex.submit(pack_stage, ch, cfg, StageTimer(None)))
        return [f.result() for f in futs]


def frame_multi(blobs: list[bytes], seal: bool = False) -> bytes:
    """Frame per-chunk archive blobs into the ``LZJM`` container.

    With ``seal`` a ``LZJE`` + CRC32C trailer over the whole framed body
    is appended (v3 archives); readers verify it when present and accept
    its absence, so v1/v2 archive bytes are untouched."""
    out = bytearray(MULTI_MAGIC)
    write_varint(out, len(blobs))
    for b in blobs:
        write_varint(out, len(b))
        out += b
    if seal:
        out += MULTI_TRAILER + integrity.trailer(bytes(out))
    return bytes(out)


def iter_multi_chunks(blob: bytes):
    """Yield the per-chunk LZJF blobs of an ``LZJM`` container.

    Raises ``ValueError`` (never a bare assert) on bad magic or a
    truncated record — messages carry the byte offset, chunk index and
    frame type of the failure. A trailing ``LZJE`` seal, when present,
    is verified after the last member."""
    if len(blob) < 4 or blob[:4] != MULTI_MAGIC:
        raise ValueError(
            f"not a multi-chunk logzip archive: magic {bytes(blob[:4])!r}, "
            f"expected {MULTI_MAGIC!r}")
    pos = 4

    def rd(what: str) -> int:
        nonlocal pos
        cur, shift = 0, 0
        while True:
            if pos >= len(blob):
                raise ValueError(f"truncated LZJM archive: {what} varint at "
                                 f"byte {pos} runs past the end")
            b = blob[pos]
            pos += 1
            cur |= (b & 0x7F) << shift
            if not (b & 0x80):
                return cur
            shift += 7

    n = rd("member count")
    for i in range(n):
        ln = rd(f"chunk {i} length")
        if pos + ln > len(blob):
            raise ValueError(
                f"truncated LZJM archive: chunk {i} at byte {pos} claims "
                f"{ln} bytes, {len(blob) - pos} remain")
        yield blob[pos : pos + ln]
        pos += ln
    if blob[pos:pos + 4] == MULTI_TRAILER:
        integrity.verify(
            blob[:pos], bytes(blob[pos + 4:pos + 4 + integrity.CRC_LEN]),
            frame="lzjm_archive", offset=pos)


def decompress_parallel(blob: bytes, n_workers: int = 1) -> list[str]:
    """Decode any of the three archive forms (LZJF / LZJM / LZJS)."""
    if len(blob) >= 4 and blob[:4] == FILE_MAGIC:  # plain single archive
        return decompress(blob)
    if len(blob) >= 4 and blob[:4] == STREAM_MAGIC:
        from .stream import decompress_lzjs

        return decompress_lzjs(blob)
    if len(blob) < 4 or blob[:4] != MULTI_MAGIC:
        raise ValueError(
            f"not a logzip archive: magic {bytes(blob[:4])!r} "
            f"(expected {FILE_MAGIC!r}, {MULTI_MAGIC!r} or {STREAM_MAGIC!r})")
    parts = list(iter_multi_chunks(blob))
    if n_workers <= 1 or len(parts) == 1:
        decoded = [decompress(p) for p in parts]
    else:
        decoded = _map_resilient(decompress, parts, n_workers)
    out: list[str] = []
    for d in decoded:
        out.extend(d)
    return out
