"""Baseline compressors for the paper's Table II comparison.

- ``kernel_baseline``: raw gzip / bzip2 / lzma over the file (the paper's
  main baselines).
- ``logarchive_like``: simplified re-implementation of LogArchive
  (Christensen & Li, SIGMOD'13): lines are adaptively routed to buckets by
  similarity to each bucket's recent window; buckets are compressed
  separately; a per-line bucket index restores order. Approximation — the
  original is not available offline (noted in DESIGN.md §6.4).
- ``cowic_like``: simplified Cowic (Lin et al., CCGrid'15): column-wise
  split by whitespace position, one object per column, compressed
  per-column (Cowic optimizes query latency, not CR — expect CR ~ gzip,
  as in the paper).

All are lossless and share the same kernel implementations as logzip, so
comparisons isolate the *representation*, not the entropy coder.
"""

from __future__ import annotations

from collections import deque

from .codec import KERNELS
from .encode import join_column, pack_container, split_column, unpack_container, encode_varints, decode_varints


def kernel_baseline(lines: list[str], kernel: str = "gzip") -> bytes:
    return KERNELS[kernel][1]("\n".join(lines).encode("utf-8"))


def kernel_baseline_decompress(blob: bytes, kernel: str = "gzip") -> list[str]:
    return KERNELS[kernel][2](blob).decode("utf-8").split("\n")


# ------------------------------------------------------------- LogArchive

def _sim(a: set, b: set) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / max(len(a), len(b))


def logarchive_like(lines: list[str], kernel: str = "gzip", n_buckets: int = 16, window: int = 8) -> bytes:
    buckets: list[list[str]] = [[] for _ in range(n_buckets)]
    windows: list[deque] = [deque(maxlen=window) for _ in range(n_buckets)]
    route: list[int] = []
    for line in lines:
        toks = set(line.split())
        best, best_s = 0, -1.0
        for b in range(n_buckets):
            s = max((_sim(toks, w) for w in windows[b]), default=0.0)
            if s > best_s:
                best, best_s = b, s
        if best_s <= 0.0:  # start filling empty buckets round-robin
            empties = [b for b in range(n_buckets) if not buckets[b]]
            if empties:
                best = empties[0]
        route.append(best)
        buckets[best].append(line)
        windows[best].append(toks)
    objs = {"route": encode_varints(route)}
    for b in range(n_buckets):
        objs[f"b{b}"] = join_column(buckets[b])
    return KERNELS[kernel][1](pack_container(objs))


def logarchive_like_decompress(blob: bytes, kernel: str = "gzip") -> list[str]:
    objs = unpack_container(KERNELS[kernel][2](blob))
    route = decode_varints(objs["route"])
    cols = {}
    cursors = {}
    out = []
    for b in route:
        if b not in cols:
            cols[b] = split_column(objs[f"b{b}"])
            cursors[b] = 0
        out.append(cols[b][cursors[b]])
        cursors[b] += 1
    return out


# ------------------------------------------------------------------ Cowic

def cowic_like(lines: list[str], kernel: str = "gzip", max_cols: int = 16) -> bytes:
    cols: list[list[str]] = [[] for _ in range(max_cols)]
    for line in lines:
        parts = line.split(" ", max_cols - 1)
        for c in range(max_cols):
            cols[c].append(parts[c] if c < len(parts) else "\x00")
    objs = {f"c{c}": join_column(col) for c, col in enumerate(cols)}
    objs["n"] = encode_varints([len(lines)])
    return KERNELS[kernel][1](pack_container(objs))


def cowic_like_decompress(blob: bytes, kernel: str = "gzip", max_cols: int = 16) -> list[str]:
    objs = unpack_container(KERNELS[kernel][2](blob))
    n = decode_varints(objs["n"])[0]
    cols = [split_column(objs[f"c{c}"]) for c in range(max_cols)]
    out = []
    for r in range(n):
        parts = [cols[c][r] for c in range(max_cols) if cols[c][r] != "\x00"]
        out.append(" ".join(parts))
    return out
