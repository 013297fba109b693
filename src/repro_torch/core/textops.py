"""Vectorized segment machinery for the device-resident hot path
(DESIGN.md §10).

The compression pipeline repeatedly does one thing to text: cut a large
buffer into segments (tokens, delimiter runs, sub-field parts) and
intern each *distinct* segment exactly once. Done per line in Python
this dominates the profile; done here it is a handful of numpy passes
over one contiguous uint8 buffer:

- ``seg_hashes``: 64-bit polynomial hashes of ``[start, end)`` segments
  in O(buffer) via a prefix-sum + modular-inverse power table (the host
  mirror of the rolling-hash scan in the reference's ``repro.kernels.tokenize``).
- ``intern_segments``: distinct-segment ids in **first-occurrence
  order** — the order every dictionary in the archive format is keyed
  on — materializing a Python string only once per distinct segment.

Hashes are 64-bit with a length/salt mix; segments are compared by hash
only (interning ~1e5 segments collides with probability ~1e-10; the
archive round-trip property tests would catch a collision loudly).
"""

from __future__ import annotations

import numpy as np

# FNV-ish odd multiplier (odd -> invertible mod 2^64) and a golden-ratio
# salt mixed with the segment length to separate equal-sum segments.
_P = 0x100000001B3
_PINV = pow(_P, -1, 1 << 64)
_SALT = 0x9E3779B97F4A7C15

_pow_cache = np.ones(1, np.uint64)
_ipow_cache = np.ones(1, np.uint64)


def _powers(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(P**i, P**-i) mod 2^64 for i in [0, n] — grown geometrically and
    cached (data-independent, so one table serves every call)."""
    global _pow_cache, _ipow_cache
    if len(_pow_cache) < n + 1:
        m = max(n + 1, 2 * len(_pow_cache))
        pw = np.empty(m, np.uint64)
        ipw = np.empty(m, np.uint64)
        pw[0] = ipw[0] = 1
        np.cumprod(np.full(m - 1, _P, np.uint64), out=pw[1:])
        np.cumprod(np.full(m - 1, _PINV, np.uint64), out=ipw[1:])
        _pow_cache, _ipow_cache = pw, ipw
    return _pow_cache, _ipow_cache


class SegmentHasher:
    """Position-independent segment hashes over one byte buffer.

    The prefix sum is computed once in ``__init__``; each ``hashes``
    call is then two gathers + two multiplies:
    ``h = (pref[e] - pref[s]) * P**-s`` equals the polynomial
    ``sum (buf[s+k]+1) * P**k`` regardless of position, so equal
    segments hash equal wherever they sit.
    """

    def __init__(self, buf: np.ndarray):
        n = len(buf)
        pw, self._ipw = _powers(n)
        w = (buf.astype(np.uint64) + np.uint64(1)) * pw[:n]
        self._pref = np.empty(n + 1, np.uint64)
        self._pref[0] = 0
        np.cumsum(w, out=self._pref[1:])

    def hashes(self, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
        h = (self._pref[ends] - self._pref[starts]) * self._ipw[starts]
        return h ^ ((ends - starts).astype(np.uint64) * np.uint64(_SALT))


def seg_hashes(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """One-shot convenience over ``SegmentHasher``."""
    return SegmentHasher(buf).hashes(starts, ends)


def first_occurrence_unique(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """-> (inverse ids, first-occurrence index of each distinct key), with
    ids numbered in first-occurrence order (what ``encode.factorize``
    produces, without touching Python objects)."""
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    remap = np.empty(len(first), np.int64)
    remap[order] = np.arange(len(first))
    return remap[inv], first[order]


def intern_segments(
    data: bytes, hasher: "SegmentHasher", starts: np.ndarray, ends: np.ndarray,
) -> tuple[np.ndarray, list[str]]:
    """Hash-intern segments -> (ids in first-occurrence order, distinct
    segment strings). ``data`` is the Python bytes the hasher's buffer
    views, so only distinct segments are sliced/decoded.
    """
    if len(starts) == 0:
        return np.zeros(0, np.int64), []
    ids, first = first_occurrence_unique(hasher.hashes(starts, ends))
    ss = starts[first].tolist()
    es = ends[first].tolist()
    table = [data[s:e].decode("utf-8", "surrogateescape") for s, e in zip(ss, es)]
    return ids, table


def runs_of(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the maximal True runs of a 1-D bool mask."""
    edges = np.flatnonzero(np.diff(np.concatenate(
        [np.zeros(1, np.int8), mask.view(np.int8), np.zeros(1, np.int8)])))
    return edges[::2], edges[1::2]


def class_mask(chars: str) -> np.ndarray:
    """256-entry uint8 lookup table marking the bytes of ``chars``
    (ASCII-only classes; multi-byte UTF-8 units are never members, which
    is exactly the \"non-delimiter\" semantics every caller wants)."""
    lut = np.zeros(256, bool)
    for c in chars:
        b = ord(c)
        if b < 128:
            lut[b] = True
    return lut
