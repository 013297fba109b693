"""Per-chunk screens for O(1)-chunk point queries (DESIGN.md §14).

A *screen* is a small, CRC-sealed optional frame appended to an LZJS
chunk record AFTER its commit record. It carries split-block Bloom
filters (SBBF, the Parquet construction) that bound which chunks can
realize a value, consulted by the query engine before any gunzip:

- a **param bloom** over the chunk's *cold* ParamDict references: a
  session ParaID that appears in few chunks is the signature of a
  high-cardinality point value (a block id, a request id). Hot ids —
  everything referenced by more than ``COLD_REF_CHUNKS + 1`` chunks —
  are never screened (the footer's ``screens.cold`` list tells the
  reader which ids are bloom-decidable at all), so the filters stay
  tiny while point queries touch O(1) chunks.
- **field blooms** over the distinct values of high-cardinality header
  fields (the ones whose manifest summary carries no ``v`` value list).

Soundness contract (property-tested screened ≡ unscreened): a screen
may only claim "this chunk CANNOT contain the value". The writer inserts
every cold old-reference it counts; readers treat any id outside the
cold list — including ids the writer never counted, e.g. short or
non-alphanumeric values — as hot, i.e. unprunable. Frames ride inside
the record's indexed byte range, so pre-screen v3 readers (and the
footer-driven random-access paths) skip them for free, and ``OPT1``
frames of *unknown* kind are skipped by construction — forward compat
for future optional frames.
"""

from __future__ import annotations

import numpy as np

from . import integrity
from .encode import write_varint

OPT_MAGIC = b"OPT1"
SCREEN_KIND = b"SCRN"
SCREEN_VERSION = 1

# minimum alphanumeric-run length the param screen indexes; shorter
# needles fall back to the ParamDict watermark screen alone. Matches the
# scale of WIDE_INT_TEXT identifiers the session dict is built to dedup.
RUN_MIN_LEN = 8
# a ParaID referenced by at most this many OTHER chunks (beyond its
# introducing chunk) is cold: bloom-decidable. Ids seen in more chunks
# are hot — screening them buys little pruning and costs bloom bits.
COLD_REF_CHUNKS = 1
# counters saturate here: every decision (insert eligibility at
# <= COLD_REF_CHUNKS, coldness at <= COLD_REF_CHUNKS + 1) is already
# settled once a count reaches this bound, so persisted counters lose
# nothing by capping — the footer meta stays small on hot ids.
COUNT_CAP = COLD_REF_CHUNKS + 2
DEFAULT_FPP = 0.02
# per-chunk byte budget across all of a chunk's blooms (<1% of archive
# size on the benchmark corpora, CR-gated); the param bloom has priority
SCREEN_CHUNK_BUDGET = 1536
FIELD_BLOOM_MAX_KEYS = 512

_BLOCK_BYTES = 32  # 8 x uint32 words per SBBF block

# Parquet SBBF salt constants — one odd multiplier per word lane
_SALTS = np.array([
    0x47b6137b, 0x44974d91, 0x8824ad5b, 0xa2b7289d,
    0x705495c7, 0x2df1424b, 0x9efc4947, 0x5c6bfb31,
], dtype=np.uint64)

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _hash_key(key: int | str) -> int:
    """Deterministic 64-bit hash; dependency-free so writer and readers
    across processes/platforms agree bit-for-bit."""
    if isinstance(key, int):
        return _splitmix64(key & _M64)
    h = 0xCBF29CE484222325  # FNV-1a 64 over utf-8, then finalize
    for b in key.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & _M64
    return _splitmix64(h)


class SBBF:
    """Split-block Bloom filter: 32-byte blocks, 8 bits per key (one per
    word lane), block chosen by the hash's high 32 bits. No false
    negatives ever; FPP ≈ (1 - e^(-8/c))^8 at c bits/key."""

    def __init__(self, nblocks: int):
        self.nblocks = max(1, int(nblocks))
        self.words = np.zeros(self.nblocks * 8, dtype=np.uint32)

    @classmethod
    def sized(cls, n_keys: int, fpp: float = DEFAULT_FPP,
              max_bytes: int | None = None) -> "SBBF":
        c = 8.0 / -np.log1p(-float(fpp) ** (1.0 / 8.0))  # bits per key
        nblocks = int(np.ceil(c * max(1, n_keys) / (_BLOCK_BYTES * 8)))
        if max_bytes is not None:
            nblocks = min(nblocks, max(1, max_bytes // _BLOCK_BYTES))
        return cls(nblocks)

    def _mask(self, key: int | str) -> tuple[int, np.ndarray]:
        h = _hash_key(key)
        block = (h >> 32) % self.nblocks
        x = np.uint64(h & 0xFFFFFFFF)
        bits = ((x * _SALTS) >> np.uint64(27)) & np.uint64(31)
        return int(block), (np.uint32(1) << bits.astype(np.uint32))

    def add(self, key: int | str) -> None:
        block, mask = self._mask(key)
        self.words[block * 8:block * 8 + 8] |= mask

    def contains(self, key: int | str) -> bool:
        block, mask = self._mask(key)
        w = self.words[block * 8:block * 8 + 8]
        return bool(np.all(w & mask == mask))

    @property
    def nbytes(self) -> int:
        return self.nblocks * _BLOCK_BYTES

    def to_bytes(self) -> bytes:
        return self.words.astype("<u4").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "SBBF":
        if not data or len(data) % _BLOCK_BYTES:
            raise ValueError(f"SBBF payload not block-aligned: {len(data)} bytes")
        f = cls(len(data) // _BLOCK_BYTES)
        f.words = np.frombuffer(data, dtype="<u4").astype(np.uint32)
        return f


def bloom_fpp(n_keys: int, nbytes: int) -> float:
    """Predicted false-positive rate of an SBBF holding ``n_keys`` in
    ``nbytes`` (surfaced in ``grep --stats`` next to the observed rate)."""
    if not n_keys or not nbytes:
        return 0.0
    c = nbytes * 8.0 / n_keys
    return float((1.0 - np.exp(-8.0 / c)) ** 8)


# -------------------------------------------------------------- frame codec

def _uvarint(payload: bytes, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(payload):
            raise ValueError("truncated varint in screen payload")
        b = payload[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def build_screen_payload(param_bloom: SBBF | None, param_keys: int,
                         field_blooms: dict[str, tuple[SBBF, int]]) -> bytes:
    out = bytearray([SCREEN_VERSION])
    write_varint(out, param_keys)
    write_varint(out, param_bloom.nblocks if param_bloom is not None else 0)
    if param_bloom is not None:
        out += param_bloom.to_bytes()
    write_varint(out, len(field_blooms))
    for name in sorted(field_blooms):
        bloom, n_keys = field_blooms[name]
        nb = name.encode("utf-8")
        write_varint(out, len(nb))
        out += nb
        write_varint(out, n_keys)
        write_varint(out, bloom.nblocks)
        out += bloom.to_bytes()
    return bytes(out)


def build_opt_frame(kind: bytes, payload: bytes) -> bytes:
    """``OPT1 | kind(4) | varint(len) | payload | crc32c`` — the CRC
    seals the whole frame, magic and kind included."""
    if len(kind) != 4:
        raise ValueError("optional-frame kind must be 4 bytes")
    body = bytearray(OPT_MAGIC)
    body += kind
    write_varint(body, len(payload))
    body += payload
    return bytes(body) + integrity.trailer(bytes(body))


class ChunkScreen:
    """Parsed read side of one chunk's ``SCRN`` frame."""

    def __init__(self, param: SBBF | None, param_keys: int,
                 fields: dict[str, tuple[SBBF, int]]):
        self.param = param
        self.param_keys = param_keys
        self.fields = fields

    def may_contain_param(self, pid: int) -> bool:
        """MAY the chunk reference cold ParaID ``pid``? No-bloom chunks
        answer yes (sound)."""
        return True if self.param is None else self.param.contains(int(pid))

    def field_may_contain(self, name: str, value: str) -> bool | None:
        """Tri-state: None when the field has no bloom (undecidable)."""
        ent = self.fields.get(name)
        if ent is None:
            return None
        return ent[0].contains(value)


def parse_screen_payload(payload: bytes) -> ChunkScreen:
    if not payload or payload[0] != SCREEN_VERSION:
        raise ValueError(f"unknown screen version {payload[:1]!r}")
    pos = 1
    param_keys, pos = _uvarint(payload, pos)
    nblocks, pos = _uvarint(payload, pos)
    param = None
    if nblocks:
        end = pos + nblocks * _BLOCK_BYTES
        param = SBBF.from_bytes(payload[pos:end])
        pos = end
    n_fields, pos = _uvarint(payload, pos)
    fields: dict[str, tuple[SBBF, int]] = {}
    for _ in range(n_fields):
        nlen, pos = _uvarint(payload, pos)
        name = payload[pos:pos + nlen].decode("utf-8")
        pos += nlen
        fkeys, pos = _uvarint(payload, pos)
        fblocks, pos = _uvarint(payload, pos)
        end = pos + fblocks * _BLOCK_BYTES
        fields[name] = (SBBF.from_bytes(payload[pos:end]), fkeys)
        pos = end
    return ChunkScreen(param, param_keys, fields)


def skip_opt_frames(data: bytes, pos: int) -> int:
    """Advance ``pos`` past any well-formed optional frames (salvage gap
    walks: commit-derived record lengths exclude trailing screens, so the
    walker must hop over them to reach the next ``CHNK``). Screens are
    expendable — a malformed frame simply stops the skip."""
    while data[pos:pos + 4] == OPT_MAGIC:
        try:
            plen, p = _uvarint(data, pos + 8)
        except ValueError:
            break
        end = p + plen + integrity.CRC_LEN
        if end > len(data):
            break
        pos = end
    return pos


# ------------------------------------------------------------------ builder

class ScreenBuilder:
    """Session-lifetime screen state on the write side.

    Tracks, per ParaID, how many chunks have referenced it (its
    introducing chunk included). ``chunk_screen`` is called once per
    chunk — BEFORE the counters are advanced — and inserts into that
    chunk's bloom every *old* reference (``pid < pd_base``) whose prior
    chunk-count is still ≤ ``COLD_REF_CHUNKS``; at close,
    ``cold_params()`` reports which ids stayed bloom-decidable. Ids the
    builder never counted (short values, values that are not a single
    alphanumeric run) are absent from the cold list, so readers treat
    them as hot — never bloom-tested — keeping the screen sound.
    """

    def __init__(self, fpp: float = DEFAULT_FPP,
                 budget: int = SCREEN_CHUNK_BUDGET,
                 counts: dict[int, int] | None = None):
        self.fpp = float(fpp)
        self.budget = int(budget)
        self._counts: dict[int, int] = dict(counts) if counts else {}

    @classmethod
    def restore(cls, meta: dict, *, fpp: float = DEFAULT_FPP,
                budget: int = SCREEN_CHUNK_BUDGET) -> "ScreenBuilder | None":
        """Rebuild a builder from a footer ``screens`` entry so an
        append session keeps emitting sound frames (the counters are the
        cross-chunk state the frames' soundness depends on). Returns
        None for archives written before the counters were persisted —
        those appends must keep dropping screens, as they always did."""
        if not isinstance(meta, dict) or "c1" not in meta or "hot" not in meta:
            return None
        counts = {int(p): COUNT_CAP for p in meta["hot"]}
        for p in meta.get("cold", []):
            counts[int(p)] = COLD_REF_CHUNKS + 1
        for p in meta["c1"]:
            counts[int(p)] = 1
        return cls(float(meta.get("fpp", fpp)), budget, counts=counts)

    def chunk_refs(self, texts, to_id_get, pd_base: int, pd_end: int
                   ) -> tuple[set[int], set[int]]:
        """Scan the chunk's line texts for ParamDict references.

        Returns ``(old_refs, all_refs)``: distinct referenced ids split
        by whether the id predates this chunk. Only ids below ``pd_end``
        count — the pack worker runs concurrently with the next chunk's
        encode growing the shared dict, and ids introduced later cannot
        be realized by THIS chunk's parameter values.
        """
        from .query import _ALNUM_RUN_RE  # single source of run syntax

        refs: set[int] = set()
        for t in texts:
            for m in _ALNUM_RUN_RE.finditer(t):
                if m.end() - m.start() < RUN_MIN_LEN:
                    continue
                pid = to_id_get(m.group())
                if pid is not None and pid < pd_end:
                    refs.add(pid)
        return {p for p in refs if p < pd_base}, refs

    def chunk_screen(self, old_refs: set[int], all_refs: set[int],
                     field_cols: dict[str, list[str]] | None = None,
                     field_has_vals: dict[str, bool] | None = None) -> bytes | None:
        """Build one chunk's ``SCRN`` frame (or None when empty), then
        advance the per-id chunk counters."""
        cold_old = [p for p in old_refs if self._counts.get(p, 0) <= COLD_REF_CHUNKS]
        for p in all_refs:
            self._counts[p] = min(self._counts.get(p, 0) + 1, COUNT_CAP)

        spent = 0
        param = None
        if cold_old:
            param = SBBF.sized(len(cold_old), self.fpp, max_bytes=self.budget)
            for p in cold_old:
                param.add(p)
            spent = param.nbytes

        fields: dict[str, tuple[SBBF, int]] = {}
        for name, col in (field_cols or {}).items():
            if field_has_vals and field_has_vals.get(name):
                continue  # manifest value list already decides equality
            distinct = set(col)
            if not distinct or len(distinct) > FIELD_BLOOM_MAX_KEYS:
                continue
            room = self.budget - spent
            if room < _BLOCK_BYTES:
                break
            bloom = SBBF.sized(len(distinct), self.fpp, max_bytes=room)
            for v in distinct:
                bloom.add(v)
            fields[name] = (bloom, len(distinct))
            spent += bloom.nbytes

        if param is None and not fields:
            return None
        payload = build_screen_payload(param, len(cold_old), fields)
        return build_opt_frame(SCREEN_KIND, payload)

    def cold_params(self) -> list[int]:
        """Ids whose total chunk-count stayed within the cold bound —
        the ONLY ids readers may test against the param blooms."""
        bound = COLD_REF_CHUNKS + 1
        return sorted(p for p, c in self._counts.items() if c <= bound)

    def meta(self) -> dict:
        """Footer ``screens`` entry: reader-side protocol constants plus
        the saturated reference counters (``c1`` = cold ids still at one
        chunk, ``hot`` = ids past the cold bound), which ``restore``
        re-seeds an append session from. Readers ignore the extra keys."""
        return {"r": COLD_REF_CHUNKS, "fpp": self.fpp,
                "minrun": RUN_MIN_LEN, "cold": self.cold_params(),
                "c1": sorted(p for p, c in self._counts.items() if c == 1),
                "hot": sorted(p for p, c in self._counts.items()
                              if c > COLD_REF_CHUNKS + 1)}
