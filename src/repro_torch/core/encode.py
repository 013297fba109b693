"""Object encoders for the logzip 3-level representation (paper §IV-B).

Everything here is lossless by construction:

- ``varint`` streams for id columns (EventIDs, pattern ids, ParaIDs).
  (The paper renders ParaIDs as base-64 *text*; we use LEB128 binary —
  same idea, strictly denser before the kernel. Recorded in DESIGN.md §3.)
- ``esc``/``unesc`` make arbitrary strings newline-safe so columns can be
  newline-joined.
- ``ColumnCodec``: the paper's sub-field splitting. Each value is split on
  runs of non-alphanumeric characters; the delimiter skeleton becomes a
  *pattern* (interned in a dictionary, one varint id per line) and the
  alphanumeric runs become per-slot columns. With ``dictionary=True``
  (Level 3) slot values are additionally interned in a shared
  ``ParamDict`` and stored as varint ParaIDs.
"""

from __future__ import annotations

import re
import string

import numpy as np

from .textops import SegmentHasher, class_mask, first_occurrence_unique, intern_segments, runs_of

_ALNUM_LUT = class_mask(string.digits + string.ascii_letters)

# ---------------------------------------------------------------- varint

def write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def encode_varints(values) -> bytes:
    """LEB128-encode a sequence of non-negative ints, vectorized.

    Identical byte output to a per-value ``write_varint`` loop; the whole
    stream is assembled with numpy (single-byte fast path for id columns
    that fit in 7 bits, which is most of them)."""
    arr = values if isinstance(values, np.ndarray) else np.asarray(list(values))
    if arr.size == 0:
        return b""
    if arr.dtype == object or arr.dtype.kind not in "iu":
        # arbitrary-precision values (or non-int input): scalar fallback
        out = bytearray()
        for v in arr.ravel():
            write_varint(out, int(v))
        return bytes(out)
    v = arr.astype(np.uint64).ravel()
    if int(v.max()) < 0x80:
        return v.astype(np.uint8).tobytes()
    nbytes = np.ones(v.shape, np.int64)
    x = v >> np.uint64(7)
    while x.any():
        nbytes += x > 0
        x >>= np.uint64(7)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    out = np.zeros(int(ends[-1]), np.uint8)
    for b in range(int(nbytes.max())):
        sel = nbytes > b
        byte = ((v[sel] >> np.uint64(7 * b)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nbytes[sel] > b + 1).astype(np.uint8) << 7
        out[starts[sel] + b] = byte | cont
    return out.tobytes()


def decode_varints(data: bytes) -> list[int]:
    out: list[int] = []
    cur = 0
    shift = 0
    for b in data:
        cur |= (b & 0x7F) << shift
        if b & 0x80:
            shift += 7
        else:
            out.append(cur)
            cur = 0
            shift = 0
    return out


# ---------------------------------------------------------------- escaping

_ESC_RE = re.compile(r"[\\\n\r\x00\x02]")


def esc(s: str) -> str:
    # almost every value needs no escaping — one C-level scan beats five
    # replace passes (byte-identical output either way)
    if _ESC_RE.search(s) is None:
        return s
    return (
        s.replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace("\r", "\\r")
        .replace("\x00", "\\0")
        .replace("\x02", "\\2")
    )


def unesc(s: str) -> str:
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            out.append({"\\": "\\", "n": "\n", "r": "\r", "0": "\x00", "2": "\x02"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def join_column(values: list[str], already_safe: bool = False) -> bytes:
    """varint count prefix + newline-joined escaped values (unambiguous
    for [] vs [""]).

    ``already_safe=True`` skips the per-value ``esc`` pass for values the
    caller guarantees contain no escapable bytes (e.g. alphanumeric
    sub-field parts) — byte-identical output, since ``esc`` is the
    identity on such strings."""
    head = bytearray()
    write_varint(head, len(values))
    joined = "\n".join(values) if already_safe else "\n".join(esc(v) for v in values)
    return bytes(head) + joined.encode("utf-8")


def split_column(data: bytes) -> list[str]:
    n = 0
    shift = 0
    pos = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if n == 0:
        return []
    vals = data[pos:].decode("utf-8").split("\n")
    assert len(vals) == n, (len(vals), n)
    return [unesc(v) for v in vals]


# ---------------------------------------------------------------- ParamDict

class ParamDict:
    """Global value->ParaID dictionary shared by all groups (paper L3).

    Append-only, so a streaming session can share ONE dict across chunks:
    seed it with the accumulated values, then ``encode_delta(base)``
    serializes only the values this chunk added — ParaIDs are global and
    stable for the life of the session (mirrors ``TemplateStore.add``).
    """

    def __init__(self, seed: list[str] | None = None):
        self.values: list[str] = list(seed) if seed else []
        self._to_id: dict[str, int] = {v: i for i, v in enumerate(self.values)}

    def id(self, value: str) -> int:
        i = self._to_id.get(value)
        if i is None:
            i = len(self.values)
            self._to_id[value] = i
            self.values.append(value)
        return i

    def encode(self) -> bytes:
        return join_column(self.values)

    def encode_delta(self, base: int) -> bytes:
        return join_column(self.values[base:])

    @staticmethod
    def decode(data: bytes) -> list[str]:
        return split_column(data)


# ---------------------------------------------------------------- columns

def factorize(values) -> tuple[np.ndarray, list]:
    """(inverse indices, distinct values in first-occurrence order).

    The first-occurrence order is load-bearing: every dedup fast path in
    the codec relies on it to reproduce the non-dedup byte stream
    (pattern ids, ParaIDs and vocab ids are all assigned at first
    occurrence). One implementation, shared — do not fork it."""
    seen: dict = {}
    inv = np.empty(len(values), np.int64)
    uniq: list = []
    for i, v in enumerate(values):
        j = seen.get(v)
        if j is None:
            j = len(uniq)
            seen[v] = j
            uniq.append(v)
        inv[i] = j
    return inv, uniq


_SLOT_RE = re.compile(r"[0-9A-Za-z]+")


def split_subfields(value: str) -> tuple[str, list[str]]:
    """Split on non-alphanumeric runs. -> (pattern with \\x00 slots, parts)."""
    parts = _SLOT_RE.findall(value)
    pattern = _SLOT_RE.sub("\x00", value)
    return pattern, parts


def split_subfields_batch(values: list[str]) -> tuple[list[str], np.ndarray, list[str], np.ndarray]:
    """``split_subfields`` over a batch in a few numpy passes.

    -> (patterns, part ids (flat, row-major), part table, row_ptr): the
    parts of ``values[j]`` are ``table[pid]`` for ``pid`` in
    ``part_ids[row_ptr[j]:row_ptr[j+1]]``, with the table in
    first-occurrence order. Values must be pre-escaped (``esc``), which
    guarantees they are newline-free so the batch can be newline-joined;
    anything that defeats utf-8 encoding falls back to the scalar loop.
    """
    n = len(values)
    row_ptr = np.zeros(n + 1, np.int64)
    if n == 0:
        return [], np.zeros(0, np.int64), [], row_ptr
    try:
        data = "\n".join(values).encode("utf-8", "surrogateescape")
    except UnicodeEncodeError:
        pats: list[str] = []
        flat: list[int] = []
        table: list[str] = []
        seen: dict[str, int] = {}
        for j, v in enumerate(values):
            pat, parts = split_subfields(v)
            pats.append(pat)
            for s in parts:
                i = seen.get(s)
                if i is None:
                    i = len(table)
                    seen[s] = i
                    table.append(s)
                flat.append(i)
            row_ptr[j + 1] = len(flat)
        return pats, np.asarray(flat, np.int64), table, row_ptr

    buf = np.frombuffer(data, np.uint8)
    alnum = _ALNUM_LUT[buf]
    starts, ends = runs_of(alnum)
    part_ids, table = intern_segments(data, SegmentHasher(buf), starts, ends)

    # patterns: drop alnum-run bytes, write \x00 at each run start
    keep = ~alnum
    marked = buf.copy()
    marked[starts] = 0
    keep[starts] = True
    pats = marked[keep].tobytes().decode("utf-8", "surrogateescape").split("\n")

    nl = np.flatnonzero(buf == 0x0A)
    line_starts = np.concatenate([[0], nl + 1])
    line_of = np.searchsorted(line_starts, starts, side="right") - 1
    np.cumsum(np.bincount(line_of, minlength=n), out=row_ptr[1:])
    return pats, part_ids, table, row_ptr


def merge_subfields(pattern: str, parts: list[str]) -> str:
    segs = pattern.split("\x00")
    out = [segs[0]]
    for seg, part in zip(segs[1:], parts):
        out.append(part)
        out.append(seg)
    return "".join(out)


class ColumnCodec:
    """Sub-field columnarization of one string column (paper L1/L2/L3).

    encode(values) -> {name.pat: pattern dict, name.pid: varint pattern ids,
                       name.s<k>: slot-k column (text or varint ParaIDs)}
    Slot columns are grouped *per pattern* so that values sharing a
    skeleton land in the same object (the paper's coherence argument).

    With ``typed=True`` (v2 archives, DESIGN.md §12) the column is first
    run through ``repro_torch.core.coltypes``: columns that classify as an
    integer family / mini-dict / IP-hex type are stored under their typed
    layout (``name.ct`` descriptor + payloads) instead — level-3 typed
    values no longer enter the shared ``ParamDict``. TEXT fallbacks (and
    every v1 archive) use the layout below unchanged; decode dispatches
    on the presence of ``name.ct``. ``type_sink`` receives the per-column
    type summary (feeds ``meta["coltypes"]`` and the LZJS manifests);
    ``use_kernel`` routes the integer transforms through the CUDA
    delta/zigzag kernel on ``device`` (byte-identical output; on a CPU
    device the kernel's plain torch version runs).
    """

    def __init__(self, name: str, paradict: ParamDict | None = None, *,
                 typed: bool = False, type_sink: dict | None = None,
                 use_kernel: bool = True, device: str = "cuda",
                 wide_ints_text: bool = False):
        self.name = name
        self.paradict = paradict
        self.typed = typed
        self.type_sink = type_sink
        self.use_kernel = use_kernel
        self.device = device
        self.wide_ints_text = wide_ints_text

    def encode(self, values: list[str]) -> dict[str, bytes]:
        """Byte-identical to the per-value reference loop, but the
        escape / sub-field split work runs once per *distinct* value in
        a few numpy passes (``split_subfields_batch``), with parts
        hash-interned so ParaID lookups hit an int-keyed cache. All
        interning stays in first-occurrence order, so pattern ids and
        ParaID assignment order are unchanged."""
        n = len(values)
        inv, uvals = factorize(values)
        if self.typed:
            from .coltypes import encode_typed

            typed = encode_typed(self.name, values, uvals,
                                 use_kernel=self.use_kernel, device=self.device,
                                 wide_ints_text=self.wide_ints_text)
            if typed is not None:
                objs, summary = typed
                if self.type_sink is not None:
                    self.type_sink[self.name] = summary
                return objs
            if self.type_sink is not None:
                self.type_sink[self.name] = {"t": "text", "n": n}
        # escape first so the \x00 slot marker can never collide with
        # value bytes; decode merges then un-escapes.
        pats, part_ids, part_table, prow = split_subfields_batch([esc(v) for v in uvals])
        patterns: dict[str, int] = {}
        pat_list: list[str] = []
        upid = np.empty(len(uvals), np.int64)
        for j, pattern in enumerate(pats):
            pid = patterns.get(pattern)
            if pid is None:
                pid = len(pat_list)
                patterns[pattern] = pid
                pat_list.append(pattern)
            upid[j] = pid
        pat_ids = upid[inv] if n else np.zeros(0, np.int64)
        objs: dict[str, bytes] = {
            f"{self.name}.pat": join_column(pat_list),
            f"{self.name}.pid": encode_varints(pat_ids),
        }
        # one stable argsort groups value occurrences by pattern while
        # preserving value order within each group (single pass, no
        # per-pattern rescan of the whole column)
        order = np.argsort(pat_ids, kind="stable")
        counts = np.bincount(pat_ids, minlength=len(pat_list)).astype(np.int64)
        pd_cache: dict[int, int] = {}  # part id -> ParaID (same first-use order)
        group_start = 0
        for pid in range(len(pat_list)):
            c = int(counts[pid])
            us = inv[order[group_start:group_start + c]]  # uniques, value order
            group_start += c
            u0 = int(us[0])
            n_slots = int(prow[u0 + 1] - prow[u0])
            if n_slots == 0:
                continue
            # group the unique-value ids within this pattern group so
            # per-slot work (ParaID interning / joining) is per distinct
            # value; first-occurrence order keeps ParaIDs identical.
            g_inv, gfirst = first_occurrence_unique(us)
            g_uniq = us[gfirst]
            for k in range(n_slots):
                key = f"{self.name}.p{pid}s{k}"
                pids_k = part_ids[prow[g_uniq] + k]
                if self.paradict is not None:
                    uids = np.empty(len(g_uniq), np.int64)
                    pd_id = self.paradict.id
                    for idx, p in enumerate(pids_k.tolist()):
                        v = pd_cache.get(p)
                        if v is None:
                            v = pd_id(part_table[p])
                            pd_cache[p] = v
                        uids[idx] = v
                    objs[key] = encode_varints(uids[g_inv])
                else:
                    # parts are alphanumeric runs -> esc is the identity
                    col_u = [part_table[p] for p in pids_k.tolist()]
                    objs[key] = join_column([col_u[g] for g in g_inv], already_safe=True)
        return objs

    def decode(self, objs: dict[str, bytes], n: int, paravalues: list[str] | None = None) -> list[str]:
        if f"{self.name}.ct" in objs:  # typed column (v2, DESIGN.md §12)
            from .coltypes import decode_typed

            return decode_typed(self.name, objs, n)
        uniq, inv = self.decode_distinct(objs, n, paravalues)
        return [uniq[j] for j in inv]

    def decode_distinct(
        self, objs: dict[str, bytes], n: int, paravalues: list[str] | None = None,
    ) -> tuple[list[str], np.ndarray]:
        """Column-selective decode without full row materialization:
        -> (distinct values in first-occurrence order, inverse indices).

        The expensive per-row work (sub-field merge + unescape, and for
        Level 3 the ParaID -> string lookups) runs once per *distinct*
        (pattern, parts) row — log parameter columns are dominated by
        repeats, and the compressed-domain query engine evaluates
        predicates on the distinct values only, broadcasting the verdict
        through ``inverse``."""
        if f"{self.name}.ct" in objs:  # typed column (v2, DESIGN.md §12)
            from .coltypes import decode_typed

            inv, uniq = factorize(decode_typed(self.name, objs, n))
            return uniq, inv
        pat_list = split_column(objs[f"{self.name}.pat"])
        pat_ids = decode_varints(objs[f"{self.name}.pid"])
        assert len(pat_ids) == n, (self.name, len(pat_ids), n)
        cursors: dict[int, int] = {}
        slot_cols: dict[int, list[list]] = {}  # pid -> per-slot raw columns
        seen: dict[tuple, int] = {}
        uniq: list[str] = []
        inv = np.empty(n, np.int64)
        for r, pid in enumerate(pat_ids):
            cols = slot_cols.get(pid)
            if cols is None:
                n_slots = pat_list[pid].count("\x00")
                cols = []
                for k in range(n_slots):
                    raw = objs[f"{self.name}.p{pid}s{k}"]
                    # keep Level-3 columns as raw ParaIDs: the dedup key
                    # hashes ints and values are only looked up once per
                    # distinct row below
                    cols.append(decode_varints(raw) if paravalues is not None
                                else split_column(raw))
                slot_cols[pid] = cols
            c = cursors.get(pid, 0)
            cursors[pid] = c + 1
            key = (pid, *(col[c] for col in cols))
            j = seen.get(key)
            if j is None:
                parts = ([paravalues[i] for i in key[1:]] if paravalues is not None
                         else list(key[1:]))
                j = len(uniq)
                seen[key] = j
                uniq.append(unesc(merge_subfields(pat_list[pid], parts)))
            inv[r] = j
        return uniq, inv


# ------------------------------------------------------------- container

MAGIC = b"LZJ1"


def pack_container(objects: dict[str, bytes]) -> bytes:
    out = bytearray(MAGIC)
    write_varint(out, len(objects))
    for name, data in objects.items():
        nb = name.encode("utf-8")
        write_varint(out, len(nb))
        out += nb
        write_varint(out, len(data))
        out += data
    return bytes(out)


def unpack_container(data: bytes) -> dict[str, bytes]:
    assert data[:4] == MAGIC, "bad container magic"
    pos = 4

    def rd_varint() -> int:
        nonlocal pos
        cur = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            cur |= (b & 0x7F) << shift
            if not (b & 0x80):
                return cur
            shift += 7

    n = rd_varint()
    objects: dict[str, bytes] = {}
    for _ in range(n):
        ln = rd_varint()
        name = data[pos : pos + ln].decode("utf-8")
        pos += ln
        dl = rd_varint()
        objects[name] = data[pos : pos + dl]
        pos += dl
    return objects
