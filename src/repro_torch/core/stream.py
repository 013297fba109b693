"""Streaming compression sessions + the LZJS indexed appendable container
(DESIGN.md §9).

Container layout::

    b"LZJS" | u8 version
    varint(header_len) | zlib(json session header: level/kernel/format +
                              seed templates/params)          [crc4 in v3]
    repeat:  b"CHNK" | varint(blob_len) | LZJF chunk blob     [crc4 in v3]
             varint(td_len) | zlib(template-delta column)     [crc4 in v3]
             varint(pd_len) | zlib(ParamDict-delta column)    [crc4 in v3]
             v3 only: b"CMT1" | varints(offset, blob_len, td_len, pd_len,
                      line_start, n_lines, tpl_base, n_delta, pd_base,
                      pd_delta) | crc4   (sealed commit record)
    zlib(json footer: per-chunk index)                        [crc4 in v3]
    u64le(footer_len) | b"LZJSIDX1"

v3 (DESIGN.md §13) adds CRC32C trailers after every frame and seals each
chunk with a self-locating commit record: the commit alone recovers the
record's geometry and line range, so a torn-off footer is rebuilt by
scanning for valid commits (``core.recover``) — committed chunks
survive any single torn write, truncation or bit flip.

Chunk blobs are ordinary ``codec`` archives whose meta carries
``stream = {base, n_delta, used, pd_base, pd_delta}``: EventIDs are the
session store's global ids and ParaIDs index the session-shared
``ParamDict`` — the paper's §III-E observation (templates evolve
slowly) plus LogShrink's cross-record commonality applied inside one
stream. Each chunk's template/param *deltas* ride in the record frame,
outside the kernel-compressed blob, so a reader reconstructs the full
dictionaries by reading only the (small) delta sections — never decoding
chunk payloads it does not need. The footer index enables O(1) append
(truncate the footer, add chunk records, rewrite it — chunk data is
never rewritten) and random-access decompression by line range (only
covering chunks are decoded). ``iter_stream`` decodes forward with no
seeking (pipes), accumulating deltas as it goes. Session memory is
bounded by one chunk buffer plus the dictionaries (which grow with
DISTINCT templates/params, not corpus length).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import zlib

import numpy as np

from . import integrity
from .codec import _decompress_objects, open_container, read_structured
from .encode import ParamDict, join_column, split_column, write_varint
from .integrity import CRC_LEN, IntegrityError
from .screens import OPT_MAGIC, SCREEN_KIND, ScreenBuilder, parse_screen_payload
from .stages import (
    LogzipConfig,
    StreamSession,
    pack_stage,
    run_stages,
    serialize_template,
)
from .templates import TemplateStore
from .timing import StageTimer

STREAM_MAGIC = b"LZJS"
CHUNK_MAGIC = b"CHNK"
COMMIT_MAGIC = b"CMT1"
FOOTER_MAGIC = b"LZJSIDX1"
V3 = 3               # v3: CRC32C frame trailers + sealed commit records
#                      (DESIGN.md §13); column layout carried separately in
#                      the header/footer "typed" key
VERSION = 2          # v2: typed-column chunks + tcol manifests (DESIGN.md §12)
V1 = 1               # still written for typed_columns=False sessions, and
#                      every v1 container remains readable
READ_VERSIONS = (V1, VERSION, V3)
N_COMMIT_FIELDS = 10  # varints in a CMT1 record (see module docstring)

# query-manifest caps (DESIGN.md §11): per-chunk summaries ride in the
# footer index only while they stay small; above the caps the field is
# recorded as unknown and the query planner conservatively decodes.
MANIFEST_FIELD_VALS = 16     # distinct header values stored verbatim
MANIFEST_FIELD_CHARS = 64    # else: distinct chars, if no more than this
# Verbatim texts are largest in a session's FIRST chunk (cold template
# store: ISE leftovers below stream_min_support go verbatim); the cap
# must cover that or the first chunk is never skippable.
MANIFEST_VERBATIM_BYTES = 8192  # total bytes of verbatim-line texts
# typed-column summaries (DESIGN.md §12): above these caps the chunk's
# "tcol" is recorded as unknown (null) and the query planner loses the
# typed-column screens for that chunk (still sound, just conservative)
MANIFEST_TCOL_MAX = 64          # summarized typed columns per chunk
MANIFEST_TCOL_VALS = 16         # mini-dict values stored verbatim


def chunk_manifest(ch, counts: bool = False) -> dict:
    """Per-chunk query-pushdown summary written into the footer index.

    ``used``: the chunk's session-global EventIDs (None when the chunk
    has no template structure, i.e. level 1). ``nv``: count of verbatim
    lines (header-parse failures + unmatched contents); ``verbatim``:
    their full texts when small, else None (= unknown).  ``fields``: per
    header field either the distinct values (``v``) or the distinct
    character set (``c``), whichever fits the caps — enough for the
    query planner to prove "this chunk cannot contain a hit" without
    touching the chunk payload (DESIGN.md §11).

    ``tcol`` (DESIGN.md §12): per typed column a compact summary —
    ``t`` (type name), shared ``pre``/``suf``, integer-family ``lo``/
    ``hi`` bounds (range-predicate chunk skipping), mini-dict values
    (``v``) or their charset (``c``), hex case. Star columns are keyed
    by session-global EventID (``g<gid>.s<star>``), header columns stay
    ``h.<field>``. Typed values bypass the level-3 ParamDict, so the
    CLP-style dictionary screen consults these summaries before ruling a
    chunk out; ``tcol: null`` means "typed columns present but not
    summarized" and disables the screen for the chunk. Chunks written
    with ``typed_columns=False`` carry ``tcol: {}``."""
    def utf8_ok(s: str) -> bool:
        # the footer is utf-8 JSON; anything unencodable (surrogateescape
        # bytes from raw inputs) is recorded as unknown instead
        try:
            s.encode("utf-8")
            return True
        except UnicodeEncodeError:
            return False

    level1 = ch.assign is None
    n_un = 0 if level1 else int((ch.assign < 0).sum())
    nv = len(ch.bad_idx) + n_un
    verbatim: list[str] | None = []
    for i in ch.bad_idx:
        verbatim.append(ch.lines[i])
    if not level1:
        for i in np.flatnonzero(ch.assign < 0):
            verbatim.append(ch.contents[int(i)])
    if not all(utf8_ok(v) for v in verbatim) or \
            sum(len(v.encode("utf-8", "surrogateescape")) for v in verbatim) \
            > MANIFEST_VERBATIM_BYTES:
        verbatim = None
    fields: dict[str, dict] = {}
    for f, col in ch.columns.items():
        if ch.fmt is not None and f == ch.fmt.content_field:
            continue
        distinct = set(col)
        entry: dict = {"n": len(distinct)}
        if len(distinct) <= MANIFEST_FIELD_VALS and all(utf8_ok(v) for v in distinct):
            entry["v"] = sorted(distinct)
        else:
            chars = set().union(*distinct) if distinct else set()
            if len(chars) <= MANIFEST_FIELD_CHARS and all(utf8_ok(c) for c in chars):
                entry["c"] = "".join(sorted(chars))
        fields[f] = entry
    used_ids = None if level1 else ch.meta.get("stream", {}).get("used")
    typed = [(name, info) for name, info in (ch.coltypes or {}).items()
             if info.get("t") != "text"]
    tcol: dict | None = {}
    if len(typed) > MANIFEST_TCOL_MAX:
        tcol = None
    else:
        for name, info in typed:
            key = name
            if name.startswith("t") and ".v" in name and used_ids is not None:
                k, _, s = name[1:].partition(".v")
                key = f"g{used_ids[int(k)]}.s{s}"
            entry: dict = {"t": info["t"]}
            for akey in ("pre", "suf"):
                a = info.get(akey)
                if a:
                    if not utf8_ok(a):
                        entry = {"t": info["t"], "u": 1}  # affix unserializable:
                        break                             # realizable set unknown
                    entry[akey] = a
            if "u" not in entry:
                if "lo" in info:
                    entry["lo"], entry["hi"] = int(info["lo"]), int(info["hi"])
                    if info.get("w"):
                        entry["w"] = int(info["w"])
                if info["t"] == "dict":
                    vals = info.get("vals") or []
                    if len(vals) <= MANIFEST_TCOL_VALS and all(utf8_ok(v) for v in vals):
                        entry["v"] = sorted(vals)
                    else:
                        chars = set().union(*vals) if vals else set()
                        if len(chars) <= MANIFEST_FIELD_CHARS and \
                                all(utf8_ok(c) for c in chars):
                            entry["c"] = "".join(sorted(chars))
                if info.get("hex"):
                    entry["hex"] = True
                    if info.get("upper"):
                        entry["upper"] = True
            tcol[key] = entry
    out = {
        "used": used_ids,
        "nv": nv,
        "verbatim": verbatim,
        "fields": fields,
    }
    if counts and used_ids:
        # per-used-EventID row histogram, aligned with ``used`` — the
        # query engine's count fast path sums these without decoding a
        # single column. ``assign`` holds session-GLOBAL store ids.
        arr = ch.assign[ch.assign >= 0]
        out["ec"] = [int((arr == g).sum()) for g in used_ids]
    if ch.meta.get("v", 1) >= 2:
        out["tcol"] = tcol  # absent entirely in v1 containers (byte-stable)
    return out


def _read_varint(f) -> int:
    cur = shift = 0
    while True:
        b = f.read(1)
        if not b:
            raise ValueError("truncated LZJS stream while reading varint")
        cur |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return cur
        shift += 7


def _read_varint2(f) -> tuple[int, bytes]:
    """Like ``_read_varint`` but also returns the raw bytes consumed —
    needed wherever the surrounding frame is CRC-checked or offsets are
    reported in errors."""
    raw = bytearray()
    cur = shift = 0
    while True:
        b = f.read(1)
        if not b:
            raise ValueError("truncated LZJS stream while reading varint")
        raw += b
        cur |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return cur, bytes(raw)
        shift += 7


def _take_varint(buf, pos: int) -> tuple[int, int]:
    """Decode one varint from ``buf`` at ``pos`` -> (value, new_pos)."""
    cur = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated LZJS record while reading varint")
        b = buf[pos]
        pos += 1
        cur |= (b & 0x7F) << shift
        if not b & 0x80:
            return cur, pos
        shift += 7


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    write_varint(out, v)
    return bytes(out)


def frame_positions(blob_len: int, td_len: int, pd_len: int):
    """Record-relative (start, len) of the three content frames of a v3
    chunk record, computed purely from the frame lengths (as recorded in
    the sealed commit) — lets salvage code slice a record without
    trusting its possibly-damaged envelope varints. Returns
    ``((blob), (td), (pd), commit_offset)``."""
    p = 4 + len(_varint_bytes(blob_len))
    blob = (p, blob_len)
    p += blob_len + CRC_LEN + len(_varint_bytes(td_len))
    td = (p, td_len)
    p += td_len + CRC_LEN + len(_varint_bytes(pd_len))
    pd = (p, pd_len)
    p += pd_len + CRC_LEN
    return blob, td, pd, p


def build_commit(offset: int, blob_len: int, td_len: int, pd_len: int,
                 line_start: int, n_lines: int, tpl_base: int, n_delta: int,
                 pd_base: int, pd_delta: int) -> bytes:
    """The sealed per-chunk commit record (v3): self-locating — carries
    the record's absolute offset and frame geometry, so a scan that finds
    a valid commit can frame and verify the whole chunk without any
    footer."""
    cm = bytearray(COMMIT_MAGIC)
    for v in (offset, blob_len, td_len, pd_len, line_start, n_lines,
              tpl_base, n_delta, pd_base, pd_delta):
        write_varint(cm, v)
    cm += integrity.trailer(bytes(cm))
    return bytes(cm)


def parse_commit(buf, pos: int) -> tuple[dict, int] | None:
    """Parse + CRC-verify a CMT1 record at ``pos``; None if it is not a
    valid commit (wrong magic, truncated, or checksum mismatch)."""
    start = pos
    if buf[pos:pos + 4] != COMMIT_MAGIC:
        return None
    pos += 4
    vals = []
    try:
        for _ in range(N_COMMIT_FIELDS):
            v, pos = _take_varint(buf, pos)
            vals.append(v)
    except ValueError:
        return None
    stored = bytes(buf[pos:pos + CRC_LEN])
    if len(stored) != CRC_LEN or \
            integrity.crc32c(buf[start:pos]) != int.from_bytes(stored, "little"):
        return None
    keys = ("offset", "blob_len", "td_len", "pd_len", "line_start", "n_lines",
            "tpl_base", "n_delta", "pd_base", "pd_delta")
    return dict(zip(keys, vals)), pos + CRC_LEN


def parse_chunk_record(rec, k: int, offset: int, v3: bool,
                       geometry=None) -> dict:
    """Parse one CHNK record (``rec`` = the record bytes) into its frames.

    Structural damage (bad magic, truncated frames) raises; in v3, frame
    checksums are *reported*, not raised — ``bad`` maps frame name ->
    IntegrityError for every frame that failed its CRC, so callers choose
    between strict reads (raise ``bad``'s first error) and salvage/fsck
    (quarantine and continue).

    ``geometry`` = (blob_len, td_len, pd_len) from a verified commit
    record: frames are then sliced at computed positions instead of by
    the record's own (possibly damaged) magic/varint envelope.
    """
    if geometry is not None:
        out = {"bad": {}}
        spans = frame_positions(*geometry)
        for (frame, key), (fpos, ln) in zip(
                (("chunk_payload", "blob"), ("template_delta", "td"),
                 ("paramdict_delta", "pd")), spans[:3]):
            data = bytes(rec[fpos:fpos + ln])
            if len(data) != ln:
                raise ValueError(
                    f"corrupt LZJS chunk record {k} at byte {offset}: "
                    f"{frame} frame claims {ln} bytes, {len(data)} present")
            out[key] = data
            try:
                integrity.verify(data, bytes(rec[fpos + ln:fpos + ln + CRC_LEN]),
                                 frame=frame, offset=offset + fpos, chunk=k)
            except IntegrityError as e:
                out["bad"][frame] = e
        out["commit_at"] = spans[3]
        got = parse_commit(rec, spans[3])
        if got is None:
            out["commit"] = None
            out["bad"]["commit"] = IntegrityError(
                "invalid commit record", frame="commit",
                offset=offset + spans[3], chunk=k)
            out["end"] = spans[3]
        else:
            out["commit"], out["end"] = got
        return out
    if rec[:4] != CHUNK_MAGIC:
        raise ValueError(
            f"corrupt LZJS chunk record {k} at byte {offset}: magic "
            f"{bytes(rec[:4])!r}, expected {CHUNK_MAGIC!r}")
    out: dict = {"bad": {}}
    pos = 4
    for frame, key in (("chunk_payload", "blob"), ("template_delta", "td"),
                       ("paramdict_delta", "pd")):
        ln, pos = _take_varint(rec, pos)
        data = bytes(rec[pos:pos + ln])
        if len(data) != ln:
            raise ValueError(
                f"corrupt LZJS chunk record {k} at byte {offset}: "
                f"{frame} frame claims {ln} bytes, {len(data)} present")
        out[key] = data
        fpos = pos
        pos += ln
        if v3:
            try:
                integrity.verify(data, bytes(rec[pos:pos + CRC_LEN]),
                                 frame=frame, offset=offset + fpos, chunk=k)
            except IntegrityError as e:
                out["bad"][frame] = e
            pos += CRC_LEN
    if v3:
        # a damaged commit does NOT fail the record: the footer (when it
        # verifies) vouches for the chunk independently, and repair can
        # rebuild the commit from it — report, don't raise
        out["commit_at"] = pos
        got = parse_commit(rec, pos)
        if got is None:
            out["commit"] = None
            out["bad"]["commit"] = IntegrityError(
                "missing or invalid commit record (chunk never sealed)",
                frame="commit", offset=offset + pos, chunk=k)
        else:
            out["commit"], pos = got
    out["end"] = pos
    return out


def _frame(values: list[str]) -> bytes:
    return zlib.compress(join_column(values), 6)


def _unframe(data: bytes) -> list[str]:
    try:
        return split_column(zlib.decompress(data))
    except Exception as e:
        raise ValueError(f"corrupt LZJS delta frame: {e}") from e


# ------------------------------------------------------------------ writer

class StreamingCompressor:
    """Incremental compression session over an unbounded line stream.

    Callers ``feed`` lines; chunks are cut when the buffered line count
    or byte budget is hit and run through the staged pipeline with this
    session's shared, growing ``TemplateStore`` + ``ParamDict`` (match
    known templates first, ISE only on the unmatched remainder, emit the
    deltas). ``close`` writes the footer index.

    ``out`` is a path or a binary file-like (only ``write`` is needed).
    ``append=True`` reopens an existing container (path only): the
    session state is re-seeded from the container and new chunks extend
    the same session — EventIDs and ParaIDs stay stable across appends.
    The old footer region is left intact until the first new chunk
    record is actually written (DESIGN.md §13: a crash between open and
    first flush leaves the container byte-identical), and every new v3
    chunk carries a sealed commit record so a crash after that is
    recoverable by ``logzip repair``. With ``cfg=None`` an append
    inherits the container's level/kernel/format (appending with a
    different format would silently fragment the store).

    New path-owned sessions write to ``<path>.tmp`` and publish with
    fsync + atomic rename on ``close()`` — a crashed session never
    leaves a half-written file under the target name.

    ``pipeline=True`` (default) double-buffers chunks (DESIGN.md §10.4):
    the entropy kernel + container write of chunk k run on a single
    ordered worker thread while the main thread parses/tokenizes/matches
    chunk k+1. The worker is the only writer of ``_f``/``index``/
    ``_pos``, records stay in submission order, and ``close`` drains the
    queue before the footer — the container bytes are identical to the
    serial path.
    """

    def __init__(self, out, cfg: LogzipConfig | None = None, *,
                 chunk_lines: int = 8192, chunk_bytes: int = 8 << 20,
                 store: TemplateStore | None = None, append: bool = False,
                 stage_times: dict | None = None, pipeline: bool = True,
                 sync_on_commit: bool = False, on_commit=None,
                 on_chunk=None, opener=open):
        self.chunk_lines = int(chunk_lines)
        self.chunk_bytes = int(chunk_bytes)
        self.stage_times = stage_times
        self.pipeline = bool(pipeline)
        # observability hook (soak harness): ``on_chunk(index_entry)``
        # fires after each chunk record lands, on the writing thread
        # (the pack worker under pipeline=True) — keep it cheap and
        # thread-safe, and treat the entry as read-only.
        self.on_chunk = on_chunk
        # durability hooks (DESIGN.md §15): sync_on_commit fsyncs each
        # chunk record as it lands, advancing ``committed_lines`` — the
        # fsync-durable line watermark the ingestion daemon's WAL GC and
        # crash recovery key on. ``on_commit(committed_lines)`` fires
        # after every such fsync, on whichever thread performed the write
        # (the pack worker under pipeline=True) — keep it cheap and
        # thread-safe.
        self.sync_on_commit = bool(sync_on_commit)
        self.on_commit = on_commit
        self._opener = opener
        self._pool = None           # lazy single-worker executor
        self._pending: list = []    # in-flight pack/write futures
        self._buf: list[str] = []
        self._buf_bytes = 0
        self._closed = False
        self._summary: dict | None = None
        self._append = bool(append)
        self._preseed: list[str] = []       # append-store extras for chunk 0
        self._trunc_to: int | None = None   # deferred old-footer overwrite
        self._footer_started = False        # a partial close left footer bytes
        self._tmp_path: str | None = None   # fsync-then-rename target

        screens_meta = None
        if append:
            if not isinstance(out, (str, os.PathLike)):
                raise ValueError("append=True needs a path")
            rd = LZJSReader(out)
            screens_meta = rd.footer.get("screens")
            if cfg is None:
                # continue with the container's own settings — appending
                # with a different format would silently fragment the store
                cfg = LogzipConfig(level=rd.footer["level"], kernel=rd.footer["kernel"],
                                   format=rd.footer["format"])
            # the container version is a property of the file, not the
            # session: appended chunks keep the original column layout
            # and frame integrity. Copy — mutating the caller's cfg would
            # silently change any LATER compressions it is reused for.
            v = rd.footer.get("v", V1)
            cfg = dataclasses.replace(
                cfg,
                typed_columns=rd.footer.get("typed", v >= 2) if v >= V3 else v >= 2,
                integrity=v >= V3)
            seed_store = store if store is not None else TemplateStore(rd.templates)
            n_known = len(rd.templates)
            if seed_store.templates[:n_known] != rd.templates:
                # ids would diverge mid-chain — the container would be
                # permanently unreadable
                raise ValueError(
                    "append store must extend the container's template list "
                    "id-stably (its prefix must equal the container's "
                    "templates; global ids and delta chain must stay "
                    "consistent)")
            # a SUPERSET store is id-stable (the compaction pipeline and
            # compress_parallel(shared_store=True) seed sessions from a
            # shared store that other sessions may have grown further):
            # the extra templates are serialized into the FIRST new
            # chunk's template delta, keeping every reader's accumulated
            # count aligned with the recorded bases
            self._preseed = [serialize_template(list(t))
                             for t in seed_store.templates[n_known:]]
            if self._preseed and cfg.level < 2:
                raise ValueError(
                    "append store extends the container's template list, "
                    "but a level-1 container has no template delta chain "
                    "to carry the extras")
            self.session = StreamSession(seed_store, ParamDict(rd.params))
            self.index = [dict(e) for e in rd.index]
            self.total_lines = rd.n_lines
            # do NOT truncate here: the live footer stays valid until the
            # first new chunk record is durably written over it
            self._trunc_to = rd.footer_offset
            rd.close()
            self._own = True
            self._f = self._opener(out, "r+b")
            self._pos = self._trunc_to
            self.committed_lines = self.total_lines
        else:
            cfg = cfg or LogzipConfig()
            self.session = StreamSession(store)
            self.index: list[dict] = []
            self.total_lines = 0
            self.committed_lines = 0
            self._own = isinstance(out, (str, os.PathLike))
            if self._own:
                self._final_path = os.fspath(out)
                self._tmp_path = self._final_path + ".tmp"
                self._f = self._opener(self._tmp_path, "wb")
            else:
                self._f = out

        if cfg.template_store is not None:
            raise ValueError("pass the session store via store=, not cfg.template_store")
        self.cfg = cfg
        # per-chunk query screens (DESIGN.md §14) — v3 only (older
        # sequential readers would misparse the optional frames). An
        # append session restores the builder's cross-chunk reference
        # counters from the footer ``screens`` meta (persisted saturated,
        # see ``ScreenBuilder.restore``) and keeps emitting sound frames;
        # archives written before the counters were persisted drop their
        # (optional) screens meta on append, as they always did.
        if append:
            self._screens = ScreenBuilder.restore(screens_meta) \
                if (cfg.integrity and cfg.screens) else None
        else:
            self._screens = ScreenBuilder(cfg.screen_fpp) \
                if (cfg.integrity and cfg.screens) else None
        if not append:
            self._write_header()

    @property
    def store(self) -> TemplateStore:
        return self.session.store

    @property
    def bytes_written(self) -> int:
        """Container bytes written so far (header + landed chunk records;
        excludes buffered lines and any in-flight pack job)."""
        return self._pos

    def stats(self) -> dict:
        """Cheap observability snapshot for the soak harness / daemon
        stats endpoints — no locks taken, values may lag one in-flight
        chunk under ``pipeline=True``."""
        return {
            "total_lines": self.total_lines,
            "committed_lines": self.committed_lines,
            "n_chunks": len(self.index),
            "bytes_written": self._pos,
            "buffered_lines": len(self._buf),
            "n_templates": len(self.session.store.templates),
            "n_params": len(self.session.paradict.values),
        }

    @property
    def _version(self) -> int:
        if self.cfg.integrity:
            return V3
        return VERSION if self.cfg.typed_columns else V1

    def _fsync(self) -> None:
        """flush + fsync when the sink supports it (no-op for BytesIO)."""
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except (AttributeError, OSError, io.UnsupportedOperation):
            pass

    def _write_header(self) -> None:
        meta = {
            "v": self._version, "level": self.cfg.level, "kernel": self.cfg.kernel,
            "format": self.cfg.format,
            "seed_templates": [list(t) for t in self.session.store.templates],
            "seed_params": list(self.session.paradict.values),
        }
        if self._version >= V3:
            meta["typed"] = self.cfg.typed_columns
        head = zlib.compress(json.dumps(meta).encode("utf-8"))
        out = bytearray(STREAM_MAGIC)
        out.append(self._version)
        write_varint(out, len(head))
        out += head
        if self._version >= V3:
            out += integrity.trailer(bytes(out))
        self._f.write(bytes(out))
        self._pos = len(out)

    # -- feeding -------------------------------------------------------
    def feed_line(self, line: str) -> None:
        self._buf.append(line)
        self._buf_bytes += len(line) + 1
        if len(self._buf) >= self.chunk_lines or self._buf_bytes >= self.chunk_bytes:
            self.flush_chunk()

    def feed(self, lines) -> None:
        for line in lines:
            self.feed_line(line)

    def flush_chunk(self) -> None:
        """Cut the current buffer into one chunk record.

        Compute (parse..encode, which advances the session store) runs
        here; the entropy kernel + write are handed to the ordered
        worker when ``pipeline`` is on, overlapping with the next
        chunk's compute."""
        if not self._buf:
            return
        ch = run_stages(self._buf, self.cfg, stage_times=self.stage_times,
                        session=self.session)
        n_chunk_lines = len(self._buf)
        line_start = self.total_lines
        self.total_lines += n_chunk_lines
        self._buf = []
        self._buf_bytes = 0
        if self.pipeline:
            if self._pool is None:
                import concurrent.futures as cf

                self._pool = cf.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="lzjs-pack")
            # bound the in-flight window to one packed + one packing
            # chunk (double buffering, not an unbounded queue)
            while len(self._pending) > 1:
                self._pending.pop(0).result()
            self._pending.append(self._pool.submit(
                self._pack_and_write, ch, line_start, n_chunk_lines))
        else:
            self._pack_and_write(ch, line_start, n_chunk_lines)

    def _pack_and_write(self, ch, line_start: int, n_chunk_lines: int) -> None:
        if self._preseed and ch.session:
            # first chunk after an append with a superset store: the
            # extra seed templates ride in THIS chunk's delta frame, so
            # readers' accumulated template count matches the recorded
            # bases (delta-chain invariant) without rewriting the header
            extras = self._preseed
            self._preseed = []
            ch.delta_templates = extras + (ch.delta_templates or [])
            ch.tpl_base -= len(extras)
            ch.n_delta += len(extras)
            st = ch.meta.get("stream")
            if st is not None:
                st["base"] = ch.tpl_base
                st["n_delta"] = ch.n_delta
        pack_stage(ch, self.cfg, StageTimer(self.stage_times))
        td = _frame(ch.delta_templates or [])
        pd = _frame(ch.delta_params or [])
        v3 = self.cfg.integrity
        pd_delta = len(ch.delta_params or [])
        rec = bytearray(CHUNK_MAGIC)
        write_varint(rec, len(ch.blob))
        rec += ch.blob
        if v3:
            rec += integrity.trailer(ch.blob)
        doffset = self._pos + len(rec)
        write_varint(rec, len(td))
        rec += td
        if v3:
            rec += integrity.trailer(td)
        write_varint(rec, len(pd))
        rec += pd
        if v3:
            rec += integrity.trailer(pd)
            rec += build_commit(self._pos, len(ch.blob), len(td), len(pd),
                                line_start, n_chunk_lines, ch.tpl_base,
                                ch.n_delta, ch.pd_base, pd_delta)
        mf = chunk_manifest(ch, counts=self._screens is not None)
        sc_entry = None
        if self._screens is not None:
            # screens ride AFTER the commit, inside the indexed record
            # range: footer-driven readers that predate them skip the
            # bytes for free, and the commit they follow stays the
            # record's durability seal. Only ids below this chunk's
            # pd_end are considered — the session ParamDict is growing
            # concurrently on the main thread (chunk k+1's encode), and
            # later ids cannot be realized by THIS chunk's values.
            texts = list(ch.contents)
            for i in ch.bad_idx:
                texts.append(ch.lines[i])
            to_id = self.session.paradict._to_id.get \
                if self.cfg.level >= 3 else (lambda s: None)
            old_refs, all_refs = self._screens.chunk_refs(
                texts, to_id, ch.pd_base, ch.pd_base + pd_delta)
            fcols = {f: col for f, col in ch.columns.items()
                     if ch.fmt is not None and f != ch.fmt.content_field}
            has_vals = {f: "v" in e for f, e in mf["fields"].items()}
            frame = self._screens.chunk_screen(old_refs, all_refs, fcols, has_vals)
            if frame is not None:
                sc_entry = [self._pos + len(rec), len(frame)]
                rec += frame
        invalidating = self._trunc_to is not None
        if invalidating:
            # append mode, first new chunk: only now is the old footer
            # region overwritten — and the record that does it carries a
            # commit, so the container is recoverable from here on
            self._f.seek(self._trunc_to)
            self._trunc_to = None
        self._f.write(bytes(rec))
        if invalidating or self.sync_on_commit:
            # the sealing commit must be durable, not cached; under
            # sync_on_commit every chunk record is, advancing the
            # committed-line watermark the daemon's WAL GC keys on
            self._fsync()
            self.committed_lines = line_start + n_chunk_lines
            if self.on_commit is not None:
                self.on_commit(self.committed_lines)
        entry = {
            "offset": self._pos, "length": len(rec), "doffset": doffset,
            "line_start": line_start, "n_lines": n_chunk_lines,
            "tpl_base": ch.tpl_base, "n_delta": ch.n_delta,
            "pd_base": ch.pd_base,
            "pd_delta": pd_delta,
            "match_rate": round(ch.match_rate, 4),
            "manifest": mf,
        }
        if sc_entry is not None:
            entry["sc"] = sc_entry
        self.index.append(entry)
        self._pos += len(rec)
        if self.on_chunk is not None:
            self.on_chunk(entry)

    def _drain(self) -> None:
        """Wait for in-flight pack/write jobs (re-raising any error)."""
        while self._pending:
            self._pending.pop(0).result()

    def sync(self) -> int:
        """Cut + write + fsync everything fed so far; returns the
        committed-line watermark (== lines fed). The container is NOT
        sealed — the footer is missing until ``close()`` — but every
        chunk carries its commit, so ``repair`` recovers all of them.
        No-op (beyond an fsync) when nothing new was fed."""
        self.flush_chunk()
        self._drain()
        if self.total_lines > self.committed_lines:
            self._fsync()
            self.committed_lines = self.total_lines
            if self.on_commit is not None:
                self.on_commit(self.committed_lines)
        return self.committed_lines

    # -- closing -------------------------------------------------------
    def close(self) -> dict:
        """Seal the container. Idempotent — a second call returns the
        summary; after a *failed* first close (ENOSPC, kill) a retry
        seeks back to the end of the chunk records and rewrites the
        footer, so a recovered process can still seal cleanly."""
        if self._closed:
            return self._summary
        self.flush_chunk()
        self._drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._append and self._trunc_to is not None:
            # append session that wrote nothing: the container on disk is
            # byte-identical to what we opened — leave it untouched
            self._f.close()
            self._closed = True
        else:
            footer = {
                "v": self._version, "n_lines": self.total_lines,
                "level": self.cfg.level, "kernel": self.cfg.kernel,
                "format": self.cfg.format,
                "chunks": self.index,
            }
            if self._version >= V3:
                footer["typed"] = self.cfg.typed_columns
            if self._screens is not None:
                footer["screens"] = self._screens.meta()
            fb = zlib.compress(json.dumps(footer).encode("utf-8"))
            # chunk records (and their commits) reach disk before the
            # footer that points into them
            self._fsync()
            if self._footer_started:
                # a previous close attempt died mid-footer: rewind past
                # its partial bytes (seekable sinks only — on a pipe this
                # raises and the stream stays unsealed, as it must)
                self._f.seek(self._pos)
            self._footer_started = True
            self._f.write(fb)
            if self._version >= V3:
                self._f.write(integrity.trailer(fb))
            self._f.write(len(fb).to_bytes(8, "little"))
            self._f.write(FOOTER_MAGIC)
            if self._append:
                # drop any old-footer remnants past the new end
                self._f.truncate()
            self._fsync()
            if self._own:
                self._f.close()
                if self._tmp_path is not None:
                    os.replace(self._tmp_path, self._final_path)
                    self._tmp_path = None
                    try:  # make the rename itself durable
                        dfd = os.open(os.path.dirname(self._final_path) or ".",
                                      os.O_RDONLY)
                        try:
                            os.fsync(dfd)
                        finally:
                            os.close(dfd)
                    except OSError:
                        pass
            self._closed = True
        if self.total_lines > self.committed_lines:
            self.committed_lines = self.total_lines
            if self.on_commit is not None:
                self.on_commit(self.committed_lines)
        self._summary = {
            "n_lines": self.total_lines, "n_chunks": len(self.index),
            "n_templates": len(self.session.store.templates),
            "n_params": len(self.session.paradict.values),
        }
        return self._summary

    def __enter__(self) -> "StreamingCompressor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ reader

class LZJSReader:
    """Footer-indexed random access over an LZJS container.

    On open, the (small) delta frames of every chunk are read to rebuild
    the session's full template store and ParamDict — chunk *payloads*
    are only decoded on demand. ``chunks_decoded`` counts payload
    decodes; the benchmark's random-access assertion keys on it ("only
    covering chunks are decoded").

    ``src`` is a path or a seekable binary file-like.

    ``salvage=True`` (DESIGN.md §13): when the footer or header is
    damaged, fall back to scanning the byte stream for sealed commit
    records (``core.recover``) and serve every chunk that still
    verifies; chunks that fail their checks are quarantined (skipped by
    ``read_range``/``iter_lines``, reported in ``stats()`` /
    ``salvage_report``) instead of failing the whole archive. Chunks a
    repair pass already quarantined (footer entries carrying ``"q"``)
    are skipped in normal mode too.
    """

    def __init__(self, src, *, salvage: bool = False):
        self._own = isinstance(src, (str, os.PathLike))
        self._f = open(src, "rb") if self._own else src
        self._lock = threading.Lock()  # shared handle; seeks must not interleave
        self.salvage = bool(salvage)
        self.salvage_report: dict | None = None
        self.chunks_decoded = 0
        self._screen_cache: dict[int, object] = {}
        try:
            self._load_normal()
        except ValueError:
            if not salvage:
                raise
            from . import recover

            res = recover.salvage_scan(self._f)
            self.version = res["version"]
            self.header = res["header"]
            self.footer = res["footer"]
            self.index = res["index"]
            self.n_lines = res["n_lines"]
            self.footer_offset = res["data_end"]
            self.salvage_report = res["report"]
            self._load_dictionaries()

    def _load_normal(self) -> None:
        f = self._f
        f.seek(0)
        head = f.read(5)
        if len(head) < 5 or head[:4] != STREAM_MAGIC:
            raise ValueError(
                f"not an LZJS container: magic {bytes(head[:4])!r}, expected {STREAM_MAGIC!r}")
        if head[4] not in READ_VERSIONS:
            raise ValueError(f"LZJS container version {head[4]} is newer than "
                             f"this reader (supports {V1}..{V3})")
        self.version = head[4]
        v3 = self.version >= V3
        hlen, hraw = _read_varint2(f)
        hblob = f.read(hlen)
        if len(hblob) != hlen:
            raise ValueError(
                f"truncated LZJS container: header claims {hlen} bytes, "
                f"{len(hblob)} present")
        if v3:
            integrity.verify(head + hraw + hblob, f.read(CRC_LEN),
                             frame="header", offset=0)
        try:
            self.header = json.loads(zlib.decompress(hblob).decode("utf-8"))
        except Exception as e:
            raise ValueError(f"corrupt LZJS header: {e}") from e
        f.seek(0, os.SEEK_END)
        end = f.tell()
        if end < 16:
            raise ValueError("truncated LZJS container: no footer")
        f.seek(end - 16)
        tail = f.read(16)
        if tail[8:] != FOOTER_MAGIC:
            raise ValueError("truncated or corrupt LZJS container: footer magic missing "
                             "(was the session closed?)")
        flen = int.from_bytes(tail[:8], "little")
        extra = CRC_LEN if v3 else 0
        if flen + 16 + extra > end:
            raise ValueError("corrupt LZJS container: footer length out of range")
        self.footer_offset = end - 16 - extra - flen
        f.seek(self.footer_offset)
        fb = f.read(flen)
        if v3:
            integrity.verify(fb, f.read(CRC_LEN), frame="footer",
                             offset=self.footer_offset)
        try:
            self.footer = json.loads(zlib.decompress(fb).decode("utf-8"))
        except Exception as e:
            raise ValueError(
                f"corrupt LZJS footer at byte {self.footer_offset}: {e}") from e
        self.index: list[dict] = self.footer["chunks"]
        self.n_lines: int = self.footer["n_lines"]
        self._load_dictionaries()

    def _pad_dictionaries(self, n_tpl: int, n_pd: int) -> None:
        """Placeholder entries for a quarantined/lost chunk's deltas, so
        session-global EventIDs/ParaIDs of LATER chunks stay aligned.
        Chunks that actually dereference a placeholder fail decode (and
        are themselves quarantined in salvage mode)."""
        self.templates.extend([None] * n_tpl)
        self.params.extend([None] * n_pd)

    def _load_dictionaries(self) -> None:
        """Rebuild the session template store + ParamDict from the delta
        frames (no chunk payload decodes). v3 delta frames are CRC-
        verified here — damage surfaces at open, pinned to its chunk."""
        from .codec import _deserialize_template

        v3 = self.version >= V3
        self.templates: list[tuple] = [tuple(t) for t in self.header.get("seed_templates", [])]
        self.params: list[str] = list(self.header.get("seed_params", []))
        for k, e in enumerate(self.index):
            if e["tpl_base"] > len(self.templates) or e.get("pd_base", 0) > len(self.params):
                if not self.salvage:
                    raise ValueError(
                        f"LZJS delta chain broken at chunk {k}: base "
                        f"{e['tpl_base']}/{e.get('pd_base')} vs accumulated "
                        f"{len(self.templates)}/{len(self.params)}")
                # chunks were lost between k-1 and k: pad the id space up
                # to this chunk's recorded bases
                self._pad_dictionaries(e["tpl_base"] - len(self.templates),
                                       e.get("pd_base", 0) - len(self.params))
            elif e["tpl_base"] < len(self.templates):
                raise ValueError(
                    f"LZJS delta chain broken at chunk {k}: base "
                    f"{e['tpl_base']}/{e.get('pd_base')} vs accumulated "
                    f"{len(self.templates)}/{len(self.params)}")
            # a quarantined chunk's own lines are lost, but its delta
            # frames carry independent CRCs: apply every delta that still
            # verifies so LATER chunks' session-global ids keep resolving,
            # and pad only the frames that are actually damaged
            quarantined = bool(e.get("q"))
            try:
                if e.get("g"):
                    # salvage entry: slice by commit geometry, not by the
                    # record's own (possibly damaged) envelope varints
                    (_, _), (to, tl), (po, pl), _ = frame_positions(*e["g"])
                    with self._lock:
                        self._f.seek(e["offset"])
                        rec = self._f.read(e["length"])
                    td, td_crc = rec[to:to + tl], rec[to + tl:to + tl + CRC_LEN]
                    pd, pd_crc = rec[po:po + pl], rec[po + pl:po + pl + CRC_LEN]
                else:
                    with self._lock:
                        self._f.seek(e["doffset"])
                        data = self._f.read(e["offset"] + e["length"] - e["doffset"])
                    bf = io.BytesIO(data)
                    td = bf.read(_read_varint(bf))
                    td_crc = bf.read(CRC_LEN) if v3 else b""
                    pd = bf.read(_read_varint(bf))
                    pd_crc = bf.read(CRC_LEN) if v3 else b""
            except Exception:
                if not (self.salvage or quarantined):
                    raise
                e.setdefault("q", "chunk record unreadable")
                self._pad_dictionaries(e["n_delta"], e.get("pd_delta", 0))
                continue
            try:
                if v3:
                    integrity.verify(td, td_crc, frame="template_delta",
                                     offset=e["doffset"], chunk=k)
                self.templates.extend(
                    tuple(_deserialize_template(s)) for s in _unframe(td))
            except Exception as err:
                if not (self.salvage or quarantined):
                    raise
                if not quarantined:
                    e["q"] = f"template delta damaged: {err}"
                self.templates.extend([None] * e["n_delta"])
            try:
                if v3:
                    integrity.verify(pd, pd_crc, frame="paramdict_delta",
                                     offset=e["doffset"], chunk=k)
                self.params.extend(_unframe(pd))
            except Exception as err:
                if not (self.salvage or quarantined):
                    raise
                if not quarantined:
                    e["q"] = f"paramdict delta damaged: {err}"
                self.params.extend([None] * e.get("pd_delta", 0))

    def __len__(self) -> int:
        return len(self.index)

    def chunk_blob(self, k: int) -> bytes:
        e = self.index[k]
        if e.get("q"):
            raise IntegrityError(f"chunk quarantined: {e['q']}",
                                 frame="chunk", offset=e["offset"], chunk=k)
        with self._lock:
            self._f.seek(e["offset"])
            rec = self._f.read(e["length"])
        if len(rec) != e["length"]:
            raise ValueError(
                f"corrupt LZJS chunk record {k} at byte {e['offset']}: "
                f"short record ({len(rec)}/{e['length']} bytes)")
        parsed = parse_chunk_record(rec, k, e["offset"], self.version >= V3,
                                    geometry=e.get("g"))
        bad = parsed["bad"].get("chunk_payload")
        if bad is not None:
            raise bad
        return parsed["blob"]

    def decode_chunk(self, k: int) -> list[str]:
        self.chunks_decoded += 1
        from .codec import decompress

        return decompress(self.chunk_blob(k), ext_templates=self.templates,
                          ext_params=self.params)

    def chunk_reader(self, k: int):
        """Column-selective ``codec.ChunkReader`` over chunk ``k`` (the
        compressed-domain query engine's entry point — counts as a
        payload decode)."""
        self.chunks_decoded += 1
        from .codec import ChunkReader

        try:
            objects, meta = open_container(self.chunk_blob(k))
            return ChunkReader(objects, meta, self.templates, self.params)
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"truncated or corrupt LZJS chunk {k}: {e}") from e

    def manifest(self, k: int) -> dict:
        """Query-pushdown summary of chunk ``k`` from the footer index;
        {} for containers written before manifests existed (the planner
        then conservatively decodes the chunk)."""
        return self.index[k].get("manifest") or {}

    def screen(self, k: int):
        """Chunk ``k``'s parsed ``ChunkScreen`` (DESIGN.md §14), or None
        when the chunk carries no screen frame or the frame fails its
        seal — screens are advisory, so damage degrades to "no screen"
        instead of failing the read."""
        if k in self._screen_cache:
            return self._screen_cache[k]
        scr = None
        e = self.index[k]
        sc = e.get("sc")
        if sc and not e.get("q"):
            try:
                with self._lock:
                    self._f.seek(sc[0])
                    raw = self._f.read(sc[1])
                if len(raw) == sc[1] and raw[:4] == OPT_MAGIC \
                        and raw[4:8] == SCREEN_KIND:
                    plen, p = _take_varint(raw, 8)
                    integrity.verify(raw[:p + plen], raw[p + plen:p + plen + CRC_LEN],
                                     frame="screen", offset=sc[0], chunk=k)
                    scr = parse_screen_payload(bytes(raw[p:p + plen]))
            except (ValueError, IntegrityError, OSError):
                scr = None
        self._screen_cache[k] = scr
        return scr

    def read_structured_chunk(self, k: int) -> dict:
        return read_structured(self.chunk_blob(k), ext_templates=self.templates)

    def read_events(self, k: int) -> np.ndarray:
        """Global (session-stable) EventIDs of chunk ``k``'s matched lines."""
        s = self.read_structured_chunk(k)
        return np.asarray(s.get("events_global", s["events"]), np.int32)

    def covering_chunks(self, start: int, count: int) -> list[int]:
        stop = start + count
        return [k for k, e in enumerate(self.index)
                if e["line_start"] < stop and e["line_start"] + e["n_lines"] > start]

    def _chunk_lines_or_skip(self, k: int) -> list[str] | None:
        """Decode chunk ``k``; None when it is quarantined (or, in
        salvage mode, fails decode — then it is quarantined for the rest
        of this reader's life and the failure recorded)."""
        if self.index[k].get("q"):
            return None
        try:
            return self.decode_chunk(k)
        except ValueError as e:
            if not self.salvage:
                raise
            self.index[k]["q"] = f"decode failed: {e}"
            return None

    def read_range(self, start: int, count: int) -> list[str]:
        """Lines [start, start+count) — decodes only covering chunks.
        Quarantined chunks contribute nothing (their line ranges are
        lost; ``stats()`` / fsck report them), so line numbering of the
        survivors is preserved."""
        out: list[str] = []
        stop = start + count
        for k in self.covering_chunks(start, count):
            e = self.index[k]
            d = self._chunk_lines_or_skip(k)
            if d is None:
                continue
            lo = max(0, start - e["line_start"])
            hi = min(e["n_lines"], stop - e["line_start"])
            out.extend(d[lo:hi])
        return out

    def read_all(self) -> list[str]:
        return self.read_range(0, self.n_lines)

    def iter_lines(self):
        for k in range(len(self.index)):
            d = self._chunk_lines_or_skip(k)
            if d is not None:
                yield from d

    def chunk_crc_status(self, k: int) -> str:
        """Per-chunk integrity: ``"ok"``, ``"n/a"`` (pre-v3 container),
        ``"quarantined: <why>"``, or the failing frame's error."""
        e = self.index[k]
        if e.get("q"):
            return f"quarantined: {e['q']}"
        if self.version < V3:
            return "n/a"
        with self._lock:
            self._f.seek(e["offset"])
            rec = self._f.read(e["length"])
        if len(rec) != e["length"]:
            return f"short record ({len(rec)}/{e['length']} bytes)"
        try:
            parsed = parse_chunk_record(rec, k, e["offset"], True,
                                        geometry=e.get("g"))
        except ValueError as err:
            return str(err)
        if parsed["bad"]:
            return "; ".join(str(v) for v in parsed["bad"].values())
        return "ok"

    def stats(self) -> dict:
        out = {
            "n_lines": self.n_lines,
            "n_chunks": len(self.index),
            "n_templates": len(self.templates),
            "n_params": len(self.params),
            "level": self.footer.get("level"),
            "kernel": self.footer.get("kernel"),
            "format": self.footer.get("format"),
            "version": self.version,
            "crc": [self.chunk_crc_status(k) for k in range(len(self.index))],
            "chunks": self.index,
        }
        if self.salvage_report is not None:
            out["salvage"] = self.salvage_report
        return out

    def close(self) -> None:
        if self._own:
            self._f.close()


# ------------------------------------------------------ sequential decode

def iter_stream(f):
    """Forward-only decode of an LZJS byte stream (no seeking — works on
    pipes): yields lines chunk by chunk, accumulating the delta frames.
    v3 streams are CRC-verified frame by frame as they are read; errors
    carry the byte offset, frame type and chunk index."""
    from .codec import _deserialize_template

    head = f.read(5)
    if len(head) < 5 or head[:4] != STREAM_MAGIC:
        raise ValueError(
            f"not an LZJS container: magic {bytes(head[:4])!r}, expected {STREAM_MAGIC!r}")
    if head[4] not in READ_VERSIONS:
        raise ValueError(f"LZJS container version {head[4]} is newer than "
                         f"this reader (supports {V1}..{V3})")
    v3 = head[4] >= V3
    hlen, hraw = _read_varint2(f)
    hblob = f.read(hlen)
    pos = 5 + len(hraw) + hlen
    if v3:
        integrity.verify(head + hraw + hblob, f.read(CRC_LEN),
                         frame="header", offset=0)
        pos += CRC_LEN
    try:
        header = json.loads(zlib.decompress(hblob).decode("utf-8"))
    except Exception as e:
        raise ValueError(f"corrupt LZJS header: {e}") from e
    templates = [tuple(t) for t in header.get("seed_templates", [])]
    params: list[str] = list(header.get("seed_params", []))
    k = 0
    while True:
        rec_off = pos
        magic = f.read(4)
        if v3 and magic == OPT_MAGIC:
            # optional frame (screens today, anything tomorrow): verify
            # the seal, then skip it WHATEVER its kind — forward compat
            # by construction (DESIGN.md §14)
            kind = f.read(4)
            ln, raw = _read_varint2(f)
            payload = f.read(ln)
            if len(kind) != 4 or len(payload) != ln:
                raise ValueError(
                    f"truncated LZJS stream: optional frame at byte "
                    f"{rec_off} claims {ln} bytes, {len(payload)} present")
            integrity.verify(magic + kind + raw + payload, f.read(CRC_LEN),
                             frame="optional", offset=rec_off, chunk=k)
            pos = rec_off + 8 + len(raw) + ln + CRC_LEN
            continue
        if magic != CHUNK_MAGIC:
            # footer reached (zlib can't start with b"CHNK"): drain it and
            # demand the trailing magic — a stream cut at a record
            # boundary must fail loudly, not pass for a shorter session
            tail = magic + f.read()
            if len(tail) < 16 or tail[-8:] != FOOTER_MAGIC:
                raise ValueError(
                    f"truncated LZJS stream at byte {rec_off}: ends without "
                    f"a footer (was the session closed?)")
            if v3:
                flen = int.from_bytes(tail[-16:-8], "little")
                if flen + 16 + CRC_LEN > len(tail):
                    raise ValueError(
                        f"corrupt LZJS footer at byte {rec_off}: length out of range")
                integrity.verify(tail[:flen], tail[flen:flen + CRC_LEN],
                                 frame="footer", offset=rec_off)
            return
        pos += 4
        frames = {}
        for frame, key in (("chunk_payload", "blob"), ("template_delta", "td"),
                           ("paramdict_delta", "pd")):
            ln, raw = _read_varint2(f)
            data = f.read(ln)
            if len(data) != ln:
                raise ValueError(
                    f"truncated LZJS stream: chunk {k} {frame} frame at byte "
                    f"{pos + len(raw)} claims {ln} bytes, {len(data)} present")
            pos += len(raw)
            if v3:
                integrity.verify(data, f.read(CRC_LEN), frame=frame,
                                 offset=pos, chunk=k)
            pos += ln + (CRC_LEN if v3 else 0)
            frames[key] = data
        if v3:
            craw = bytearray(f.read(4))
            if bytes(craw) != COMMIT_MAGIC:
                raise IntegrityError(
                    "missing commit record (chunk never sealed)",
                    frame="commit", offset=pos, chunk=k)
            vals = []
            for _ in range(N_COMMIT_FIELDS):
                v, raw = _read_varint2(f)
                craw += raw
                vals.append(v)
            integrity.verify(bytes(craw), f.read(CRC_LEN), frame="commit",
                             offset=pos, chunk=k)
            if vals[0] != rec_off:
                raise IntegrityError(
                    f"commit record offset {vals[0]} does not match record "
                    f"position {rec_off}", frame="commit", offset=pos, chunk=k)
            pos += len(craw) + CRC_LEN
        try:
            objects, meta = open_container(frames["blob"])
        except ValueError as e:
            raise ValueError(f"LZJS chunk {k} at byte {rec_off}: {e}") from e
        stream = meta.get("stream")
        if stream is not None and stream["base"] != len(templates):
            raise ValueError(
                f"LZJS template delta out of order: chunk {k} base "
                f"{stream['base']}, accumulated {len(templates)}")
        templates.extend(tuple(_deserialize_template(s)) for s in _unframe(frames["td"]))
        params.extend(_unframe(frames["pd"]))
        yield from _decompress_objects(objects, meta, templates, params)
        k += 1


def decompress_lzjs(blob: bytes) -> list[str]:
    """Whole-container decode from an in-memory LZJS blob."""
    return LZJSReader(io.BytesIO(blob)).read_all()
