"""logzip archive codec (paper §IV): field extraction (L1), template
extraction (L2), parameter mapping (L3), then an off-the-shelf kernel
(gzip / bzip2 / lzma) over the packed object container.

Losslessness contract: ``decompress(compress(lines)) == lines`` for ANY
list of text lines — lines that defeat the header regex or the tokenizer
budget are routed to verbatim side channels. Property-tested.

Compression runs as the staged pipeline in ``repro_torch.core.stages``
(parse -> dedup -> structure -> encode -> pack over a ``Chunk`` IR);
this module keeps the public codec API plus the decode side.

Layout of the final blob:
    b"LZJF" | u8 kernel_id | u8 level | kernel(container)
where container is the object pack from ``encode.pack_container``.

Session chunks (written by ``core.stream``) carry
``meta["stream"] = {base, n_delta, used}``: the ``templates`` object
holds only this chunk's template *delta* and EventIDs are global ids
into the session's ``TemplateStore`` — decoding needs the accumulated
templates of earlier chunks via ``ext_templates``.
"""

from __future__ import annotations

import json

import numpy as np

from . import integrity
from .encode import (
    ColumnCodec,
    ParamDict,
    decode_varints,
    split_column,
    unesc,
    unpack_container,
)
from .stages import (
    FILE_MAGIC,
    KERNEL_BY_ID,
    KERNELS,
    WILDCARD_MARK,
    LogzipConfig,
    run_pipeline,
)

_KERNEL_BY_ID = KERNEL_BY_ID  # back-compat alias

__all__ = [
    "FILE_MAGIC", "KERNELS", "LogzipConfig", "ChunkReader", "compress",
    "decompress", "open_container", "read_structured", "compress_file",
    "decompress_file",
]


def _deserialize_template(s: str) -> list[str | None]:
    return [None if t == WILDCARD_MARK else unesc(t) for t in s.split("\x00")]


# ----------------------------------------------------------------- compress

def compress(
    lines: list[str],
    cfg: LogzipConfig | None = None,
    *,
    stage_times: dict | None = None,
) -> bytes:
    """Compress ``lines`` -> archive blob (staged pipeline, batch mode).

    ``stage_times``: optional dict that receives a per-stage wall-time
    breakdown (parse / dedup / tokenize / encode / ise.* / spans /
    columns / pack / kernel) — consumed by ``benchmarks/throughput.py``.
    """
    return run_pipeline(lines, cfg, stage_times=stage_times).blob


# --------------------------------------------------------------- decompress

def open_container(blob: bytes) -> tuple[dict, dict]:
    """Validate framing, run the entropy kernel, unpack -> (objects, meta).

    Raises ``ValueError`` (never a bare assert) on wrong magic, unknown
    kernel id, or a truncated/corrupt payload.
    """
    if len(blob) < 6 or blob[:4] != FILE_MAGIC:
        raise ValueError(
            f"not a logzip archive: magic {bytes(blob[:4])!r}, expected {FILE_MAGIC!r}")
    kid = blob[4]
    kernel = KERNEL_BY_ID.get(kid)
    if kernel is None:
        raise ValueError(f"unknown entropy kernel id {kid} in logzip archive")
    payload_end = len(blob)
    if blob[5] & 0x80:
        # v3 framing: the level byte's high bit flags a 4-byte CRC32C
        # trailer over everything that precedes it
        payload_end -= integrity.CRC_LEN
        integrity.verify(blob[:payload_end], bytes(blob[payload_end:]),
                         frame="lzjf_blob", offset=0)
    try:
        container = KERNELS[kernel][2](blob[6:payload_end])
        objects = unpack_container(container)
        meta = json.loads(objects["meta"].decode("utf-8"))
    except Exception as e:
        raise ValueError(f"truncated or corrupt logzip archive: {e}") from e
    if meta.get("v", 1) not in (1, 2):
        raise ValueError(
            f"logzip archive version {meta.get('v')} is newer than this "
            f"reader (supports v1 text columns and v2 typed columns)")
    return objects, meta


def decompress(blob: bytes, *, ext_templates: list | None = None,
               ext_params: list | None = None) -> list[str]:
    """Archive blob -> original lines.

    ``ext_templates`` / ``ext_params``: accumulated global template list
    (token tuples, None = wildcard) and ParamDict values for session
    chunks whose EventIDs / ParaIDs reference earlier chunks; ignored
    for self-contained archives.
    """
    objects, meta = open_container(blob)
    try:
        return _decompress_objects(objects, meta, ext_templates, ext_params)
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"truncated or corrupt logzip archive: {e}") from e


def _decompress_objects(objects, meta, ext_templates=None, ext_params=None) -> list[str]:
    return ChunkReader(objects, meta, ext_templates, ext_params).lines()


# ------------------------------------------------------------- ChunkReader

_UNSET = object()


class ChunkReader:
    """Lazy, column-selective access to one unpacked archive chunk.

    ``decompress`` is ``ChunkReader(...).lines()``; the compressed-domain
    query engine (``core.query``, DESIGN.md §11) uses the partial
    accessors instead — header columns, the EventID stream, one
    template's parameter columns — and only assembles the rows it needs
    (``line``/``content``), never paying for full-chunk materialization.

    Every decoded object is cached on first touch, so repeated access
    (e.g. several query conjuncts over the same chunk) decodes once.
    Row coordinates: a chunk has ``n`` lines; ``bad`` positions hold
    verbatim lines (header parse failures), the rest are *ok* rows
    numbered 0..n_ok-1 in line order. Ok rows split into *unmatched*
    rows (verbatim content) and *matched* rows, whose template ids come
    from the ``events`` stream in matched order — the r-th row of
    template ``k`` reads index ``r`` of that template's columns.
    """

    def __init__(self, objects, meta, ext_templates=None, ext_params=None):
        self.objects = objects
        self.meta = meta
        self.n: int = meta["n"]
        self.level: int = meta["level"]
        self._ext_templates = ext_templates
        self._ext_params = ext_params
        self.bad_pos = (np.cumsum(decode_varints(objects["raw.idx"])) - 1).tolist() \
            if objects["raw.idx"] else []
        self.bad_txt = split_column(objects["raw.txt"])
        self.n_ok = self.n - len(self.bad_pos)

        from .tokenizer import LogFormat

        self.fmt = LogFormat(meta["format"]) if meta.get("format") else None
        self._ok_pos = None
        self._header: dict[str, list[str]] = {}
        self._header_distinct: dict[str, tuple[list[str], np.ndarray]] = {}
        self._events = None
        self._un = None
        self._matched_of_ok = None
        self._templates = None
        self._params = _UNSET
        self._tpl: dict[int, dict] = {}
        self._l1_contents = None
        self._affixes = None

    # -- row coordinate maps ------------------------------------------
    @property
    def ok_pos(self) -> np.ndarray:
        """Line positions of the ok rows (ascending)."""
        if self._ok_pos is None:
            mask = np.ones(self.n, bool)
            if self.bad_pos:
                mask[np.asarray(self.bad_pos, np.int64)] = False
            self._ok_pos = np.flatnonzero(mask)
        return self._ok_pos

    @property
    def un_rows(self) -> np.ndarray:
        """Ok-row indices whose content went verbatim (unmatched)."""
        self._load_un()
        return self._un[0]

    @property
    def un_txt(self) -> list[str]:
        self._load_un()
        return self._un[1]

    def _load_un(self) -> None:
        if self._un is None:
            if self.level < 2:
                self._un = (np.zeros(0, np.int64), [])
            else:
                idx = np.cumsum(decode_varints(self.objects["cun.idx"])) - 1 \
                    if self.objects["cun.idx"] else np.zeros(0, np.int64)
                self._un = (np.asarray(idx, np.int64), split_column(self.objects["cun.txt"]))

    @property
    def events(self) -> np.ndarray:
        """Per matched ok-row (in row order) the chunk-local template id."""
        if self._events is None:
            self._events = np.asarray(decode_varints(self.objects["events"]), np.int64)
        return self._events

    @property
    def matched_rows(self) -> np.ndarray:
        """Ok-row indices of matched rows, aligned with ``events``."""
        if self._matched_of_ok is None:
            mask = np.ones(self.n_ok, bool)
            un = self.un_rows
            if len(un):
                mask[un] = False
            self._matched_of_ok = np.flatnonzero(mask)
        return self._matched_of_ok

    @property
    def used_global(self) -> list[int] | None:
        """Session-global EventID per chunk-local template id (LZJS
        chunks); None when local ids are the only namespace."""
        stream = self.meta.get("stream")
        return list(stream["used"]) if stream is not None else None

    # -- columns -------------------------------------------------------
    def header_column(self, field: str) -> list[str]:
        col = self._header.get(field)
        if col is None:
            if self.fmt is None or field not in self.fmt.fields or \
                    field == self.fmt.content_field:
                raise ValueError(f"no header field {field!r} in this archive")
            col = ColumnCodec(f"h.{field}").decode(self.objects, self.n_ok)
            self._header[field] = col
        return col

    def header_distinct(self, field: str) -> tuple[list[str], np.ndarray]:
        """Header column ``field`` as (distinct values, inverse) — the
        aggregation operators' entry point: predicates and group keys
        evaluate per distinct value, multiplicities come from the inverse
        (rows are never materialized). Header columns hold their text, never
        ParaIDs, so they decode as ``header_column`` does: without the
        ParamDict (the reference passes it, and reads a text header column
        of a level-3 chunk as ParaIDs)."""
        col = self._header_distinct.get(field)
        if col is None:
            if self.fmt is None or field not in self.fmt.fields or \
                    field == self.fmt.content_field:
                raise ValueError(f"no header field {field!r} in this archive")
            col = ColumnCodec(f"h.{field}").decode_distinct(self.objects, self.n_ok)
            self._header_distinct[field] = col
        return col

    @property
    def templates(self) -> list[list[str | None]]:
        """Chunk-local templates as token lists (None = wildcard)."""
        if self._templates is None:
            self._templates = resolve_templates(self.objects, self.meta, self._ext_templates)
        return self._templates

    @property
    def paravalues(self) -> list[str] | None:
        if self._params is _UNSET:
            self._params = resolve_params(self.objects, self.meta, self._ext_params) \
                if self.level >= 3 else None
        return self._params

    def _tpl_state(self, k: int) -> dict:
        st = self._tpl.get(k)
        if st is None:
            tpl = self.templates[k]
            gap_ids = decode_varints(self.objects[f"t{k}.gap.pid"])
            st = {
                "tpl": tpl,
                "n_stars": sum(1 for t in tpl if t is None),
                "count": len(gap_ids),
                "gap_ids": gap_ids,
                "gap_pats": None,
                "stars": {},
                "rows": None,       # matched-sequence indices (== column index)
                "contents": None,
            }
            self._tpl[k] = st
        return st

    def template_rows(self, k: int) -> np.ndarray:
        """Indices into the matched sequence for template ``k``; the i-th
        entry is the row that reads index i of the template's columns."""
        st = self._tpl_state(k)
        if st["rows"] is None:
            st["rows"] = np.flatnonzero(self.events == k)
        return st["rows"]

    def star_column(self, k: int, s: int) -> tuple[list[str], np.ndarray]:
        """Parameter column ``s`` of template ``k`` -> (distinct values,
        inverse): predicates evaluate on the distinct values only."""
        st = self._tpl_state(k)
        col = st["stars"].get(s)
        if col is None:
            col = ColumnCodec(f"t{k}.v{s}", None).decode_distinct(
                self.objects, st["count"], self.paravalues)
            st["stars"][s] = col
        return col

    def template_contents(self, k: int) -> list[str]:
        """All contents of template ``k`` in column order (index aligns
        with ``template_rows``)."""
        st = self._tpl_state(k)
        if st["contents"] is None:
            if st["gap_pats"] is None:
                st["gap_pats"] = [
                    [unesc(g) for g in p.split("\x00")]
                    for p in split_column(self.objects[f"t{k}.gap.pat"])
                ]
            stars = [self.star_column(k, s) for s in range(st["n_stars"])]
            tpl = st["tpl"]
            out: list[str] = []
            for r in range(st["count"]):
                gaps = st["gap_pats"][st["gap_ids"][r]]
                pieces = [gaps[0]]
                si = 0
                for j, t in enumerate(tpl):
                    if t is None:
                        uniq, inv = stars[si]
                        pieces.append(uniq[inv[r]])
                        si += 1
                    else:
                        pieces.append(t)
                    pieces.append(gaps[j + 1])
                out.append("".join(pieces))
            st["contents"] = out
        return st["contents"]

    # -- row assembly --------------------------------------------------
    def content(self, ok_row: int) -> str:
        """Message content of one ok row."""
        if self.level < 2:
            if self._l1_contents is None:
                self._l1_contents = split_column(self.objects["content.txt"])
            return self._l1_contents[ok_row]
        self._load_un()
        un_rows, un_txt = self._un
        j = int(np.searchsorted(un_rows, ok_row))
        if j < len(un_rows) and un_rows[j] == ok_row:
            return un_txt[j]
        m = int(np.searchsorted(self.matched_rows, ok_row))
        k = int(self.events[m])
        r = int(np.searchsorted(self.template_rows(k), m))
        return self.template_contents(k)[r]

    def header_affixes(self) -> tuple[list[str], list[str]]:
        """Per ok row the rendered line text before / after the content
        field -> (prefixes, suffixes). Empty strings when there is no
        header format."""
        if self._affixes is None:
            if self.fmt is None:
                empty = [""] * self.n_ok
                self._affixes = (empty, empty)
            else:
                fmt = self.fmt
                ci = fmt.fields.index(fmt.content_field)
                pre_fields = fmt.fields[:ci]
                post_fields = fmt.fields[ci + 1:]
                segs = fmt._segments
                pre_cols = [self.header_column(f) for f in pre_fields]
                post_cols = [self.header_column(f) for f in post_fields]
                pres, posts = [], []
                for r in range(self.n_ok):
                    parts = [segs[0]]
                    for j, col in enumerate(pre_cols):
                        parts.append(col[r])
                        parts.append(segs[j + 1])
                    pres.append("".join(parts))
                    parts = []
                    for j, col in enumerate(post_cols):
                        parts.append(col[r])
                        parts.append(segs[ci + 2 + j])
                    posts.append(segs[ci + 1] + "".join(parts))
                self._affixes = (pres, posts)
        return self._affixes

    def line(self, pos: int) -> str:
        """Fully materialized line at chunk position ``pos``."""
        j = int(np.searchsorted(np.asarray(self.bad_pos, np.int64), pos)) \
            if self.bad_pos else 0
        if self.bad_pos and j < len(self.bad_pos) and self.bad_pos[j] == pos:
            return self.bad_txt[j]
        r = int(np.searchsorted(self.ok_pos, pos))
        content = self.content(r)
        if self.fmt is None:
            return content
        pre, post = self.header_affixes()
        return pre[r] + content + post[r]

    def lines(self) -> list[str]:
        """Full decode — the ``decompress`` path."""
        out: list[str | None] = [None] * self.n
        for i, txt in zip(self.bad_pos, self.bad_txt):
            out[i] = txt
        if self.n_ok:
            if self.fmt is None:
                for r, i in enumerate(self.ok_pos.tolist()):
                    out[i] = self.content(r)
            else:
                pre, post = self.header_affixes()
                for r, i in enumerate(self.ok_pos.tolist()):
                    out[i] = pre[r] + self.content(r) + post[r]
        return out  # type: ignore[return-value]


def resolve_templates(objects, meta, ext_templates=None) -> list[list[str | None]]:
    """The template list the chunk's remapped EventIDs index into.

    Self-contained archives carry it whole. Session chunks carry their
    template delta in the container record *frame* (``core.stream``
    accumulates the deltas), so decoding one needs the accumulated global
    list via ``ext_templates``.
    """
    stream = meta.get("stream")
    if stream is None:
        if not meta.get("n_templates"):
            return []
        return [_deserialize_template(s) for s in split_column(objects["templates"])]
    if ext_templates is None:
        raise ValueError(
            "session chunk: EventIDs are global store ids; pass ext_templates "
            "(decode through the LZJS container reader or iter_stream)")
    try:
        return [list(ext_templates[g]) for g in stream["used"]]
    except IndexError as e:
        raise ValueError(f"ext_templates too short for session chunk: {e}") from e


def resolve_params(objects, meta, ext_params=None) -> list[str] | None:
    """The ParaID -> value list for a level-3 archive.

    Session chunks reference the session-shared ``ParamDict`` (deltas
    ride in the container record frames), so the accumulated value list
    must come in via ``ext_params``."""
    stream = meta.get("stream")
    if stream is not None and "pd_delta" in stream:
        pd_end = stream.get("pd_base", 0) + stream["pd_delta"]
        if ext_params is None:
            raise ValueError(
                "session chunk: ParaIDs index the session ParamDict; pass "
                "ext_params (decode through the LZJS container reader)")
        if len(ext_params) < pd_end:
            raise ValueError(
                f"ext_params too short for session chunk: need {pd_end}, "
                f"got {len(ext_params)}")
        return list(ext_params)
    if "paradict" in objects:
        return ParamDict.decode(objects["paradict"])
    return None


# ------------------------------------------------------- structured access

def read_structured(blob: bytes, *, ext_templates: list | None = None) -> dict:
    """Read the level>=2 intermediate representation WITHOUT full decode.

    This is the paper's "structured intermediate representations ...
    directly utilized in many downstream tasks": the EventID stream and
    template strings come straight out of the archive objects (no line
    reconstruction). Used by the anomaly-detection example and the
    event-sequence data pipeline.

    For session chunks the ``events`` stream is additionally mapped back
    to the store's global ids in ``events_global`` (stable across every
    chunk of the session), and ``stream`` carries {base, n_delta, used}.
    """
    objects, meta = open_container(blob)
    if meta["level"] < 2:
        raise ValueError("structured access needs a level >= 2 archive")
    templates = [
        " ".join("<*>" if t is None else t for t in tpl)
        for tpl in resolve_templates(objects, meta, ext_templates)
    ]
    events = np.array(decode_varints(objects["events"]), np.int32)
    out = {
        "meta": meta,
        "events": events,
        "templates": templates,
        "match_rate": meta.get("match_rate"),
    }
    stream = meta.get("stream")
    if stream is not None:
        used = np.asarray(stream["used"], np.int32)
        out["stream"] = stream
        out["events_global"] = used[events] if len(events) else events
    return out


# ----------------------------------------------------------------- file API

def compress_file(path_in: str, path_out: str, cfg: LogzipConfig | None = None) -> dict:
    with open(path_in, "r", encoding="utf-8", errors="surrogateescape") as f:
        lines = f.read().split("\n")
    blob = compress(lines, cfg)
    with open(path_out, "wb") as f:
        f.write(blob)
    return {"in_bytes": sum(len(l) + 1 for l in lines) - 1, "out_bytes": len(blob)}


def decompress_file(path_in: str, path_out: str) -> None:
    with open(path_in, "rb") as f:
        blob = f.read()
    lines = decompress(blob)
    with open(path_out, "w", encoding="utf-8", errors="surrogateescape") as f:
        f.write("\n".join(lines))
