"""Staged compression pipeline over a first-class ``Chunk`` IR (DESIGN.md §9).

``codec.compress`` is a thin composition of the stages below:

    parse -> dedup -> structure -> encode -> pack

Each stage reads and fills declared fields of a ``Chunk`` — the unit of
work for both the batch path (one chunk = the whole corpus) and a
``StreamingCompressor`` session (``core.stream``: chunks cut by
line/byte budget, sharing one growing ``TemplateStore``). The structure
stage has two modes:

- **batch** (default): ISE over the whole chunk, or match-only against a
  frozen ``cfg.template_store`` — archive layout identical to the
  pre-refactor monolithic codec.
- **session** (``store=`` + ``grow=True``): match against the shared
  store first, run ISE only on the unmatched remainder, append the new
  templates to the store and serialize only the *delta*. EventIDs in
  ``meta["stream"]["used"]`` are the store's global ids, stable across
  every chunk of the session (and across appends).
"""

from __future__ import annotations

import bz2
import json
import lzma
import zlib
from dataclasses import dataclass, field as dfield

import numpy as np

from . import integrity
from .encode import (
    ColumnCodec,
    ParamDict,
    encode_varints,
    esc,
    factorize,
    join_column,
    pack_container,
)
from ..kernels.ops import check_device
from .ise import ISEConfig, ISEResult, iterative_structure_extraction
from .match import extract_spans, match_first
from .templates import TemplateStore
from .textops import first_occurrence_unique
from .timing import StageTimer
from .tokenizer import STAR_ID, LogFormat, TokenGrid, Vocab, tokenize_batch

FILE_MAGIC = b"LZJF"
WILDCARD_MARK = "\x02"

KERNELS: dict[str, tuple[int, object, object]] = {
    "gzip": (0, lambda b: zlib.compress(b, 6), zlib.decompress),
    "bzip2": (1, lambda b: bz2.compress(b, 9), bz2.decompress),
    "lzma": (2, lambda b: lzma.compress(b, preset=6), lzma.decompress),
    "none": (3, lambda b: b, lambda b: b),
}
KERNEL_BY_ID = {v[0]: k for k, v in KERNELS.items()}


@dataclass
class LogzipConfig:
    level: int = 3                  # 1 | 2 | 3 (paper's levels)
    kernel: str = "gzip"
    format: str | None = None       # loghub format string, None = content-only
    max_tokens: int = 128
    ise: ISEConfig = dfield(default_factory=ISEConfig)
    # paper §III-E: a pre-extracted TemplateStore skips ISE — new logs are
    # matched against the stored templates (stable EventIDs across archives)
    template_store: object = None
    # dedup fast path: tokenize / span-extract each *distinct* content
    # string once and fan results back out by inverse index. Byte-identical
    # archives either way (property-tested); False only exists as the
    # reference path for that test and for ablation benchmarks.
    dedup: bool = True
    # session mode: a template discovered by remainder-ISE enters the
    # shared store only if it matched at least this many lines in its
    # chunk; below-threshold lines go verbatim. Guards the store against
    # over-specific one-off templates (literal params baked in), which
    # bloat the delta stream and slow every later chunk's match pass.
    stream_min_support: int = 2
    # typed parameter-column codecs (DESIGN.md §12): classify each
    # header/star column (timestamp / monotone / numeric / mini-dict /
    # ip-hex) and store it under the typed layout; columns that do not
    # classify fall back to the v1 text layout. Bumps the archive meta
    # version to 2; False reproduces the v1 bytes exactly (the committed
    # v1 golden fixtures are built this way).
    typed_columns: bool = True
    # CRC32C per-frame trailers (DESIGN.md §13): every frame the writers
    # emit — the LZJF kernel payload, LZJS header / chunk / delta /
    # footer frames — is followed by a 4-byte checksum, and each LZJS
    # chunk is sealed by a commit record so a torn-off footer can be
    # rebuilt by scanning. Bumps the container version to 3; False
    # reproduces the v1/v2 bytes exactly (the committed v1/v2 golden
    # fixtures are built this way).
    integrity: bool = True
    # per-chunk query screens (DESIGN.md §14): v3 LZJS sessions append a
    # CRC-sealed optional SCRN frame after each chunk's commit — Bloom
    # filters over cold ParamDict references and high-cardinality header
    # fields — so point queries open O(1) chunks. Pre-screen readers
    # skip the frames (they sit inside the indexed record range); False
    # reproduces the screen-free v3 bytes exactly (golden fixtures).
    screens: bool = True
    screen_fpp: float = 0.02
    # where the kernels of ``ise.use_kernel`` run: "cuda" launches the
    # hand-written CUDA kernels and raises when no card is present;
    # "cpu" runs their plain torch versions. A run-time choice only: it
    # is never written to the archive, whose bytes do not depend on it.
    device: str = "cuda"


class StreamSession:
    """Mutable cross-chunk state of a streaming compression session.

    Both members are append-only with get-or-assign interning, so the
    global ids they hand out (EventIDs, ParaIDs) are stable for the life
    of the session — chunks serialize only the *delta* each added.
    Memory grows with the number of DISTINCT templates / parameter
    values, not with the corpus.
    """

    def __init__(self, store: TemplateStore | None = None,
                 paradict: ParamDict | None = None):
        self.store = store if store is not None else TemplateStore()
        self.paradict = paradict if paradict is not None else ParamDict()


def serialize_template(tokens: list[str | None]) -> str:
    return "\x00".join(WILDCARD_MARK if t is None else esc(t) for t in tokens)


# ----------------------------------------------------------------- Chunk IR

@dataclass
class Chunk:
    """Unit of work flowing through the staged pipeline.

    Stages fill fields progressively; ``objects`` / ``meta`` accumulate
    the archive representation that ``pack_stage`` frames into ``blob``.
    """

    lines: list[str]
    # -- parse_stage
    fmt: LogFormat | None = None
    columns: dict = dfield(default_factory=dict)
    ok_idx: list[int] = dfield(default_factory=list)
    bad_idx: list[int] = dfield(default_factory=list)
    contents: list[str] = dfield(default_factory=list)
    # -- dedup_stage
    inverse: np.ndarray | None = None        # line -> distinct-content index
    uniq: list[str] | None = None
    grid: TokenGrid | None = None            # batched tokens/delims/offsets
    vocab: Vocab | None = None
    ids_u: np.ndarray | None = None
    lens_u: np.ndarray | None = None
    ids: np.ndarray | None = None
    lens: np.ndarray | None = None
    levels: np.ndarray | None = None
    comps: np.ndarray | None = None
    # -- structure_stage
    templates: list = dfield(default_factory=list)  # token-id arrays, chunk vocab
    assign: np.ndarray | None = None         # per ok-line template id (-1 verbatim)
    match_rate: float = 1.0
    session: bool = False                     # store-global EventID mode
    tpl_base: int = 0                         # store size before this chunk
    n_delta: int = 0                          # templates this chunk added
    tpl_strings: list | None = None           # store string tuples (global ids)
    pd_base: int = 0                          # session paradict size before chunk
    delta_templates: list | None = None       # serialized new templates (session)
    delta_params: list | None = None          # new ParamDict values (session)
    # -- encode/pack
    objects: dict[str, bytes] = dfield(default_factory=dict)
    meta: dict = dfield(default_factory=dict)
    coltypes: dict = dfield(default_factory=dict)  # column -> type summary
    blob: bytes | None = None


# ------------------------------------------------------------------ stages

def parse_stage(ch: Chunk, cfg: LogzipConfig, tm: StageTimer,
                session: StreamSession | None = None) -> None:
    """L1: header/content split, verbatim channel for parse failures,
    header-field columns."""
    ch.meta.update({"v": 2 if cfg.typed_columns else 1, "level": cfg.level,
                    "n": len(ch.lines), "format": cfg.format})
    with tm("parse"):
        ch.fmt = LogFormat(cfg.format) if cfg.format else None
        if ch.fmt is not None:
            ch.columns, ch.ok_idx, ch.bad_idx = ch.fmt.parse(ch.lines)
            ch.contents = ch.columns[ch.fmt.content_field]
            ch.meta["fields"] = ch.fmt.fields
        else:
            ch.columns, ch.ok_idx, ch.bad_idx = {}, list(range(len(ch.lines))), []
            ch.contents = list(ch.lines)
    ch.objects["raw.idx"] = encode_varints(np.diff(np.array([-1] + ch.bad_idx)))
    ch.objects["raw.txt"] = join_column([ch.lines[i] for i in ch.bad_idx])
    with tm("columns"):
        for f in (ch.fmt.fields if ch.fmt else []):
            if f == ch.fmt.content_field:
                continue
            ch.objects.update(ColumnCodec(
                f"h.{f}", typed=cfg.typed_columns, type_sink=ch.coltypes,
                use_kernel=cfg.ise.use_kernel, device=cfg.device,
                wide_ints_text=session is not None).encode(ch.columns[f]))


def dedup_stage(ch: Chunk, cfg: LogzipConfig, tm: StageTimer) -> None:
    """Factorize distinct contents, tokenize / vocab-encode once each
    (DESIGN.md §1.1 — archive bytes identical with ``cfg.dedup`` off)."""
    n = len(ch.contents)
    with tm("dedup"):
        if cfg.dedup:
            ch.inverse, ch.uniq = factorize(ch.contents)
        else:
            ch.inverse, ch.uniq = np.arange(n, dtype=np.int64), list(ch.contents)
    with tm("tokenize"):
        ch.vocab = Vocab()
        ch.grid = tokenize_batch(ch.uniq, ch.vocab, cfg.max_tokens, tight=True)
    with tm("encode"):
        ch.ids_u, ch.lens_u = ch.grid.ids, ch.grid.lens
        ch.ids = ch.ids_u[ch.inverse]
        ch.lens = ch.lens_u[ch.inverse]
        ch.levels = factorize(ch.columns["Level"])[0] if "Level" in ch.columns else None
        ch.comps = factorize(ch.columns["Component"])[0] if "Component" in ch.columns else None


def structure_stage(ch: Chunk, cfg: LogzipConfig, tm: StageTimer,
                    session: StreamSession | None = None) -> None:
    """Assign every line a template id.

    Batch mode: full ISE (or match-only against a frozen
    ``cfg.template_store``). Session mode: match against the shared
    store first, ISE only the unmatched remainder, grow the store with
    the newly-discovered templates.
    """
    if session is not None:
        _structure_session(ch, cfg, tm, session.store)
        return
    if cfg.template_store is not None:
        tpl_ids = cfg.template_store.to_id_arrays(ch.vocab)
        with tm("ise.match"):
            a = match_first(ch.ids, ch.lens, tpl_ids, use_kernel=cfg.ise.use_kernel,
                            device=cfg.device)
        res = ISEResult(tpl_ids, a, [float((a >= 0).mean())], [])
        ch.meta["template_store"] = True
    else:
        res = iterative_structure_extraction(ch.ids, ch.lens, ch.levels, ch.comps,
                                             len(ch.vocab), cfg.ise, stage_times=tm.sink,
                                             device=cfg.device)
    ch.templates = res.templates
    ch.match_rate = res.match_rate
    ch.assign = res.assign.astype(np.int64)
    ch.assign[ch.lens > cfg.max_tokens] = -1  # over-budget lines go verbatim


def _structure_session(ch: Chunk, cfg: LogzipConfig, tm: StageTimer, store) -> None:
    ch.session = True
    ch.tpl_base = len(store)
    n = ch.ids.shape[0]
    assign = np.full((n,), -1, np.int64)
    if len(store):
        with tm("ise.match"):
            a = match_first(ch.ids, ch.lens, store.to_id_arrays(ch.vocab),
                            use_kernel=cfg.ise.use_kernel, device=cfg.device)
        assign = a.astype(np.int64)
    rem = np.nonzero(assign < 0)[0]
    if rem.size:
        res = iterative_structure_extraction(
            ch.ids[rem], ch.lens[rem],
            ch.levels[rem] if ch.levels is not None else None,
            ch.comps[rem] if ch.comps is not None else None,
            len(ch.vocab), cfg.ise, stage_times=tm.sink, device=cfg.device)
        if res.templates:
            # promote only supported templates (cfg.stream_min_support);
            # lines of dropped one-off templates go verbatim instead of
            # polluting every later chunk's store
            support = np.bincount(res.assign[res.assign >= 0],
                                  minlength=len(res.templates))
            local_to_global = np.full(len(res.templates), -1, np.int64)
            for j, tpl in enumerate(res.templates):
                if support[j] >= cfg.stream_min_support:
                    local_to_global[j] = store.add(tuple(
                        None if int(t) == STAR_ID else ch.vocab.token(int(t))
                        for t in tpl))
            hit = res.assign >= 0
            assign[rem] = np.where(hit, local_to_global[np.maximum(res.assign, 0)], -1)
    ch.match_rate = float((assign >= 0).mean()) if n else 1.0
    assign[ch.lens > cfg.max_tokens] = -1
    ch.assign = assign
    ch.n_delta = len(store) - ch.tpl_base
    ch.tpl_strings = list(store.templates)
    # id arrays in THIS chunk's vocab. For store-matched templates these
    # are the arrays the DP matched with; for templates just discovered
    # here every literal is in the chunk vocab, so the round trip through
    # strings is exact.
    ch.templates = store.to_id_arrays(ch.vocab)


def encode_stage(ch: Chunk, cfg: LogzipConfig, tm: StageTimer,
                 session: StreamSession | None = None) -> None:
    """L2/L3: verbatim channel for unmatched lines, template + EventID
    objects, per-template star-value columns and gap patterns.

    Session chunks share the session's ``ParamDict`` and serialize only
    its delta (``pd.delta``) — ParaIDs are global across the stream."""
    if cfg.level == 1:
        ch.objects["content.txt"] = join_column(ch.contents)
        return
    assign = ch.assign

    # verbatim channel for unmatched content (indices within the ok-lines)
    un_pos = np.nonzero(assign < 0)[0]
    ch.objects["cun.idx"] = encode_varints(np.diff(np.concatenate([[-1], un_pos])))
    ch.objects["cun.txt"] = join_column([ch.contents[i] for i in un_pos])

    # compact remap of used templates — UNLESS global EventIDs are in
    # play (frozen store or streaming session): downstream consumers key
    # on the store's ids, so those are preserved
    if ch.session:
        used = sorted(set(int(a) for a in assign if a >= 0))
        # the template delta rides in the container record FRAME (see
        # core.stream), not in the kernel-compressed blob — random
        # access reads deltas without decoding chunk payloads
        delta = ch.tpl_strings[ch.tpl_base:ch.tpl_base + ch.n_delta]
        ch.delta_templates = [serialize_template(list(t)) for t in delta]
        ch.meta["stream"] = {"base": ch.tpl_base, "n_delta": ch.n_delta, "used": used}
    elif cfg.template_store is not None:
        used = list(range(len(ch.templates)))
    else:
        used = sorted(set(int(a) for a in assign if a >= 0))
    ch.meta["n_templates"] = len(used)
    ch.meta["match_rate"] = ch.match_rate

    if not ch.session:
        tser: list[str] = []
        for g in used:
            if cfg.template_store is not None:
                # store literals may be absent from THIS corpus's vocab —
                # serialize from the store's own strings
                toks = list(cfg.template_store.templates[g])
            else:
                toks = [None if int(t) == STAR_ID else ch.vocab.token(int(t))
                        for t in ch.templates[g]]
            tser.append(serialize_template(toks))
        ch.objects["templates"] = join_column(tser)

    matched = np.nonzero(assign >= 0)[0]
    remap_arr = np.full(len(ch.templates), -1, np.int64)
    remap_arr[np.asarray(used, np.int64)] = np.arange(len(used))
    ch.objects["events"] = encode_varints(remap_arr[assign[matched]])

    vocab_arr = np.array([ch.vocab.token(i) for i in range(len(ch.vocab))], dtype=object)
    paradict = None
    if cfg.level >= 3:
        paradict = session.paradict if (ch.session and session is not None) else ParamDict()
        ch.pd_base = len(paradict.values)
    for k, g in enumerate(used):
        tpl = ch.templates[g]
        line_idx = np.nonzero(assign == g)[0]
        with tm("spans"):
            star_cols, pat_list, pat_ids = _template_params(
                tpl, line_idx, ch.inverse, ch.grid, vocab_arr)
        with tm("columns"):
            for s, col in enumerate(star_cols):
                ch.objects.update(ColumnCodec(
                    f"t{k}.v{s}", paradict, typed=cfg.typed_columns,
                    type_sink=ch.coltypes, use_kernel=cfg.ise.use_kernel,
                    device=cfg.device, wide_ints_text=ch.session).encode(col))
            ch.objects[f"t{k}.gap.pat"] = join_column(pat_list)
            ch.objects[f"t{k}.gap.pid"] = encode_varints(pat_ids)

    if paradict is not None:
        if ch.session and session is not None:
            ch.delta_params = list(paradict.values[ch.pd_base:])
            ch.meta["stream"]["pd_base"] = ch.pd_base
            ch.meta["stream"]["pd_delta"] = len(paradict.values) - ch.pd_base
        else:
            ch.objects["paradict"] = paradict.encode()
    if cfg.typed_columns and ch.coltypes:
        # per-column type table (inspect / downstream stats; the full
        # summaries additionally feed the LZJS chunk manifest)
        ch.meta["coltypes"] = {name: info["t"] for name, info in ch.coltypes.items()}


def pack_stage(ch: Chunk, cfg: LogzipConfig, tm: StageTimer) -> bytes:
    ch.objects["meta"] = json.dumps(ch.meta).encode("utf-8")
    with tm("pack"):
        container = pack_container(ch.objects)
    kid, comp, _ = KERNELS[cfg.kernel]
    with tm("kernel"):
        blob = comp(container)
    if cfg.integrity:
        # v3: bit 7 of the level byte flags a CRC32C trailer over
        # everything before it (levels are 1-3, so the bit is free)
        body = FILE_MAGIC + bytes([kid, cfg.level | 0x80]) + blob
        ch.blob = body + integrity.trailer(body)
    else:
        ch.blob = FILE_MAGIC + bytes([kid, cfg.level]) + blob
    return ch.blob


def run_stages(
    lines: list[str],
    cfg: LogzipConfig | None = None,
    *,
    stage_times: dict | None = None,
    session: StreamSession | None = None,
) -> Chunk:
    """parse -> dedup -> structure -> encode over one chunk — everything
    *except* the entropy kernel. ``pack_stage`` is split out so callers
    can overlap it with the next chunk's compute (the double-buffered
    handoff in ``core.stream`` / ``core.parallel``: gzip of
    chunk k runs on a worker thread — zlib/bz2/lzma release the GIL —
    while chunk k+1 is tokenized and matched here)."""
    cfg = cfg or LogzipConfig()
    if cfg.level not in (1, 2, 3):
        raise ValueError("level must be 1, 2 or 3")
    if session is not None and cfg.template_store is not None:
        raise ValueError("session mode grows its own store; cfg.template_store must be None")
    check_device(cfg.device)
    tm = StageTimer(stage_times)
    ch = Chunk(lines=lines)
    parse_stage(ch, cfg, tm, session=session)
    if cfg.level >= 2:
        dedup_stage(ch, cfg, tm)
        structure_stage(ch, cfg, tm, session=session)
    encode_stage(ch, cfg, tm, session=session)
    return ch


def run_pipeline(
    lines: list[str],
    cfg: LogzipConfig | None = None,
    *,
    stage_times: dict | None = None,
    session: StreamSession | None = None,
) -> Chunk:
    """parse -> dedup -> structure -> encode -> pack over one chunk."""
    cfg = cfg or LogzipConfig()
    ch = run_stages(lines, cfg, stage_times=stage_times, session=session)
    pack_stage(ch, cfg, StageTimer(stage_times))
    return ch


def _template_params(tpl, line_idx, inverse, grid: TokenGrid, vocab_arr):
    """Star-value columns + gap-pattern dictionary for one template.

    All heavy work runs once per distinct content: spans come from the
    fused anchor matcher on the unique rows, star substrings from one
    vectorized vocab lookup (single-token spans, the common case) or an
    O(1) byte slice of the original content (multi-token spans), and gap
    patterns are computed once per distinct (star widths, interned delim
    row) class — identical to walking every line, because the gap
    sequence is a pure function of that key for a fixed template.
    """
    u_lines = inverse[line_idx]
    uu_inv, ufirst = first_occurrence_unique(u_lines)
    uu_arr = u_lines[ufirst]  # uniques in first-line-occurrence order
    spans_u = extract_spans(grid.ids[uu_arr], grid.lens[uu_arr], tpl)
    n_uu, n_stars = spans_u.shape[:2]
    widths = spans_u[:, :, 1] - spans_u[:, :, 0]

    ustar = np.empty((n_uu, n_stars), dtype=object)
    for si in range(n_stars):
        single = widths[:, si] == 1
        if single.any():
            rows = np.nonzero(single)[0]
            ustar[rows, si] = vocab_arr[grid.ids[uu_arr[rows], spans_u[rows, si, 0]]]
        for r in np.nonzero(~single)[0]:
            u = int(uu_arr[r])
            ustar[r, si] = grid.substring(u, int(spans_u[r, si, 0]), int(spans_u[r, si, 1]))

    # gap (unit-delimiter) pattern per (widths, delim-row) class: rows in
    # one class share every delimiter run and every star width, so the
    # walk below runs once per class, not once per unique line
    tpl_is_star = [int(t) == STAR_ID for t in tpl]
    dl = grid.delim_ids[uu_arr]
    gkey = np.ascontiguousarray(np.concatenate([widths.astype(np.int32), dl], axis=1))
    rows_v = gkey.view(np.dtype((np.void, gkey.shape[1] * gkey.itemsize))).ravel()
    ginv, gfirst = first_occurrence_unique(rows_v)
    dtab = [esc(d) for d in grid.delim_table]
    class_pat: list[str] = []
    for r in gfirst.tolist():
        drow = dl[r]
        gaps = [dtab[drow[0]]]
        si = 0
        pos = 0
        for is_star in tpl_is_star:
            if is_star:
                pos = int(spans_u[r, si, 1])
                si += 1
            else:
                pos += 1
            gaps.append(dtab[drow[pos]])
        class_pat.append("\x00".join(gaps))

    # intern patterns over classes (class order == first-occurrence order
    # over unique lines, so pattern ids match the per-line scan)
    pat_map: dict[str, int] = {}
    pat_list: list[str] = []
    cpid = np.empty(len(class_pat), np.int64)
    for j, p in enumerate(class_pat):
        pid = pat_map.get(p)
        if pid is None:
            pid = len(pat_list)
            pat_map[p] = pid
            pat_list.append(p)
        cpid[j] = pid
    upid = cpid[ginv]

    star_cols = [ustar[uu_inv, si].tolist() for si in range(n_stars)]
    return star_cols, pat_list, upid[uu_inv]
