"""Compressed-domain query engine: template-pushdown grep/extract over
logzip archives (DESIGN.md §11).

The paper archives logs *so they can be analyzed later* — yet a classic
archive answers every query by decompressing every line.  Because logzip
factors a corpus into a few hundred templates plus parameter columns,
most predicates can be decided against the templates instead of the
lines.  Queries run in three stages:

1. **Template classification** — each predicate is matched against the
   template set; every template (and hence every EventID) is classified
   ALWAYS-match (the predicate is implied by the template's literal
   tokens), NEVER-match (no instantiation of the template can satisfy
   it), or MAYBE (param-dependent).
2. **Chunk skipping** — LZJS chunks carry a footer-index *manifest*
   (``core.stream.chunk_manifest``): the chunk's EventIDs, its
   verbatim-line texts (when small) and per-header-field summaries.  A
   chunk whose manifest proves "no line here can match" is skipped
   without touching its payload.  LZJM batch archives have no manifest
   and degrade to sequential chunk visits (LZJF to a single chunk).
3. **Column-selective evaluation** — for MAYBE templates the engine
   decodes only the relevant ``ColumnCodec`` parameter columns
   (``ChunkReader.star_column``, distinct values only) and evaluates the
   predicate per *distinct* value; full lines are materialized only for
   final hits and for the rare rows no cheap rule decides.

Soundness: every shortcut is conservative.  ``search`` returns exactly
the (line_no, line) pairs a decompress-then-grep would — held against
the JAX package's engine and a plain-Python grep in
``tests/test_torch_query.py``.
"""

from __future__ import annotations

import io
import os
import re
from dataclasses import dataclass, field as dfield

import numpy as np

from ..kernels import ops as _kops
from .codec import ChunkReader, FILE_MAGIC, open_container
# the typed-column screens must apply EXACTLY the integer rules
# classification admits — one definition, imported
from .coltypes import INT_RE as _PARAM_INT_RE
from .coltypes import canonical_int as _canonical_int
from .coltypes import int_value_realizable as _int_value_realizable
from .tokenizer import DEFAULT_DELIMITERS, LogFormat

try:  # Python >= 3.11
    from re import _parser as _sre_parser
except ImportError:  # pragma: no cover - Python 3.10
    import sre_parse as _sre_parser

ALWAYS, MAYBE, NEVER = 1, 0, -1
_CLASS_NAMES = {ALWAYS: "always", MAYBE: "maybe", NEVER: "never"}

_DELIMS = frozenset(DEFAULT_DELIMITERS)
_WS = frozenset(" \t\n\r\x0b\x0c")
_DELIM_RUN_RE = re.compile(f"[{re.escape(DEFAULT_DELIMITERS)}]+")

__all__ = [
    "Substring", "Regex", "FieldEq", "LineRange", "EventIs", "ParamRange", "And",
    "QueryStats", "search", "count", "sample", "explain", "plan", "extract_records",
    "count_by_template", "top_k", "time_histogram",
    "classify_template", "ALWAYS", "MAYBE", "NEVER",
]


# ------------------------------------------------------------- predicates

@dataclass(frozen=True)
class Substring:
    """Fixed-string containment over the full rendered line."""

    s: str


@dataclass(frozen=True)
class Regex:
    """``re.search`` over the full rendered line."""

    pattern: str


@dataclass(frozen=True)
class FieldEq:
    """Header-field equality (lines that failed header parse never match)."""

    field: str
    value: str


@dataclass(frozen=True)
class LineRange:
    """Global line number in ``[start, stop)``."""

    start: int
    stop: int


@dataclass(frozen=True)
class EventIs:
    """Template (EventID) equality — session-global id for LZJS archives,
    chunk-local id otherwise. Verbatim/unmatched lines never match."""

    event: int


@dataclass(frozen=True)
class ParamRange:
    """Integer range predicate over one parameter column: lines matched to
    template ``event`` (session-global id for LZJS) whose star-``star``
    value parses as a decimal integer in ``[lo, hi)``. Values with
    non-digit decoration (``blk_`` prefixes, dots) never match; verbatim
    lines never match. Typed numeric columns (DESIGN.md §12) answer this
    from their manifest ``lo``/``hi`` bounds — chunks whose range cannot
    intersect are skipped without touching the payload."""

    event: int
    star: int
    lo: int
    hi: int


@dataclass(frozen=True)
class And:
    preds: tuple

    def __init__(self, *preds):
        object.__setattr__(self, "preds", tuple(preds))


def _flatten(query) -> list:
    if isinstance(query, And):
        out = []
        for p in query.preds:
            out.extend(_flatten(p))
        if not out:
            raise ValueError("empty conjunction")
        return out
    if isinstance(query, (Substring, Regex, FieldEq, LineRange, EventIs, ParamRange)):
        return [query]
    raise ValueError(f"not a query predicate: {query!r}")


# ------------------------------------------------- template classification

def _delim_free(s: str) -> bool:
    return not any(c in _DELIMS for c in s)


def _spanning_feasible(s: str, toks: list[str]) -> bool:
    """Can ``s`` (which contains delimiter chars) occur in a content whose
    token sequence is exactly ``toks`` (with arbitrary delimiter runs)?

    Splitting ``s`` on delimiter runs gives segments that must align with
    the token sequence: interior segments are complete tokens, the edge
    segments a token suffix / prefix (empty edges start or end inside a
    gap, which is always realizable since gaps are arbitrary)."""
    segs = _DELIM_RUN_RE.split(s)
    head, mid, tail = segs[0], segs[1:-1], segs[-1]
    m, k = len(toks), len(mid)
    for j in range(m - k + 1):
        if toks[j:j + k] != mid:
            continue
        if head and not (j > 0 and toks[j - 1].endswith(head)):
            continue
        if tail and not (j + k < m and toks[j + k].startswith(tail)):
            continue
        return True
    return False


def classify_template(s: str, template: tuple) -> int:
    """Classify substring ``s`` against one template's *content*.

    ALWAYS: every instantiation contains ``s`` (it sits inside a literal
    token). NEVER: no instantiation can contain it. MAYBE: depends on the
    parameter values (or, for delimiter-spanning strings, on the gaps).
    """
    toks = [t for t in template if t is not None]
    has_star = len(toks) < len(template)
    if _delim_free(s):
        if any(s in t for t in toks):
            return ALWAYS
        return MAYBE if has_star else NEVER
    if has_star:
        return MAYBE  # any wildcard can absorb arbitrary tokens
    return MAYBE if _spanning_feasible(s, toks) else NEVER


def _required_literals(pattern: str) -> list[str]:
    """Literal substrings every match of ``pattern`` must contain
    (conservative: [] when nothing can be guaranteed). Literal runs are
    split on delimiter characters — each delimiter-free fragment is still
    required, and delimiter-free needles get the strongest pushdown
    (token containment + the param-dictionary screen)."""
    try:
        parsed = _sre_parser.parse(pattern)
    except Exception:
        return []
    if parsed.state.flags & re.IGNORECASE:
        return []
    lits: list[str] = []
    bail = False

    def walk(data) -> None:
        nonlocal bail
        run: list[str] = []

        def flush():
            if run:
                lits.append("".join(run))
                run.clear()

        for op, av in data:
            name = str(op)
            if name == "LITERAL":
                run.append(chr(av))
            elif name == "SUBPATTERN":
                flush()
                # av = (group, add_flags, del_flags, subpattern): a scoped
                # (?i:...) carries IGNORECASE here, not in state.flags
                if av[1] & re.IGNORECASE:
                    bail = True
                    return
                walk(av[3])
            elif name in ("MAX_REPEAT", "MIN_REPEAT"):
                flush()
                if av[0] >= 1:
                    walk(av[2])
            else:
                # BRANCH / IN / ANY / AT / assertions: nothing guaranteed
                flush()
        flush()

    walk(parsed)
    if bail:
        return []
    out: list[str] = []
    for l in lits:
        out.extend(f for f in _DELIM_RUN_RE.split(l) if f)
    return out


# -------------------------------------------------- header-format analysis

def _format_groups(fmt: LogFormat):
    """Whitespace-free run structure of a rendered line.

    Returns (header_groups, boundary_safe): each group is the list of
    items — ("lit", text) / ("field", name) — forming one maximal
    whitespace-free run of the rendered line; groups containing the
    content field are dropped. ``boundary_safe`` is True when the content
    field forms a run on its own, i.e. a whitespace-free needle can never
    straddle the header/content boundary."""
    items: list[tuple] = []
    segs = fmt._segments
    if segs[0]:
        items.append(("lit", segs[0]))
    for f, seg in zip(fmt.fields, segs[1:]):
        items.append(("content",) if f == fmt.content_field else ("field", f))
        if seg:
            items.append(("lit", seg))
    groups: list[list] = []
    cur: list = []
    for it in items:
        if it[0] == "lit":
            parts = re.split(r"\s+", it[1])
            if len(parts) == 1:
                cur.append(it)
                continue
            if parts[0]:
                cur.append(("lit", parts[0]))
            groups.append(cur)
            for midpart in parts[1:-1]:
                if midpart:
                    groups.append([("lit", midpart)])
            cur = [("lit", parts[-1])] if parts[-1] else []
        else:
            cur.append(it)
    groups.append(cur)
    groups = [g for g in groups if g]
    header_groups = []
    boundary_safe = True
    for g in groups:
        if any(it[0] == "content" for it in g):
            if len(g) > 1:
                boundary_safe = False
        else:
            header_groups.append(g)
    return header_groups, boundary_safe


def _header_possible_static(s: str, fields_mf: dict, ctx: "_Ctx") -> bool:
    """Could ``s`` (whitespace-free) occur inside the header region of
    some line of a chunk, judging only by the chunk's per-field manifest
    summaries? Conservative: True whenever unsure."""
    for g in ctx.header_groups:
        fnames = [it[1] for it in g if it[0] == "field"]
        lits = [it[1] if it[0] == "lit" else None for it in g]
        if len(fnames) == 1:
            entry = fields_mf.get(fnames[0]) or {}
            vals = entry.get("v")
            if vals is not None:
                assembled = ["".join(v if t is None else t for t in lits)
                             for v in vals]
                if any(s in a for a in assembled):
                    return True
                continue
        charset = set()
        unknown = False
        for it in g:
            if it[0] == "lit":
                charset |= set(it[1])
                continue
            entry = fields_mf.get(it[1]) or {}
            if entry.get("v") is not None:
                charset |= set("".join(entry["v"]))
            elif entry.get("c") is not None:
                charset |= set(entry["c"])
            else:
                unknown = True
                break
        if unknown or all(c in charset for c in s):
            return True
    return False


# --------------------------------------------------------------- context

_ALNUM_RUN_RE = re.compile(r"[0-9A-Za-z]+")
# Bloom-screen edge runs scan the whole ParamDict for containment; a run
# matching more candidates than this decides nothing (common fragment).
_CAND_MAX = 64


class _Ctx:
    """Per-query, per-archive evaluation state (caches + format info)."""

    def __init__(self, fmt: LogFormat | None, session_templates=None,
                 session_params=None, screens_meta: dict | None = None):
        self.fmt = fmt
        self.session_templates = session_templates  # global tuples (LZJS)
        self.session_params = session_params        # level-3 ParamDict values
        if fmt is not None:
            self.header_groups, self.boundary_safe = _format_groups(fmt)
        else:
            self.header_groups, self.boundary_safe = [], True
        self._cls: dict[tuple, int] = {}
        self._contains: dict[tuple, bool] = {}
        self._lits: dict[str, list[str]] = {}
        self._param_first: dict[str, int] | None = None
        self._thr: dict[str, int | None] = {}
        # footer screens meta (DESIGN.md §14): the set of ParaIDs the
        # per-chunk Bloom filters cover, and the alnum-run length floor
        self.screen_cold: frozenset | None = None
        self.screen_minrun = 0
        if screens_meta and session_params is not None:
            self.screen_cold = frozenset(screens_meta.get("cold") or ())
            self.screen_minrun = int(screens_meta.get("minrun", 0)) or 10 ** 9
        self._params_complete: bool | None = None
        self._cand: dict[str, tuple | None] = {}

    def _first_map(self) -> dict:
        if self._param_first is None:
            first: dict = {}
            for i, v in enumerate(self.session_params):
                first.setdefault(v, i)
            self._param_first = first
        return self._param_first

    @property
    def params_complete(self) -> bool:
        """False when any ParamDict entry is unknown (salvage padding) —
        the Bloom screens then cannot name a needle's candidate ids."""
        if self._params_complete is None:
            self._params_complete = all(
                v is not None for v in (self.session_params or ()))
        return self._params_complete

    def screen_candidates(self, s: str):
        """Per alnum-run candidate ParaID sets for delimiter-free ``s``
        against the chunk Bloom screens: a tuple of id-tuples, one per
        run of length >= the screen ``minrun`` (shorter runs were never
        inserted and decide nothing). An interior run must be an exact
        dictionary member; an edge run any member containing it — edge
        scans are capped at ``_CAND_MAX`` candidates (beyond that the run
        is dropped as undecidable). ``None`` = screens unusable for ``s``."""
        if (self.screen_cold is None or self.session_params is None
                or not self.params_complete):
            return None
        if s in self._cand:
            return self._cand[s]
        params = self.session_params
        out: list[tuple] = []
        for m in _ALNUM_RUN_RE.finditer(s):
            run = m.group()
            if len(run) < self.screen_minrun:
                continue
            if m.start() > 0 and m.end() < len(s):
                pid = self._first_map().get(run)
                out.append(() if pid is None else (pid,))
                continue
            cands: list[int] = []
            for j, v in enumerate(params):
                if run in v:
                    cands.append(j)
                    if len(cands) > _CAND_MAX:
                        break
            if len(cands) <= _CAND_MAX:
                out.append(tuple(cands))
        res = tuple(out) if out else None
        self._cand[s] = res
        return res

    def classify(self, s: str, template) -> int:
        key = (s, tuple(template))
        c = self._cls.get(key)
        if c is None:
            c = classify_template(s, key[1])
            self._cls[key] = c
        return c

    def contains(self, s: str, value: str) -> bool:
        key = (s, value)
        c = self._contains.get(key)
        if c is None:
            c = s in value
            self._contains[key] = c
        return c

    def required_literals(self, pattern: str) -> list[str]:
        lits = self._lits.get(pattern)
        if lits is None:
            lits = _required_literals(pattern)
            self._lits[pattern] = lits
        return lits

    def param_threshold(self, s: str):
        """Smallest session-ParamDict length at which ``s`` could occur
        inside a level-3 parameter value; None if it never can.

        A Level-3 star value is its alphanumeric runs (each interned in
        the session ``ParamDict``) joined by non-alphanumeric connectors,
        so ``s`` can only appear in one if every interior alphanumeric
        run of ``s`` is an exact dictionary value and its edge runs are
        substrings of dictionary values. The first dictionary index where
        that holds bounds which chunks (via their ``pd_end``) can realize
        ``s`` — chunks written before the needle's parts existed are
        skipped (the CLP-style dictionary screen, per chunk)."""
        if self.session_params is None:
            return 0  # no dictionary to consult: possible everywhere
        if s in self._thr:
            return self._thr[s]
        params = self.session_params
        runs = list(_ALNUM_RUN_RE.finditer(s))
        thr: int | None = 0
        for m in runs:
            run = m.group()
            if m.start() > 0 and m.end() < len(s):
                i = self._first_map().get(run)  # complete part: exact member
            else:
                i = next((j for j, v in enumerate(params) if run in v), None)
            if i is None:
                thr = None
                break
            thr = max(thr, i + 1)
        self._thr[s] = thr
        return thr


# ------------------------------------------------------------- evaluation
#
# Per chunk every conjunct produces a tri-state vector over the chunk's
# lines: 1 = provably matches, -1 = provably not, 0 = unknown.  The
# conjunction is the elementwise minimum.  Rows left at 0 are resolved by
# materializing the line and running the exact predicate — so every
# shortcut above only has to be *conservative*, never exact.


def _tri_substring(pred: Substring, ctx: _Ctx, cr: ChunkReader,
                   manifest: dict | None) -> np.ndarray:
    s = pred.s
    n = cr.n
    tri = np.zeros(n, np.int8)
    for pos, txt in zip(cr.bad_pos, cr.bad_txt):
        tri[pos] = 1 if s in txt else -1
    if cr.n_ok == 0:
        return tri

    ws_free = not any(c in _WS for c in s)
    exact_split = ctx.fmt is None or (ws_free and ctx.boundary_safe)

    # header side: decode only when the manifest cannot rule it out
    hdr_hit = None
    if ctx.fmt is not None:
        hdr_needed = True
        if manifest is not None and ws_free and ctx.boundary_safe:
            hdr_needed = _header_possible_static(
                s, manifest.get("fields") or {}, ctx)
        if hdr_needed and exact_split:
            pre, post = cr.header_affixes()
            hdr_hit = np.fromiter(
                ((s in pre[r]) or (s in post[r]) for r in range(cr.n_ok)),
                bool, count=cr.n_ok)
        elif not hdr_needed:
            hdr_hit = np.zeros(cr.n_ok, bool)
        # else: header undecidable per-row -> rows stay UNKNOWN below

    # content side per ok row: +1 / -1 / 0
    content = np.zeros(cr.n_ok, np.int8)
    if cr.level < 2:
        for r in range(cr.n_ok):
            content[r] = 1 if ctx.contains(s, cr.content(r)) else -1
    else:
        un = cr.un_rows
        if len(un):
            content[un] = [1 if ctx.contains(s, t) else -1 for t in cr.un_txt]
        matched = cr.matched_rows
        events = cr.events
        for k in np.unique(events).tolist() if len(events) else []:
            tpl = tuple(cr.templates[k])
            cls = ctx.classify(s, tpl)
            rows_m = cr.template_rows(k)
            rows = matched[rows_m]
            if cls == ALWAYS:
                content[rows] = 1
            elif cls == NEVER:
                content[rows] = -1
            elif _delim_free(s):
                # param pushdown: a delimiter-free needle can only live
                # inside a token, i.e. inside some wildcard's value here
                hit = np.zeros(len(rows_m), bool)
                n_stars = sum(1 for t in tpl if t is None)
                for si in range(n_stars):
                    uniq, inv = cr.star_column(k, si)
                    uhit = np.fromiter((ctx.contains(s, u) for u in uniq),
                                       bool, count=len(uniq))
                    hit |= uhit[inv]
                content[rows] = np.where(hit, 1, -1).astype(np.int8)
            # else: gap-dependent -> leave 0 (resolved by materialization)

    ok_tri = np.zeros(cr.n_ok, np.int8)
    if ctx.fmt is None:
        ok_tri = content
    elif hdr_hit is not None and exact_split:
        ok_tri = np.where(hdr_hit | (content == 1), 1,
                          np.where(content == -1, -1, 0)).astype(np.int8)
    else:
        ok_tri = np.where(content == 1, 1, 0).astype(np.int8)
    tri[cr.ok_pos] = ok_tri
    return tri


def _tri_regex(pred: Regex, rx, ctx: _Ctx, cr: ChunkReader,
               manifest: dict | None) -> np.ndarray:
    tri = np.zeros(cr.n, np.int8)
    for pos, txt in zip(cr.bad_pos, cr.bad_txt):
        tri[pos] = 1 if rx.search(txt) else -1
    # required literals prune rows; survivors stay UNKNOWN (re.search on
    # the materialized line decides them)
    for lit in ctx.required_literals(pred.pattern):
        lt = _tri_substring(Substring(lit), ctx, cr, manifest)
        tri[(lt == -1) & (tri == 0)] = -1
    return tri


def _tri_field_eq(pred: FieldEq, ctx: _Ctx, cr: ChunkReader) -> np.ndarray:
    tri = np.full(cr.n, -1, np.int8)
    if cr.n_ok:
        col = cr.header_column(pred.field)
        eq = np.fromiter((v == pred.value for v in col), bool, count=cr.n_ok)
        tri[cr.ok_pos] = np.where(eq, 1, -1).astype(np.int8)
    return tri


def _tri_event_is(pred: EventIs, cr: ChunkReader) -> np.ndarray:
    tri = np.full(cr.n, -1, np.int8)
    if cr.level >= 2 and len(cr.events):
        used = cr.used_global
        ev = cr.events if used is None else np.asarray(used, np.int64)[cr.events]
        rows = cr.ok_pos[cr.matched_rows]
        tri[rows] = np.where(ev == pred.event, 1, -1).astype(np.int8)
    return tri


def _tri_param_range(pred: ParamRange, cr: ChunkReader) -> np.ndarray:
    tri = np.full(cr.n, -1, np.int8)
    if cr.level < 2 or not len(cr.events):
        return tri
    used = cr.used_global
    for k in np.unique(cr.events).tolist():
        gid = used[k] if used is not None else k
        if gid != pred.event:
            continue
        tpl = cr.templates[k]
        n_stars = sum(1 for t in tpl if t is None)
        if pred.star >= n_stars:
            continue  # no such column: rows stay NEVER
        rows = cr.ok_pos[cr.matched_rows[cr.template_rows(k)]]
        uniq, inv = cr.star_column(k, pred.star)
        ok = np.fromiter(
            (bool(_PARAM_INT_RE.match(u)) and pred.lo <= int(u) < pred.hi
             for u in uniq), bool, count=len(uniq))
        tri[rows] = np.where(ok[inv], 1, -1).astype(np.int8)
    return tri


def _tri_line_range(pred: LineRange, cr: ChunkReader, line_start: int) -> np.ndarray:
    nos = line_start + np.arange(cr.n)
    return np.where((nos >= pred.start) & (nos < pred.stop), 1, -1).astype(np.int8)


def _chunk_tri(pred, ctx: _Ctx, cr: ChunkReader, line_start: int,
               manifest: dict | None) -> np.ndarray:
    if isinstance(pred, Substring):
        return _tri_substring(pred, ctx, cr, manifest)
    if isinstance(pred, Regex):
        return _tri_regex(pred, re.compile(pred.pattern), ctx, cr, manifest)
    if isinstance(pred, FieldEq):
        return _tri_field_eq(pred, ctx, cr)
    if isinstance(pred, EventIs):
        return _tri_event_is(pred, cr)
    if isinstance(pred, ParamRange):
        return _tri_param_range(pred, cr)
    if isinstance(pred, LineRange):
        return _tri_line_range(pred, cr, line_start)
    raise ValueError(f"unknown predicate {pred!r}")


def _test_line(pred, line: str, line_no: int) -> bool:
    """Exact oracle on a fully materialized line (UNKNOWN resolution)."""
    if isinstance(pred, Substring):
        return pred.s in line
    if isinstance(pred, Regex):
        return re.search(pred.pattern, line) is not None
    if isinstance(pred, LineRange):
        return pred.start <= line_no < pred.stop
    raise RuntimeError(f"{type(pred).__name__} decides exactly; no oracle needed")


# ----------------------------------------------------- chunk-level pruning

_DIGIT_SET = frozenset("0123456789")


def _int_needle_screen(e: dict, s: str):
    """Sharp screen for a needle against one integer-family typed column:
    True = provably realizable, False = provably not, None = undecided
    (fall back to the character-set reasoning).

    Only needles that can ONLY match as a column value's *complete*
    rendered core are decided: ``s`` must carry the column's full prefix,
    the remainder must be a canonically-rendered integer of the column's
    maximum rendered width (a wider core cannot exist, so a full-width
    digit run aligns with a whole core or not at all). Those needles are
    bounds-tested against the column's manifest ``lo``/``hi``. Wide
    stream-global ids stay in the TEXT layout for sessions
    (``coltypes.WIDE_INT_TEXT``), so rare-id point queries keep the full
    ParamDict watermark screen."""
    pre, suf = e.get("pre", ""), e.get("suf", "")
    # digit (or sign) chars inside the affixes break the alignment
    # argument — a digit run could straddle the core/affix boundary
    if any(c in _DIGIT_SET or c == "-" for c in pre + suf):
        return None
    if not s.startswith(pre):
        return None
    rest = s[len(pre):]
    if not rest or not _PARAM_INT_RE.match(rest):
        return None
    w = e.get("w")
    if w:
        if rest.startswith("-") or len(rest) != w:
            return None
    else:
        maxw = max(len(str(e["lo"])), len(str(e["hi"])))
        if not _canonical_int(rest) or len(rest) != maxw:
            return None
    v = int(rest)
    return e["lo"] <= v <= e["hi"]


def _typed_realizable(s: str, manifest: dict) -> bool:
    """Could a typed *star* column of this chunk realize needle ``s``?

    Typed values bypass the level-3 ParamDict, so the dictionary screen
    must also clear the chunk's ``tcol`` summaries before ruling it out.
    Character-set reasoning only (order-free), hence conservative: True
    whenever unsure. Header columns (``h.*`` keys) are excluded — the
    header region is screened by the field summaries."""
    tcol = manifest.get("tcol")
    if tcol is None:
        # null = typed columns present but unsummarized; key absent = v1
        # chunk, nothing bypassed the ParamDict
        return "tcol" in manifest
    for key, e in tcol.items():
        if not key.startswith("g"):
            continue
        if "u" in e:
            return True
        chars = set(e.get("pre", "")) | set(e.get("suf", ""))
        t = e["t"]
        if t == "dict":
            vals = e.get("v")
            if vals is not None:
                if any(s in v for v in vals):
                    return True
                continue
            cs = e.get("c")
            if cs is None:
                return True
            chars |= set(cs)
        elif t == "ip_hex":
            chars |= set("0123456789ABCDEF" if e.get("upper") else
                         "0123456789abcdef") if e.get("hex") else set("0123456789.")
        else:  # integer family
            sharp = _int_needle_screen(e, s)
            if sharp is not None:
                if sharp:
                    return True
                continue  # provably not a value of this column
            chars |= _DIGIT_SET
            if e.get("lo", 0) < 0:
                chars.add("-")
        if all(c in chars for c in s):
            return True
    return False


def _param_range_possible(pred: "ParamRange", manifest: dict) -> bool:
    used = manifest.get("used")
    if used is not None and pred.event not in used:
        return False
    tcol = manifest.get("tcol")
    e = (tcol or {}).get(f"g{pred.event}.s{pred.star}")
    if not e or "u" in e:
        return True
    if e.get("pre") or e.get("suf"):
        return False  # decorated values never parse as integers
    if "lo" in e:  # integer family: manifest bounds decide for free
        return e["lo"] < pred.hi and e["hi"] >= pred.lo
    if e["t"] == "dict" and "v" in e:
        return any(_PARAM_INT_RE.match(v) and pred.lo <= int(v) < pred.hi
                   for v in e["v"])
    if e["t"] == "ip_hex":
        return False  # dots / hex letters never parse as integers
    return True


def _reason(outcome, kind: str) -> bool:
    """Record why a chunk was pruned; returns False for use at skip sites."""
    if outcome is not None:
        outcome.setdefault("reason", kind)
    return False


def _screen_passes(ctx: _Ctx, s: str, manifest: dict, screen, outcome) -> bool:
    """May this chunk realize delimiter-free needle ``s`` through its
    level-3 parameter values, judged by the chunk's Bloom screen? False
    only on proof: every candidate id of some alnum run is either not yet
    interned at this chunk (``>= pd_end``), or cold and rejected by the
    chunk's split-block Bloom filter. Intro ids (``[pd_base, pd_end)``)
    and hot ids pass without probing — they are referenced by many chunks
    and were never inserted into the per-chunk filters."""
    cand_sets = ctx.screen_candidates(s)
    if cand_sets is None:
        return True
    pd_base = manifest.get("_pd_base", 0)
    pd_end = manifest.get("_pd_end")
    if pd_end is None:
        return True
    sc = False  # lazily loaded; False = not yet, None = load failed
    for cands in cand_sets:
        run_ok = False
        for c in cands:
            if c >= pd_end:
                continue  # id interned after this chunk: cannot appear
            if c >= pd_base or c not in ctx.screen_cold:
                run_ok = True  # intro or hot id: assumed present
                break
            if sc is False:
                sc = screen() if screen is not None else None
            if sc is None or sc.param is None:
                run_ok = True
                break
            if outcome is not None:
                outcome["bloom_probes"] = outcome.get("bloom_probes", 0) + 1
            if sc.may_contain_param(c):
                if outcome is not None:
                    outcome["bloom_passes"] = outcome.get("bloom_passes", 0) + 1
                run_ok = True
                break
        if not run_ok:
            return False
    return True


def _chunk_possible(pred, ctx: _Ctx, manifest: dict | None,
                    line_start: int, n_lines: int | None,
                    screen=None, outcome: dict | None = None) -> bool:
    """May any line of this chunk satisfy ``pred``?  Judged WITHOUT
    touching the chunk payload; conservative True when unsure.
    ``screen`` is a zero-arg loader for the chunk's Bloom screen (or
    None); ``outcome``, when given, collects the skip reason and Bloom
    probe counts for ``QueryStats``."""
    if isinstance(pred, LineRange):
        if n_lines is None:
            return True
        return (line_start < pred.stop and line_start + n_lines > pred.start) \
            or _reason(outcome, "line_range")
    if not manifest:
        return True
    if isinstance(pred, And):  # pragma: no cover - flattened upstream
        return all(_chunk_possible(p, ctx, manifest, line_start, n_lines,
                                   screen, outcome)
                   for p in pred.preds)
    if isinstance(pred, FieldEq):
        entry = (manifest.get("fields") or {}).get(pred.field) or {}
        vals = entry.get("v")
        if vals is not None:
            return pred.value in vals or _reason(outcome, "field_values")
        cs = entry.get("c")
        if cs is not None and any(c not in cs for c in pred.value):
            return _reason(outcome, "field_charset")
        e = (manifest.get("tcol") or {}).get(f"h.{pred.field}")
        if e:
            if "lo" in e and not _int_value_realizable(e, pred.value):
                return _reason(outcome, "field_bounds")
            if e.get("t") == "dict" and "v" in e and pred.value not in e["v"]:
                return _reason(outcome, "field_values")
        if screen is not None:
            sc = screen()
            if sc is not None and \
                    sc.field_may_contain(pred.field, pred.value) is False:
                return _reason(outcome, "field_bloom")
        return True
    if isinstance(pred, EventIs):
        used = manifest.get("used")
        return used is None or pred.event in used or _reason(outcome, "event")
    if isinstance(pred, ParamRange):
        return _param_range_possible(pred, manifest) \
            or _reason(outcome, "param_range")
    if isinstance(pred, Regex):
        return all(_chunk_possible(Substring(l), ctx, manifest, line_start,
                                   n_lines, screen, outcome)
                   for l in ctx.required_literals(pred.pattern))
    if isinstance(pred, Substring):
        s = pred.s
        if manifest.get("nv", 1):
            vb = manifest.get("verbatim")
            if vb is None or any(s in t for t in vb):
                return True
        used = manifest.get("used")
        if used is None or ctx.session_templates is None:
            return True
        tpls = ctx.session_templates
        pd_end = manifest.get("_pd_end")
        bloom_used = False
        for g in used:
            if g >= len(tpls):
                return True
            cls = ctx.classify(s, tpls[g])
            if cls == NEVER:
                continue
            if cls == MAYBE and _delim_free(s) and pd_end is not None:
                # wildcards can only realize s through level-3 param
                # values; the dictionary screen bounds which chunks can,
                # and the per-chunk Bloom screen refines it to the chunks
                # that actually reference the needle's (cold) ids. Typed
                # columns (v2) bypass the ParamDict, so their manifest
                # summaries must also fail to realize s.
                thr = ctx.param_threshold(s)
                ruled_out = thr is None or pd_end < thr
                if not ruled_out and \
                        not _screen_passes(ctx, s, manifest, screen, outcome):
                    ruled_out = bloom_used = True
                if ruled_out and not _typed_realizable(s, manifest):
                    continue
            return True
        if ctx.fmt is None:
            return _reason(outcome, "param_bloom" if bloom_used else "template")
        if any(c in _WS for c in s) or not ctx.boundary_safe:
            return True
        return _header_possible_static(s, manifest.get("fields") or {}, ctx) \
            or _reason(outcome, "param_bloom" if bloom_used else "template")
    return True


# ------------------------------------------------ manifest-only counting

def _header_static_impossible(s: str, ctx: _Ctx, manifest: dict) -> bool:
    """Can we prove ``s`` never occurs inside (or straddling) the header
    region of any parsed line of this chunk?"""
    if ctx.fmt is None:
        return True  # no header region exists
    if any(c in _WS for c in s) or not ctx.boundary_safe:
        return False
    return not _header_possible_static(s, manifest.get("fields") or {}, ctx)


def _fast_substring_class(s: str, tpl: tuple, ctx: _Ctx, manifest: dict) -> int:
    """``classify`` sharpened by the chunk's dictionary watermark and
    typed-column summaries: MAYBE becomes NEVER when no parameter value
    of this chunk can realize ``s``."""
    cls = ctx.classify(s, tpl)
    pd_end = manifest.get("_pd_end")
    if cls == MAYBE and _delim_free(s) and pd_end is not None:
        thr = ctx.param_threshold(s)
        if (thr is None or pd_end < thr) and not _typed_realizable(s, manifest):
            return NEVER
    return cls


def _fast_group(preds, ctx: _Ctx, manifest: dict, gid: int,
                line_start: int, n_lines: int | None):
    """Uniform conjunction verdict for every row matched to session
    template ``gid``: True (all rows hit), False (no row hits), None
    (rows differ / undecidable from the manifest)."""
    tpls = ctx.session_templates
    if gid >= len(tpls):
        return None
    tpl = tpls[gid]
    fields_mf = manifest.get("fields") or {}
    undecided = False
    for p in preds:
        if isinstance(p, EventIs):
            if p.event != gid:
                return False
        elif isinstance(p, LineRange):
            if n_lines is None:
                undecided = True
            elif line_start >= p.stop or line_start + n_lines <= p.start:
                return False
            elif not (p.start <= line_start and line_start + n_lines <= p.stop):
                undecided = True
        elif isinstance(p, ParamRange):
            if p.event != gid:
                return False
            if not _param_range_possible(p, manifest):
                return False
            undecided = True
        elif isinstance(p, FieldEq):
            entry = fields_mf.get(p.field) or {}
            vals = entry.get("v")
            if vals is not None:
                if p.value not in vals:
                    return False
                if len(vals) == 1:
                    continue  # single distinct value: every parsed row hits
                undecided = True
                continue
            cs = entry.get("c")
            if cs is not None and any(c not in cs for c in p.value):
                return False
            e = (manifest.get("tcol") or {}).get(f"h.{p.field}")
            if e and "lo" in e and not _int_value_realizable(e, p.value):
                return False
            undecided = True
        elif isinstance(p, Substring):
            cls = _fast_substring_class(p.s, tpl, ctx, manifest)
            if cls == ALWAYS:
                continue
            if cls == NEVER and _header_static_impossible(p.s, ctx, manifest):
                return False
            undecided = True
        elif isinstance(p, Regex):
            hit_never = False
            for lit in ctx.required_literals(p.pattern):
                if _fast_substring_class(lit, tpl, ctx, manifest) == NEVER \
                        and _header_static_impossible(lit, ctx, manifest):
                    hit_never = True
                    break
            if hit_never:
                return False
            undecided = True
        else:  # pragma: no cover - predicate set is closed
            undecided = True
    return None if undecided else True


def _fast_verbatim_text(preds, ctx: _Ctx, manifest: dict, t: str,
                        line_start: int, n_lines: int | None):
    """Verdict for one verbatim row given only its text — conservative
    because the manifest does not say whether ``t`` is a full bad line or
    an unmatched *content* (whose header was parsed away)."""
    undecided = False
    for p in preds:
        if isinstance(p, (EventIs, ParamRange)):
            return False  # verbatim rows are not template instances
        if isinstance(p, LineRange):
            if n_lines is None:
                undecided = True
            elif line_start >= p.stop or line_start + n_lines <= p.start:
                return False
            elif not (p.start <= line_start and line_start + n_lines <= p.stop):
                undecided = True
        elif isinstance(p, FieldEq):
            vals = ((manifest.get("fields") or {}).get(p.field) or {}).get("v")
            if vals is not None and p.value not in vals:
                return False  # no parsed row (unmatched included) has it
            undecided = True  # bad lines never match, unmatched rows may
        elif isinstance(p, Substring):
            if p.s in t:
                continue  # content ⊆ line and bad text = line: either way a hit
            if _header_static_impossible(p.s, ctx, manifest):
                return False  # not in text, provably not via the header
            undecided = True
        else:  # Regex: searching a content for a full-line pattern is unsound
            undecided = True
    return None if undecided else True


def _count_fast_chunk(preds, ctx: _Ctx, manifest: dict,
                      line_start: int, n_lines: int | None):
    """Exact hit count for this chunk from its manifest alone (EventID
    histogram ``ec`` + verbatim texts), or None when any row's verdict
    needs the payload. Sound: a None falls back to normal evaluation."""
    if ctx.session_templates is None:
        return None
    used, ec = manifest.get("used"), manifest.get("ec")
    if used is None or ec is None or len(ec) != len(used):
        return None
    nv = manifest.get("nv", 0)
    if n_lines is not None and sum(ec) + nv != n_lines:
        return None  # foreign/stale manifest: never trust it silently
    total = 0
    for gid, cnt in zip(used, ec):
        r = _fast_group(preds, ctx, manifest, gid, line_start, n_lines)
        if r is None:
            return None
        if r:
            total += cnt
    if nv and not any(isinstance(p, (EventIs, ParamRange)) for p in preds):
        vb = manifest.get("verbatim")
        if vb is None or len(vb) != nv:
            return None
        for t in vb:
            r = _fast_verbatim_text(preds, ctx, manifest, t,
                                    line_start, n_lines)
            if r is None:
                return None
            if r:
                total += 1
    return total


# --------------------------------------------------------------- archives

class _ArchiveChunks:
    """Uniform chunk iteration over LZJF / LZJM / LZJS sources.

    ``salvage=True`` (LZJS only) opens the container through the
    scan-rebuilt index, so queries keep working over the surviving
    chunks of a damaged archive. Quarantined chunks are skipped in
    either mode — same semantics as ``LZJSReader.read_range``."""

    def __init__(self, src, *, salvage: bool = False):
        self.salvage = salvage
        self.reader = None
        blob = None
        if isinstance(src, (bytes, bytearray, memoryview)):
            blob = bytes(src)
            magic = blob[:4]
        elif isinstance(src, (str, os.PathLike)):
            with open(src, "rb") as f:
                magic = f.read(4)
            if magic != b"LZJS":
                with open(src, "rb") as f:
                    blob = f.read()
        else:
            raise ValueError(f"src must be bytes or a path, got {type(src)!r}")
        self.kind = {b"LZJS": "lzjs", b"LZJM": "lzjm", FILE_MAGIC: "lzjf"}.get(
            bytes(magic))
        if self.kind is None:
            raise ValueError(
                f"not a logzip archive: magic {bytes(magic)!r} "
                f"(expected {FILE_MAGIC!r}, b'LZJM' or b'LZJS')")
        if self.kind == "lzjs":
            from .stream import LZJSReader

            self.reader = LZJSReader(io.BytesIO(blob) if blob is not None else src,
                                     salvage=salvage)
            self.fmt_str = self.reader.footer.get("format")
            self.session_templates = [tuple(t) for t in self.reader.templates]
            self.session_params = (self.reader.params
                                   if self.reader.footer.get("level") == 3 else None)
            self.n_lines = self.reader.n_lines
            self.screens_meta = self.reader.footer.get("screens")
        else:
            if self.kind == "lzjm":
                from .parallel import iter_multi_chunks

                self.blobs = list(iter_multi_chunks(blob))
            else:
                self.blobs = [blob]
            self.session_templates = None
            self.session_params = None
            self.n_lines = None
            self.fmt_str = None
            self.screens_meta = None
            if self.blobs:
                # format comes from the first chunk's meta (uniform across
                # an archive written by this codebase)
                _, meta0 = open_container(self.blobs[0])
                self.fmt_str = meta0.get("format")

    def chunks(self):
        """Yield (index, line_start, n_lines | None, manifest | None, open_fn,
        screen_fn | None). ``screen_fn`` lazily loads the chunk's SCRN
        frame (``None`` when the archive carries no screens)."""
        if self.kind == "lzjs":
            rd = self.reader
            for k, e in enumerate(rd.index):
                if e.get("q"):
                    continue  # quarantined: its lines are reported lost
                mf = rd.manifest(k)
                if mf:
                    mf = dict(mf)
                    mf["_pd_base"] = e.get("pd_base", 0)
                    mf["_pd_end"] = e.get("pd_base", 0) + e.get("pd_delta", 0)
                screen_fn = (lambda k=k: rd.screen(k)) if "sc" in e else None
                yield (k, e["line_start"], e["n_lines"], mf,
                       lambda k=k: rd.chunk_reader(k), screen_fn)
        else:
            line_start = 0
            for k, blob in enumerate(self.blobs):
                def open_fn(blob=blob, k=k):
                    try:
                        objects, meta = open_container(blob)
                        return ChunkReader(objects, meta)
                    except ValueError:
                        raise
                    except Exception as e:
                        raise ValueError(
                            f"truncated or corrupt logzip chunk {k}: {e}") from e
                cr = open_fn()
                yield (k, line_start, cr.n, None, lambda cr=cr: cr, None)
                line_start += cr.n

    def close(self):
        if self.reader is not None:
            self.reader.close()


# ------------------------------------------------------------- public API

@dataclass
class QueryStats:
    """Work accounting for one query execution.

    ``chunks_skipped_by`` breaks the skips down by the screen that fired
    (``template``, ``param_bloom``, ``field_values``, ``field_charset``,
    ``field_bounds``, ``field_bloom``, ``event``, ``param_range``,
    ``line_range``). ``bloom_probes``/``bloom_passes`` count per-chunk
    Bloom-filter tests; ``bloom_false_positives`` the chunks a Bloom pass
    opened that held no hit (observed FPP = fp / passes).
    ``chunks_counted_from_manifest`` are chunks ``count`` resolved from
    their manifest EventID histogram without opening."""

    chunks_total: int = 0
    chunks_skipped: int = 0
    chunks_opened: int = 0
    rows_materialized: int = 0
    hits: int = 0
    template_classes: dict = dfield(default_factory=dict)
    chunks_skipped_by: dict = dfield(default_factory=dict)
    bloom_probes: int = 0
    bloom_passes: int = 0
    bloom_false_positives: int = 0
    chunks_counted_from_manifest: int = 0

    @property
    def fraction_chunks_decoded(self) -> float:
        return self.chunks_opened / max(self.chunks_total, 1)


def _validate_preds(preds, fmt) -> None:
    for p in preds:
        if isinstance(p, FieldEq):
            if fmt is None:
                raise ValueError("field predicate on an archive without a header format")
            if p.field not in fmt.fields or p.field == fmt.content_field:
                raise ValueError(f"unknown header field {p.field!r} "
                                 f"(format has {fmt.fields})")
        elif isinstance(p, Regex):
            # validate up front — inside the chunk loop a re.error
            # would masquerade as a corrupt-archive ValueError
            try:
                re.compile(p.pattern)
            except re.error as e:
                raise ValueError(f"invalid regex {p.pattern!r}: {e}") from e


def _execute(src, query, stats: QueryStats, *, want_lines: bool = True,
             salvage: bool = False, count_from_manifest: bool = False):
    preds = _flatten(query)
    arch = _ArchiveChunks(src, salvage=salvage)
    try:
        fmt = LogFormat(arch.fmt_str) if arch.fmt_str else None
        ctx = _Ctx(fmt, arch.session_templates, arch.session_params,
                   arch.screens_meta)
        _validate_preds(preds, fmt)
        for k, line_start, n_lines, manifest, open_fn, screen_fn in arch.chunks():
            stats.chunks_total += 1
            outcome: dict = {}
            possible = all(_chunk_possible(p, ctx, manifest, line_start,
                                           n_lines, screen_fn, outcome)
                           for p in preds)
            stats.bloom_probes += outcome.get("bloom_probes", 0)
            stats.bloom_passes += outcome.get("bloom_passes", 0)
            if not possible:
                stats.chunks_skipped += 1
                r = outcome.get("reason", "other")
                stats.chunks_skipped_by[r] = stats.chunks_skipped_by.get(r, 0) + 1
                continue
            if count_from_manifest and manifest:
                cn = _count_fast_chunk(preds, ctx, manifest, line_start, n_lines)
                if cn is not None:
                    stats.chunks_counted_from_manifest += 1
                    stats.hits += cn
                    for _ in range(cn):
                        yield (None, None)
                    continue
            try:
                cr = open_fn()
                stats.chunks_opened += 1
                tri_all = np.ones(cr.n, np.int8)
                tris = []
                for p in preds:
                    t = _chunk_tri(p, ctx, cr, line_start, manifest)
                    tris.append(t)
                    np.minimum(tri_all, t, out=tri_all)
                    if not (tri_all >= 0).any():
                        break
                hits = []
                for pos in np.flatnonzero(tri_all >= 0).tolist():
                    if tri_all[pos] == 1:
                        if want_lines:
                            line = cr.line(pos)
                            stats.rows_materialized += 1
                        else:
                            line = None
                    else:
                        line = cr.line(pos)
                        stats.rows_materialized += 1
                        if not all(t[pos] == 1 or _test_line(p, line, line_start + pos)
                                   for p, t in zip(preds, tris)):
                            continue
                    hits.append((line_start + pos, line))
            except ValueError:
                if arch.salvage:
                    # damaged chunk in salvage mode: its lines are lost,
                    # the query continues over the survivors
                    stats.chunks_skipped += 1
                    continue
                raise
            except Exception as e:
                # a corrupt chunk must surface as ValueError, never as a
                # stray KeyError/IndexError from partial decode
                if arch.salvage:
                    stats.chunks_skipped += 1
                    continue
                raise ValueError(f"truncated or corrupt logzip chunk {k}: {e}") from e
            if outcome.get("bloom_passes") and not hits:
                stats.bloom_false_positives += 1
            stats.hits += len(hits)
            yield from hits
    finally:
        arch.close()


def search(src, query, *, stats: QueryStats | None = None,
           salvage: bool = False):
    """Compressed-domain grep: yield ``(line_no, line)`` for every line of
    the archive satisfying ``query``, in line order.

    ``src`` is an archive blob (bytes) or a path; LZJF, LZJM and LZJS
    containers are all accepted.  ``query`` is a predicate —
    ``Substring`` / ``Regex`` / ``FieldEq`` / ``LineRange`` / ``EventIs``
    — or an ``And`` of them.  Pass a ``QueryStats`` to observe how much
    of the archive was actually decoded.  ``salvage=True`` opens a
    damaged LZJS container through the scan-rebuilt index and queries
    the surviving chunks."""
    yield from _execute(src, query, stats if stats is not None else QueryStats(),
                        salvage=salvage)


def count(src, query, *, stats: QueryStats | None = None,
          salvage: bool = False) -> int:
    """Number of matching lines — the no-materialization fast path: chunks
    whose manifest EventID histogram (``ec``) decides every row are
    counted without opening (``stats.chunks_counted_from_manifest``), and
    rows proven to match by template classification are counted without
    ever assembling their text."""
    st = stats if stats is not None else QueryStats()
    n = 0
    for _ in _execute(src, query, st, want_lines=False, salvage=salvage,
                      count_from_manifest=True):
        n += 1
    return n


def sample(src, query, k: int = 10, *, stats: QueryStats | None = None) -> list:
    """First ``k`` hits (line order). Chunks are evaluated lazily, so a
    satisfied sample stops reading the archive early."""
    st = stats if stats is not None else QueryStats()
    out = []
    for hit in _execute(src, query, st):
        out.append(hit)
        if len(out) >= k:
            break
    return out


def plan(src, query, *, salvage: bool = False) -> list[dict]:
    """Per-chunk pushdown plan, computed without decoding anything: for
    every chunk, whether the planner would open it or the screen reason
    (``template`` / ``param_bloom`` / ``field_values`` / ``field_bounds``
    / ...) that prunes it — the chunk-level companion to ``explain``'s
    template table, surfaced by CLI ``grep --explain``."""
    preds = _flatten(query)
    arch = _ArchiveChunks(src, salvage=salvage)
    try:
        fmt = LogFormat(arch.fmt_str) if arch.fmt_str else None
        ctx = _Ctx(fmt, arch.session_templates, arch.session_params,
                   arch.screens_meta)
        _validate_preds(preds, fmt)
        out = []
        for k, line_start, n_lines, manifest, open_fn, screen_fn in arch.chunks():
            outcome: dict = {}
            possible = all(_chunk_possible(p, ctx, manifest, line_start,
                                           n_lines, screen_fn, outcome)
                           for p in preds)
            out.append({
                "chunk": k,
                "lines": [line_start, line_start + n_lines],
                "open": bool(possible),
                "reason": None if possible else outcome.get("reason", "other"),
                "bloom_probes": outcome.get("bloom_probes", 0),
            })
        return out
    finally:
        arch.close()


def explain(src, query) -> list[dict]:
    """Template-classification table for the substring-like conjuncts of
    ``query`` — one row per distinct template with its pushdown class and
    compiled anchored regex (``templates.template_regex``)."""
    from .templates import template_regex

    preds = _flatten(query)
    needles = [p.s for p in preds if isinstance(p, Substring)]
    for p in preds:
        if isinstance(p, Regex):
            needles.extend(_required_literals(p.pattern))
    arch = _ArchiveChunks(src)
    try:
        if arch.session_templates is not None:
            tpls = list(enumerate(arch.session_templates))
        else:
            seen: dict[tuple, int | None] = {}
            for _, _, _, _, open_fn, _screen in arch.chunks():
                cr = open_fn()
                if cr.level < 2:
                    continue
                used = cr.used_global
                for k, t in enumerate(cr.templates):
                    seen.setdefault(tuple(t), used[k] if used else None)
            tpls = [(g, t) for t, g in seen.items()]
        out = []
        for g, tpl in tpls:
            classes = [classify_template(s, tuple(tpl)) for s in needles]
            cls = NEVER if NEVER in classes else min(classes, default=MAYBE)
            out.append({
                "event": g,
                "template": " ".join("<*>" if t is None else t for t in tpl),
                "class": _CLASS_NAMES[cls],
                "regex": template_regex(tpl),
            })
        return out
    finally:
        arch.close()


def extract_records(src, *, event: int | None = None,
                    line_range: tuple[int, int] | None = None,
                    stats: QueryStats | None = None,
                    salvage: bool = False):
    """Structured extraction without line materialization: yield
    ``{"line", "event", "template", "params"}`` per matched line (the
    paper's "structured intermediate representations ... directly
    utilized in downstream tasks"), optionally filtered by EventID /
    global line range. Verbatim lines are not template instances and are
    skipped."""
    st = stats if stats is not None else QueryStats()
    arch = _ArchiveChunks(src, salvage=salvage)
    try:
        for k, line_start, n_lines, manifest, open_fn, _screen in arch.chunks():
            st.chunks_total += 1
            skip = False
            if line_range is not None and n_lines is not None:
                if not (line_start < line_range[1]
                        and line_start + n_lines > line_range[0]):
                    skip = True
            if not skip and event is not None and manifest:
                used = manifest.get("used")
                if used is not None and event not in used:
                    skip = True
            if skip:
                st.chunks_skipped += 1
                continue
            try:
                cr = open_fn()
            except ValueError:
                if arch.salvage:
                    st.chunks_skipped += 1
                    continue
                raise
            st.chunks_opened += 1
            if cr.level < 2:
                continue
            used = cr.used_global
            events = cr.events
            recs = []
            for kk in (np.unique(events).tolist() if len(events) else []):
                gid = used[kk] if used is not None else kk
                if event is not None and gid != event:
                    continue
                tpl = cr.templates[kk]
                tpl_str = " ".join("<*>" if t is None else t for t in tpl)
                n_stars = sum(1 for t in tpl if t is None)
                cols = [cr.star_column(kk, s) for s in range(n_stars)]
                rows_m = cr.template_rows(kk)
                positions = cr.ok_pos[cr.matched_rows[rows_m]]
                for r, pos in enumerate(positions.tolist()):
                    no = line_start + pos
                    if line_range is not None and not (line_range[0] <= no < line_range[1]):
                        continue
                    recs.append({
                        "line": no,
                        "event": gid,
                        "template": tpl_str,
                        "params": [u[iv[r]] for u, iv in cols],
                    })
            recs.sort(key=lambda rec: rec["line"])
            st.hits += len(recs)
            yield from recs
    finally:
        arch.close()


# ----------------------------------------------------------- aggregations
#
# Compressed-domain aggregation operators (DESIGN.md §14). All three
# evaluate over *distinct* decoded rows with per-distinct multiplicities
# — the hot loop is the weighted-histogram kernel
# ``kernels.ops.distinct_counts`` — and none materializes a line
# (``stats.rows_materialized`` stays 0; correctness is property-tested
# against decompress-then-compute).

def _validate_agg_field(arch, field: str) -> None:
    fmt = LogFormat(arch.fmt_str) if arch.fmt_str else None
    if fmt is None:
        raise ValueError("field aggregation on an archive without a header format")
    if field not in fmt.fields or field == fmt.content_field:
        raise ValueError(f"unknown header field {field!r} "
                         f"(format has {fmt.fields})")


def count_by_template(src, *, stats: QueryStats | None = None,
                      salvage: bool = False, device="cuda") -> dict[int, int]:
    """Per-EventID line counts over the whole archive. Chunks whose
    manifest carries the ``ec`` EventID histogram are aggregated without
    opening (``stats.chunks_counted_from_manifest``); others decode only
    the per-line event index. Verbatim lines are not template instances
    and are excluded. Keys are session-global EventIDs for LZJS archives,
    chunk-local ids otherwise. The per-chunk histograms run on
    ``device`` (``kernels.ops.distinct_counts``)."""
    _kops.check_device(device)
    st = stats if stats is not None else QueryStats()
    out: dict[int, int] = {}
    arch = _ArchiveChunks(src, salvage=salvage)
    try:
        for k, line_start, n_lines, manifest, open_fn, _screen in arch.chunks():
            st.chunks_total += 1
            if manifest:
                used, ec = manifest.get("used"), manifest.get("ec")
                if used is not None and ec is not None and len(ec) == len(used):
                    st.chunks_counted_from_manifest += 1
                    for g, c in zip(used, ec):
                        out[g] = out.get(g, 0) + c
                    continue
            try:
                cr = open_fn()
            except ValueError:
                if arch.salvage:
                    st.chunks_skipped += 1
                    continue
                raise
            st.chunks_opened += 1
            if cr.level < 2 or not len(cr.events):
                continue
            counts = _kops.distinct_counts(cr.events, len(cr.templates), device=device)
            used = cr.used_global
            for kk, c in enumerate(counts.tolist()):
                if not c:
                    continue
                g = used[kk] if used is not None else kk
                out[g] = out.get(g, 0) + c
    finally:
        arch.close()
    st.hits = sum(out.values())
    return out


def top_k(src, field: str | None = None, *, event: int | None = None,
          star: int | None = None, k: int = 10,
          stats: QueryStats | None = None,
          salvage: bool = False, device="cuda") -> list[tuple[str, int]]:
    """Top-``k`` most frequent values of a header field (``field=...``)
    or of one template's parameter column (``event=..., star=...``),
    with counts. Parameter mode skips chunks whose manifest proves the
    EventID absent; ties break lexicographically for determinism. The
    per-chunk histograms run on ``device``."""
    if (field is None) == (event is None):
        raise ValueError("pass exactly one of field= or event= (with star=)")
    if field is None and star is None:
        raise ValueError("parameter mode needs both event= and star=")
    _kops.check_device(device)

    st = stats if stats is not None else QueryStats()
    totals: dict[str, int] = {}
    arch = _ArchiveChunks(src, salvage=salvage)
    try:
        if field is not None:
            _validate_agg_field(arch, field)
        for kc, line_start, n_lines, manifest, open_fn, _screen in arch.chunks():
            st.chunks_total += 1
            if field is None and manifest:
                used = manifest.get("used")
                if used is not None and event not in used:
                    st.chunks_skipped += 1
                    continue
            try:
                cr = open_fn()
            except ValueError:
                if arch.salvage:
                    st.chunks_skipped += 1
                    continue
                raise
            st.chunks_opened += 1
            if field is not None:
                if not cr.n_ok:
                    continue
                uniq, inv = cr.header_distinct(field)
            else:
                if cr.level < 2 or not len(cr.events):
                    continue
                used = cr.used_global
                kk = next((j for j in range(len(cr.templates))
                           if (used[j] if used is not None else j) == event),
                          None)
                if kk is None:
                    continue
                n_stars = sum(1 for t in cr.templates[kk] if t is None)
                if star >= n_stars:
                    continue  # no such column here: contributes nothing
                uniq, inv = cr.star_column(kk, star)
            if not len(uniq):
                continue
            counts = _kops.distinct_counts(inv, len(uniq), device=device)
            for u, c in zip(uniq, counts.tolist()):
                if c:
                    totals[u] = totals.get(u, 0) + c
    finally:
        arch.close()
    st.hits = sum(totals.values())
    return sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


_INT_CORE_RE = re.compile(r"[0-9]+")


def time_histogram(src, field: str, *, bucket: int = 60,
                   stats: QueryStats | None = None,
                   salvage: bool = False, device="cuda") -> dict[int, int]:
    """Histogram of an integer-valued header field (e.g. a timestamp
    column), keyed by ``value // bucket`` — per chunk the field's
    distinct values are parsed once and weighted by their per-distinct
    multiplicities. The integer is the value's first digit run; values
    without digits are ignored. Returned sorted by bucket. The per-chunk
    histograms run on ``device``."""
    if bucket <= 0:
        raise ValueError("bucket must be positive")
    _kops.check_device(device)

    st = stats if stats is not None else QueryStats()
    out: dict[int, int] = {}
    arch = _ArchiveChunks(src, salvage=salvage)
    try:
        _validate_agg_field(arch, field)
        for kc, line_start, n_lines, manifest, open_fn, _screen in arch.chunks():
            st.chunks_total += 1
            try:
                cr = open_fn()
            except ValueError:
                if arch.salvage:
                    st.chunks_skipped += 1
                    continue
                raise
            st.chunks_opened += 1
            if not cr.n_ok:
                continue
            uniq, inv = cr.header_distinct(field)
            if not len(uniq):
                continue
            counts = _kops.distinct_counts(inv, len(uniq), device=device)
            for u, c in zip(uniq, counts.tolist()):
                if not c:
                    continue
                m = _INT_CORE_RE.search(u)
                if m is None:
                    continue
                b = int(m.group()) // bucket
                out[b] = out.get(b, 0) + c
    finally:
        arch.close()
    st.hits = sum(out.values())
    return dict(sorted(out.items()))
