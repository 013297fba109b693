"""Log line parsing + content tokenization for logzip (paper §II, §IV-B L1).

A ``LogFormat`` turns a loghub-style format string, e.g.::

    "<Date> <Time> <Level> <Component>: <Content>"

into a compiled regex with named groups (same convention as logparser /
the original logzip). ``parse`` splits every raw line into header-field
columns plus the free-text message content; lines that do not match the
format are routed to a verbatim side-channel so compression stays lossless.

``tokenize`` splits message content into (tokens, delimiters) where the
delimiter strings are preserved exactly: ``reassemble(tokens, delims)``
is byte-identical to the input. Matching/clustering operate on tokens
only; delimiters ride along in a pattern-dictionary column.

``Vocab`` maps token strings to int32 ids for the accelerator path.
id 0 is PAD, id 1 is the wildcard ``*`` (never produced by tokenize:
literal "*" tokens are escaped on entry).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .textops import SegmentHasher, class_mask, intern_segments, runs_of

PAD_ID = 0
STAR_ID = 1
_N_RESERVED = 2

# Token delimiters used by the paper's implementation: whitespace plus a
# small set of punctuation. A "token" is a maximal run of non-delimiter
# characters; delimiter runs are preserved verbatim.
DEFAULT_DELIMITERS = " \t,;:="
_TOKEN_RE_CACHE: dict[str, re.Pattern] = {}


def _token_re(delimiters: str) -> re.Pattern:
    pat = _TOKEN_RE_CACHE.get(delimiters)
    if pat is None:
        cls = re.escape(delimiters)
        pat = re.compile(rf"[^{cls}]+")
        _TOKEN_RE_CACHE[delimiters] = pat
    return pat


def tokenize(content: str, delimiters: str = DEFAULT_DELIMITERS) -> tuple[list[str], list[str]]:
    """Split ``content`` into (tokens, delims).

    ``len(delims) == len(tokens) + 1``; delims[0] / delims[-1] are the
    (possibly empty) leading / trailing delimiter runs.
    """
    # Two C-level regex passes instead of a Python loop over runs:
    # findall gives the maximal token runs, split gives the delimiter runs
    # around them (including the possibly-empty leading/trailing runs).
    pat = _token_re(delimiters)
    return pat.findall(content), pat.split(content)


def reassemble(tokens: list[str], delims: list[str]) -> str:
    out = [delims[0]]
    for t, d in zip(tokens, delims[1:]):
        out.append(t)
        out.append(d)
    return "".join(out)


# ------------------------------------------------------------- TokenGrid

@dataclass
class TokenGrid:
    """Batched tokenization result over the distinct contents of a chunk
    (DESIGN.md §10): the device-layout twin of per-line ``tokenize`` +
    ``Vocab.encode_batch``.

    ``ids``/``lens`` are exactly what ``encode_batch`` returns. Token and
    delimiter *strings* are interned: ``vocab`` holds tokens (same ids,
    same first-occurrence order as the scalar path), ``delim_table``
    holds the distinct delimiter runs with ``delim_ids[u, j]`` the run
    before token ``j`` of line ``u`` (column ``lens[u]`` is the trailing
    run). Raw byte offsets are kept so multi-token parameter substrings
    are O(1) slices of the original content instead of token/delim
    joins.
    """

    ids: np.ndarray          # (U, W) int32 vocab ids, PAD-padded
    lens: np.ndarray         # (U,) int32 true token counts (may exceed W)
    delim_ids: np.ndarray    # (U, W+1) int32 into delim_table
    delim_table: list[str]
    data: bytes              # utf-8 of the concatenated contents
    tok_starts: np.ndarray   # flat byte offsets of in-budget tokens
    tok_ends: np.ndarray
    row_ptr: np.ndarray      # (U+1,) flat index of each line's first token

    def substring(self, u: int, s: int, e: int) -> str:
        """Content substring spanning tokens [s, e) of line ``u`` with the
        interior delimiters — byte-identical to joining tokens/delims."""
        base = self.row_ptr[u]
        return self.data[self.tok_starts[base + s]:self.tok_ends[base + e - 1]].decode(
            "utf-8", "surrogateescape")

    def line_delims(self, u: int) -> list[str]:
        """The ``delims`` list of line ``u`` (len = lens[u] + 1), for
        rows within the width budget."""
        t = int(self.lens[u])
        return [self.delim_table[i] for i in self.delim_ids[u, :t + 1]]


def _cumsum0(a: np.ndarray) -> np.ndarray:
    out = np.empty(len(a) + 1, np.int64)
    out[0] = 0
    np.cumsum(a, out=out[1:])
    return out


_DELIM_LUT_CACHE: dict[str, np.ndarray] = {}


def tokenize_batch(
    contents: list[str],
    vocab: "Vocab",
    max_len: int,
    *,
    delimiters: str = DEFAULT_DELIMITERS,
    tight: bool = True,
) -> TokenGrid:
    """Tokenize + vocab-encode a batch of contents in a few numpy passes.

    Byte-identical contract with the scalar path (property-tested): the
    returned ``ids``/``lens`` equal ``vocab.encode_batch([tokenize(c)[0]
    for c in contents], ...)`` run on a same-state vocab, including the
    id assignment order, and tokens/delims reconstruct ``tokenize``'s
    output exactly.

    Contents are joined with ``\\n`` (never a token or delimiter char);
    a content containing a newline — or one that defeats utf-8 encoding
    — routes the whole batch through the scalar reference path.
    """
    n = len(contents)
    if n == 0:
        return TokenGrid(np.zeros((0, 1), np.int32), np.zeros(0, np.int32),
                         np.zeros((0, 2), np.int32), [], b"",
                         np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros(1, np.int64))
    try:
        if any("\n" in c for c in contents):
            raise ValueError
        data = "\n".join(contents).encode("utf-8", "surrogateescape")
    except (ValueError, UnicodeEncodeError):
        return _tokenize_batch_reference(contents, vocab, max_len,
                                         delimiters=delimiters, tight=tight)
    buf = np.frombuffer(data, np.uint8)
    lut = _DELIM_LUT_CACHE.get(delimiters)
    if lut is None:
        lut = class_mask(delimiters + "\n")
        _DELIM_LUT_CACHE[delimiters] = lut
    tok_mask = ~lut[buf]

    starts, ends = runs_of(tok_mask)
    line_starts = np.concatenate([[0], np.flatnonzero(buf == 0x0A) + 1])
    line_ends = np.concatenate([line_starts[1:] - 1, [len(buf)]])
    line_of = np.searchsorted(line_starts, starts, side="right") - 1
    lens = np.bincount(line_of, minlength=n).astype(np.int32)

    width = max_len
    if tight:
        width = max(1, min(max_len, int(lens.max(initial=1))))
    # replicate encode_batch's clipping: tokens at in-line position >= W
    # are never interned (their lines go verbatim), keeping vocab ids
    # identical to the scalar scan
    col = np.arange(len(starts)) - _cumsum0(lens)[line_of]
    keep = col < width
    fstarts, fends, fline, fcol = starts[keep], ends[keep], line_of[keep], col[keep]

    hasher = SegmentHasher(buf)
    tok_of, tok_table = intern_segments(data, hasher, fstarts, fends)
    vid = np.fromiter((vocab.id(t) for t in tok_table), np.int32,
                      count=len(tok_table)) if tok_table else np.zeros(0, np.int32)
    ids = np.zeros((n, width), dtype=np.int32)
    ids[fline, fcol] = vid[tok_of]

    # delimiter runs: per line [line_start, tok0), [tok_j_end, tok_j+1),
    # ..., [tok_m-1_end, tok_m) — min(lens, W) + 1 segments. Built from
    # the UNFILTERED token stream so a clipped line's last kept segment
    # ends at its next (clipped) token, exactly like the scalar path.
    m = np.minimum(lens, width).astype(np.int64)
    dptr = _cumsum0(m + 1)
    total = int(dptr[-1])
    ds = np.empty(total, np.int64)
    de = np.empty(total, np.int64)
    ds[dptr[:-1]] = line_starts
    de[dptr[:-1]] = line_ends  # overwritten below when the line has tokens
    if len(starts):
        first = col == 0
        de[dptr[line_of[first]]] = starts[first]
        nxt_same = np.empty(len(starts), bool)
        nxt_same[:-1] = line_of[1:] == line_of[:-1]
        nxt_same[-1] = False
        nxt_start = np.empty(len(starts), np.int64)
        nxt_start[:-1] = starts[1:]
        nxt_start[-1] = 0
        at = dptr[line_of[keep]] + 1 + col[keep]
        ds[at] = ends[keep]
        de[at] = np.where(nxt_same[keep], nxt_start[keep], line_ends[line_of[keep]])
    did, delim_table = intern_segments(data, hasher, ds, de)
    delim_ids = np.zeros((n, width + 1), np.int32)
    drow = np.repeat(np.arange(n), m + 1)
    delim_ids[drow, np.arange(total) - dptr[drow]] = did

    row_ptr = _cumsum0(np.minimum(lens, width))
    return TokenGrid(ids, lens, delim_ids, delim_table, data,
                     fstarts, fends, row_ptr)


def _tokenize_batch_reference(contents, vocab, max_len, *, delimiters, tight) -> TokenGrid:
    """Scalar fallback (and oracle): per-line tokenize + encode_batch,
    then the same interned-grid representation."""
    toks, delims = [], []
    for c in contents:
        t, d = tokenize(c, delimiters)
        toks.append(t)
        delims.append(d)
    ids, lens = vocab.encode_batch(toks, max_len, tight=tight)
    width = ids.shape[1]
    delim_ids = np.zeros((len(contents), width + 1), np.int32)
    delim_table: list[str] = []
    dmap: dict[str, int] = {}
    for u, d in enumerate(delims):
        for j, s in enumerate(d[:width + 1]):
            i = dmap.get(s)
            if i is None:
                i = len(delim_table)
                dmap[s] = i
                delim_table.append(s)
            delim_ids[u, j] = i
    # byte offsets against a private concatenation (identical substrings)
    enc = [c.encode("utf-8", "surrogateescape") for c in contents]
    data = b"\x00".join(enc)
    offs = _cumsum0(np.fromiter((len(e) + 1 for e in enc), np.int64, len(enc)))
    tok_starts: list[int] = []
    tok_ends: list[int] = []
    counts = np.minimum(lens, width)
    for u, (t, d) in enumerate(zip(toks, delims)):
        pos = int(offs[u]) + len(d[0].encode("utf-8", "surrogateescape"))
        for j in range(int(counts[u])):
            tb = len(t[j].encode("utf-8", "surrogateescape"))
            tok_starts.append(pos)
            tok_ends.append(pos + tb)
            pos += tb + len(d[j + 1].encode("utf-8", "surrogateescape"))
    return TokenGrid(ids, lens, delim_ids, delim_table, data,
                     np.asarray(tok_starts, np.int64), np.asarray(tok_ends, np.int64),
                     _cumsum0(counts))


@dataclass
class LogFormat:
    """loghub-style header format, e.g. ``<Date> <Time> <Level> <Component>: <Content>``."""

    format: str
    content_field: str = "Content"
    fields: list[str] = field(init=False)
    regex: re.Pattern = field(init=False)

    def __post_init__(self):
        self.fields = re.findall(r"<(\w+)>", self.format)
        if self.content_field not in self.fields:
            raise ValueError(f"format must contain <{self.content_field}>")
        pattern = ""
        pos = 0
        for m in re.finditer(r"<(\w+)>", self.format):
            lit = self.format[pos:m.start()]
            # whitespace in the format matches any whitespace run (captured
            # for losslessness via a separate group)
            pattern += re.escape(lit).replace(r"\ ", r"\s+")
            name = m.group(1)
            if name == self.content_field:
                pattern += rf"(?P<{name}>.*?)"
            else:
                pattern += rf"(?P<{name}>\S*?)"
            pos = m.end()
        pattern += re.escape(self.format[pos:]) + r"$"
        self.regex = re.compile("^" + pattern)
        # literal segments around the fields (in appearance order) so
        # render is one join instead of sequential str.replace passes
        self._segments = re.split(r"<\w+>", self.format)
        # split fast path (DESIGN.md §10): usable when the content field
        # is last, the format has no leading/trailing literals, and every
        # separator is "<core> " with a whitespace-free core — then the
        # regex + render round-trip is equivalent to one str.split plus
        # per-part suffix checks on the lines the fast path accepts;
        # anything irregular falls back to the regex per line.
        self._fast_cores: list[str] | None = None
        if (self.fields[-1] == self.content_field
                and self._segments[0] == "" and self._segments[-1] == ""):
            cores = []
            for seg in self._segments[1:-1]:
                if seg.endswith(" ") and not re.search(r"\s", seg[:-1]):
                    cores.append(seg[:-1])
                else:
                    break
            else:
                self._fast_cores = cores

    def parse(self, lines: list[str], *, fast: bool = True) -> tuple[dict[str, list[str]], list[int], list[int]]:
        """Parse lines -> (field columns, matched line idx, unmatched line idx).

        To keep the header losslessly reconstructible even with irregular
        whitespace, a matched line must round-trip through ``render``;
        otherwise it is treated as unmatched (stored verbatim).
        ``fast=False`` forces the regex reference path (oracle for the
        split fast path, which is property-tested to agree).
        """
        if fast and self._fast_cores is not None:
            return self._parse_fast(lines)
        cols: list[list[str]] = [[] for _ in self.fields]
        ok_idx: list[int] = []
        bad_idx: list[int] = []
        for i, line in enumerate(lines):
            vals = self._parse_regex_line(line)
            if vals is None:
                bad_idx.append(i)
                continue
            for c, v in zip(cols, vals):
                c.append(v)
            ok_idx.append(i)
        return dict(zip(self.fields, cols)), ok_idx, bad_idx

    def _parse_regex_line(self, line: str) -> tuple | None:
        m = self.regex.match(line)
        if m is None:
            return None
        vals = m.groups()  # named groups appear in field order
        segs = self._segments
        rendered = segs[0]
        for v, seg in zip(vals, segs[1:]):
            rendered += v + seg
        return vals if rendered == line else None

    def _parse_fast(self, lines: list[str]) -> tuple[dict[str, list[str]], list[int], list[int]]:
        """One ``str.split`` per line for regular lines; regex fallback
        for anything suspicious (empty parts = multi-space runs, other
        whitespace, non-ASCII header fields, missing separator cores).

        The fast accept is a strict subset of the regex accept with
        identical captures: split parts are maximal space-free runs, and
        within such a run the regex's non-greedy field + literal core +
        ``\\s+`` can only bind the core as the run's suffix.
        """
        cores = self._fast_cores
        nsep = len(cores)
        rows: list[tuple] = []
        ok_idx: list[int] = []
        bad_idx: list[int] = []
        for i, line in enumerate(lines):
            parts = line.split(" ", nsep)
            ok = len(parts) == nsep + 1 and "\n" not in parts[nsep]
            if ok:
                for j in range(nsep):
                    p = parts[j]
                    if not (p and p.isascii() and p.isprintable()):
                        ok = False
                        break
                    c = cores[j]
                    if c:
                        if not p.endswith(c):
                            ok = False
                            break
                        parts[j] = p[:-len(c)]
            if ok:
                rows.append(tuple(parts))
                ok_idx.append(i)
                continue
            vals = self._parse_regex_line(line)
            if vals is None:
                bad_idx.append(i)
            else:
                rows.append(vals)
                ok_idx.append(i)
        cols = [list(c) for c in zip(*rows)] if rows else [[] for _ in self.fields]
        return dict(zip(self.fields, cols)), ok_idx, bad_idx

    def render(self, values: dict[str, str]) -> str:
        out = [self._segments[0]]
        for f, seg in zip(self.fields, self._segments[1:]):
            out.append(values[f])
            out.append(seg)
        return "".join(out)


# Formats for the five paper datasets (loghub conventions).
LOG_FORMATS: dict[str, LogFormat] = {
    "HDFS": LogFormat("<Date> <Time> <Pid> <Level> <Component>: <Content>"),
    "Spark": LogFormat("<Date> <Time> <Level> <Component>: <Content>"),
    "Android": LogFormat("<Date> <Time> <Pid> <Tid> <Level> <Component>: <Content>"),
    "Windows": LogFormat("<Date> <Time>, <Level> <Component> <Content>"),
    "Thunderbird": LogFormat("<Label> <Timestamp> <Date> <User> <Month> <Day> <Time> <Location> <Component>: <Content>"),
}


class Vocab:
    """Token-string <-> int32 id mapping. 0=PAD, 1=STAR ('*')."""

    def __init__(self):
        self._to_id: dict[str, int] = {}
        self._to_str: list[str] = ["\x00PAD", "*"]

    def __len__(self) -> int:
        return len(self._to_str)

    def id(self, token: str) -> int:
        """Get-or-assign id for a token. Literal '*' is escaped."""
        if token == "*":
            token = "\x01*"
        i = self._to_id.get(token)
        if i is None:
            i = len(self._to_str)
            self._to_id[token] = i
            self._to_str.append(token)
        return i

    def lookup(self, token: str) -> int:
        """Id for a token or PAD_ID if unseen (never assigns)."""
        if token == "*":
            token = "\x01*"
        return self._to_id.get(token, PAD_ID)

    def token(self, i: int) -> str:
        t = self._to_str[i]
        return "*" if t == "\x01*" else t

    def encode_batch(
        self, token_lists: list[list[str]], max_len: int, *, assign: bool = True,
        tight: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids (N, W) int32 PAD-padded, lengths (N,) int32).

        ``W = max_len`` normally; with ``tight=True`` the width shrinks to
        the actual longest line (capped at ``max_len``) so downstream DP
        matching pays for observed lengths, not the budget. Lines longer
        than ``max_len`` get length = actual length (callers treat
        len > max_len as unmatched / verbatim).

        Single-pass: tokens are flattened, interned once per *distinct*
        token (id assignment keeps first-occurrence order, identical to a
        per-token scan), and scattered into the padded matrix with numpy.
        """
        n = len(token_lists)
        lens = np.fromiter((len(t) for t in token_lists), np.int32, count=n)
        width = max_len
        if tight:
            width = max(1, min(max_len, int(lens.max(initial=1))))
        clens = np.minimum(lens, width)
        ids = np.zeros((n, width), dtype=np.int32)
        total = int(clens.sum())
        if total == 0:
            return ids, lens
        flat: list[str] = []
        for toks, c in zip(token_lists, clens):
            flat.extend(toks if len(toks) <= width else toks[:c])
        flat_ids = np.empty(total, np.int32)
        if assign:
            to_id, to_str = self._to_id, self._to_str
            for i, t in enumerate(flat):
                if t == "*":
                    t = "\x01*"
                v = to_id.get(t)
                if v is None:
                    v = len(to_str)
                    to_id[t] = v
                    to_str.append(t)
                flat_ids[i] = v
        else:
            get = self._to_id.get
            for i, t in enumerate(flat):
                flat_ids[i] = get("\x01*" if t == "*" else t, PAD_ID)
        rows = np.repeat(np.arange(n), clens)
        starts = np.cumsum(clens) - clens
        cols = np.arange(total) - np.repeat(starts, clens)
        ids[rows, cols] = flat_ids
        return ids, lens
