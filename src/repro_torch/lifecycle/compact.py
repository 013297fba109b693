"""Compaction engine: merge N LZJS sessions into one sealed archive.

``compact`` decodes every recoverable line of the inputs (in argument
order) and re-compresses the concatenation through a fresh
:class:`StreamingCompressor` seeded with the re-clustered shared
template store from :mod:`.recluster`.  The output is a plain v3
archive — fsck/repair, the compressed-domain query engine, screens and
every CI gate apply to it unchanged — whose header seed templates ARE
the merged store, so EventIDs are stable from chunk 0 and the remap
protocol is simply "old gid -> index in the merged store".  ParaIDs are
rebuilt from scratch: the output session's own ParamDict accumulates
values in output order, so cross-session duplicate parameters collapse
to one id. The re-compression runs its kernels (``wildcard_match_first``,
``colcodec_transform``) on ``device``, default ``"cuda"``, which raises
where there is no card; the output bytes do not depend on it.

Damaged inputs are first-class: with ``salvage=True`` (default) inputs
may be torn, repaired-with-quarantined-chunks, or mid-crash sessions.
Quarantined/undecodable chunks are SKIPPED AND REPORTED — per input,
per chunk, with the lost line range — never silently dropped; lines
already lost to a torn tail (between the last commit and the crash)
are carried over from the reader's salvage report.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..core.stages import LogzipConfig
from ..core.stream import LZJSReader, StreamingCompressor
from ..core.tokenizer import tokenize
from ..kernels.ops import check_device
from .recluster import FOLD_THETA_RATIO, ReclusterResult, recluster_stores

# Compaction is a batch job on sealed data: default to the paper's level
# 3 with the strongest kernel and big chunks — latency is cheap here,
# bytes are not.
COMPACT_LEVEL = 3
COMPACT_KERNEL = "lzma"
COMPACT_CHUNK_LINES = 16384


@dataclass
class CompactionReport:
    out: str
    inputs: list[str]
    bytes_in: int = 0
    bytes_out: int = 0
    n_lines: int = 0
    lost_lines: int = 0
    # every chunk we could not decode: {input, chunk, line_start,
    # n_lines, why} — the "never silently dropped" ledger
    skipped: list[dict] = field(default_factory=list)
    recluster: dict = field(default_factory=dict)
    remaps: list[dict[int, int]] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "out": self.out,
            "inputs": list(self.inputs),
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "ratio_vs_inputs": (self.bytes_in / self.bytes_out)
            if self.bytes_out else None,
            "n_lines": self.n_lines,
            "lost_lines": self.lost_lines,
            "skipped": list(self.skipped),
            "recluster": dict(self.recluster),
        }


def _usage_and_evidence(rd: LZJSReader) -> tuple[dict[int, int], dict, bool]:
    """Per-input template usage + constant-star evidence from footer
    manifests alone (no payload decode).

    Returns ``(usage, star_values, complete)``.  ``usage`` maps gid ->
    line count (ec-weighted when available).  ``star_values`` maps
    ``(gid, star)`` -> set of observed values, or None once any chunk
    using the gid lacks summarized evidence for that star.  ``complete``
    is False when some chunk has no manifest at all — then usage is
    unknowable and the caller must treat every template as live.
    """
    usage: dict[int, int] = {}
    star_values: dict[tuple[int, int], set | None] = {}
    complete = True
    for k, e in enumerate(rd.index):
        if e.get("q"):
            continue  # lines are lost; contributes neither usage nor evidence
        man = e.get("manifest")
        if not man:
            complete = False
            continue
        used = man.get("used")
        if used is None:
            continue  # level-1 chunk: no template structure
        ec = man.get("ec")
        tcol = man.get("tcol")
        for i, g in enumerate(used):
            g = int(g)
            usage[g] = usage.get(g, 0) + (int(ec[i]) if ec else 1)
            t = rd.templates[g] if g < len(rd.templates) else None
            n_stars = sum(1 for tok in (t or ()) if tok is None)
            for s in range(n_stars):
                key = (g, s)
                if star_values.get(key, set()) is None:
                    continue
                ent = (tcol or {}).get(f"g{g}.s{s}")
                vals = ent.get("v") if isinstance(ent, dict) else None
                if vals is None:
                    star_values[key] = None  # unsummarized somewhere: unknown
                else:
                    star_values.setdefault(key, set()).update(vals)
    return usage, star_values, complete


def _constant_stars(
    readers: list[LZJSReader],
    evidence: list[dict],
    usage: list[dict[int, int]],
) -> dict[tuple, dict[int, str]]:
    """Merge per-input star evidence to template-tuple granularity.

    A star specializes to a literal only when EVERY input that uses the
    tuple has complete evidence of the same single value, and the value
    re-tokenizes as exactly one token (else the specialized template
    could never match its own lines again)."""
    by_tuple: dict[tuple, dict[int, set | None]] = {}
    for rd, ev, use in zip(readers, evidence, usage):
        seen: dict[tuple, dict[int, set | None]] = {}
        for (g, s), vals in ev.items():
            if use.get(g, 0) <= 0 or g >= len(rd.templates):
                continue
            t = rd.templates[g]
            if t is None:
                continue
            seen.setdefault(tuple(t), {})[s] = vals
        for tt, stars in seen.items():
            cur = by_tuple.setdefault(tt, {})
            n_stars = sum(1 for tok in tt if tok is None)
            for s in range(n_stars):
                vals = stars.get(s)
                if vals is None or s in cur and cur[s] is None:
                    cur[s] = None
                elif s in cur:
                    cur[s] = None if cur[s] is None else cur[s] | vals
                else:
                    cur[s] = set(vals)
    out: dict[tuple, dict[int, str]] = {}
    for tt, stars in by_tuple.items():
        consts: dict[int, str] = {}
        for s, vals in stars.items():
            if vals is None or len(vals) != 1:
                continue
            v = next(iter(vals))
            toks, _ = tokenize(v)
            if len(toks) == 1 and toks[0] == v:
                consts[s] = v
        if consts:
            out[tt] = consts
    return out


def compact(
    inputs: list[str],
    out: str,
    *,
    level: int = COMPACT_LEVEL,
    kernel: str = COMPACT_KERNEL,
    chunk_lines: int = COMPACT_CHUNK_LINES,
    salvage: bool = True,
    fold: bool = True,
    specialize: bool = True,
    theta_ratio: float = FOLD_THETA_RATIO,
    screens: bool = True,
    device: str = "cuda",
) -> CompactionReport:
    """Merge ``inputs`` (LZJS sessions, possibly damaged) into ``out``.

    Raises ``ValueError`` when inputs disagree on the loghub format
    string — compaction merges one tenant timeline, not arbitrary
    archives — or when ``inputs`` is empty."""
    check_device(device)
    if not inputs:
        raise ValueError("compact needs at least one input archive")
    report = CompactionReport(out=str(out), inputs=[str(p) for p in inputs])
    readers = [LZJSReader(p, salvage=salvage) for p in inputs]
    try:
        formats = {rd.footer.get("format") for rd in readers}
        if len(formats) != 1:
            raise ValueError(
                "compact inputs disagree on log format: "
                + ", ".join(sorted(repr(f) for f in formats)))
        fmt = formats.pop()

        usage: list[dict[int, int]] = []
        evidence: list[dict] = []
        for rd in readers:
            u, ev, complete = _usage_and_evidence(rd)
            if not complete:
                # manifests missing (pre-manifest archive): usage is
                # unknowable — keep every template alive, learn nothing
                u = {g: max(1, u.get(g, 0))
                     for g, t in enumerate(rd.templates) if t is not None}
                ev = {}
            usage.append(u)
            evidence.append(ev)

        consts = _constant_stars(readers, evidence, usage) if specialize else {}
        rc: ReclusterResult = recluster_stores(
            [rd.templates for rd in readers], usage,
            fold=fold, theta_ratio=theta_ratio, specialize=consts)
        report.recluster = rc.report
        report.remaps = rc.remaps

        cfg = LogzipConfig(level=level, kernel=kernel, format=fmt,
                           screens=screens, device=device)
        sc = StreamingCompressor(out, cfg, chunk_lines=chunk_lines,
                                 store=rc.store)
        try:
            for i, rd in enumerate(readers):
                for k in range(len(rd)):
                    e = rd.index[k]
                    lines = rd._chunk_lines_or_skip(k)
                    if lines is None:
                        if not salvage:
                            # strict mode: a quarantined chunk (repair
                            # already gave up on its lines) is damage
                            raise ValueError(
                                f"input {report.inputs[i]} chunk {k} is "
                                f"quarantined ({e.get('q')}); rerun with "
                                f"salvage to skip-and-report it")
                        report.skipped.append({
                            "input": report.inputs[i], "chunk": k,
                            "line_start": int(e.get("line_start", -1)),
                            "n_lines": int(e.get("n_lines", 0)),
                            "why": str(e.get("q") or "undecodable"),
                        })
                        report.lost_lines += int(e.get("n_lines", 0))
                        continue
                    sc.feed(lines)
                    report.n_lines += len(lines)
                sr = rd.salvage_report
                for lo, hi in (sr or {}).get("lost_line_ranges", []):
                    report.skipped.append({
                        "input": report.inputs[i], "chunk": None,
                        "line_start": int(lo), "n_lines": int(hi - lo),
                        "why": "lost to torn tail (salvage)",
                    })
                    report.lost_lines += int(hi - lo)
        finally:
            sc.close()
        report.bytes_out = os.path.getsize(out)
        report.bytes_in = sum(os.path.getsize(p) for p in inputs)
    finally:
        for rd in readers:
            rd.close()
    return report
