"""Crash recovery for LZJS containers (DESIGN.md §13): salvage scanning,
``fsck`` and ``repair``.

The v3 commit record is the anchor: it is CRC-sealed, self-locating
(carries the absolute record offset) and self-framing (carries the three
frame lengths), so scanning the raw bytes for valid ``CMT1`` records
rebuilds the chunk index with no footer at all. From there:

- **fsck** verifies every frame of every located chunk and reports,
  without touching the file: which chunks are intact, which are
  quarantined (content checksum failures), and which line ranges are
  lost (chunks whose commit never hit the disk were, by definition,
  never committed).
- **repair** additionally *restores* record envelopes — the CHNK magic,
  length varints and commit bytes are all derivable from trusted
  metadata, so a bit flip there is healed in place rather than costing
  the chunk — then test-decodes every survivor against the accumulated
  dictionaries and rewrites a fresh footer (quarantine marks included)
  at the end of the last committed record. After repair the container
  opens with the ordinary ``LZJSReader``; quarantined chunks read as
  missing line ranges, everything else reads normally.

v1/v2 containers (no checksums, no commits) get best-effort sequential
recovery: records are walked from the header and each chunk is decoded
to establish its line range; the walk stops at the first record that no
longer parses.
"""

from __future__ import annotations

import json
import os
import zlib

from . import integrity
from .codec import KERNEL_BY_ID
from .encode import split_column
from .integrity import CRC_LEN
from .screens import skip_opt_frames
from .stream import (
    CHUNK_MAGIC,
    COMMIT_MAGIC,
    FOOTER_MAGIC,
    READ_VERSIONS,
    STREAM_MAGIC,
    V3,
    LZJSReader,
    _take_varint,
    _varint_bytes,
    build_commit,
    frame_positions,
    parse_chunk_record,
    parse_commit,
)

_FRAMES = ("chunk_payload", "template_delta", "paramdict_delta")


# ------------------------------------------------------------- structure

def _parse_header(data: bytes):
    """-> (version, header_dict, header_end, ok). Never raises on damage:
    a broken header degrades to ``({}, ok=False)`` — chunks that do not
    reference seed templates/params still decode."""
    if len(data) < 5 or data[:4] != STREAM_MAGIC:
        raise ValueError(
            f"not an LZJS container: magic {bytes(data[:4])!r}, "
            f"expected {STREAM_MAGIC!r}")
    version = data[4]
    if version not in READ_VERSIONS:
        raise ValueError(f"LZJS container version {version} is newer than "
                         f"this reader (supports 1..{V3})")
    try:
        hlen, pos = _take_varint(data, 5)
        hblob = data[pos:pos + hlen]
        if len(hblob) != hlen:
            raise ValueError("truncated header")
        end = pos + hlen
        if version >= V3:
            integrity.verify(data[:end], bytes(data[end:end + CRC_LEN]),
                             frame="header", offset=0)
            end += CRC_LEN
        header = json.loads(zlib.decompress(hblob).decode("utf-8"))
        return version, header, end, True
    except ValueError:
        return version, {}, 5, False


def _parse_footer(data: bytes, version: int):
    """-> (footer_dict, footer_offset); raises ValueError on any damage."""
    end = len(data)
    if end < 16 or data[end - 8:] != FOOTER_MAGIC:
        raise ValueError("footer magic missing")
    flen = int.from_bytes(data[end - 16:end - 8], "little")
    extra = CRC_LEN if version >= V3 else 0
    if flen + 16 + extra > end:
        raise ValueError("footer length out of range")
    off = end - 16 - extra - flen
    if version >= V3:
        integrity.verify(data[off:off + flen],
                         bytes(data[off + flen:off + flen + CRC_LEN]),
                         frame="footer", offset=off)
    try:
        return json.loads(zlib.decompress(data[off:off + flen]).decode("utf-8")), off
    except Exception as e:
        raise ValueError(f"corrupt footer: {e}") from e


def _entry_from_commit(c: dict, end: int) -> dict:
    g = (c["blob_len"], c["td_len"], c["pd_len"])
    doffset = c["offset"] + 4 + len(_varint_bytes(c["blob_len"])) \
        + c["blob_len"] + CRC_LEN
    return {
        "offset": c["offset"], "length": end - c["offset"], "doffset": doffset,
        "line_start": c["line_start"], "n_lines": c["n_lines"],
        "tpl_base": c["tpl_base"], "n_delta": c["n_delta"],
        "pd_base": c["pd_base"], "pd_delta": c["pd_delta"],
        "match_rate": 0.0, "manifest": None, "g": list(g),
    }


def scan_commits(data: bytes) -> list[dict]:
    """Find every sealed commit record and return the chunk index entries
    it vouches for, sorted by offset. A commit only counts when its CRC
    verifies AND its self-declared geometry places it exactly where it
    was found — stray ``CMT1`` byte patterns inside compressed payloads
    fail one or the other."""
    entries: dict[int, dict] = {}
    pos = data.find(COMMIT_MAGIC)
    while pos != -1:
        got = parse_commit(data, pos)
        if got is not None:
            c, end = got
            expected = c["offset"] + frame_positions(
                c["blob_len"], c["td_len"], c["pd_len"])[3]
            if expected == pos and c["offset"] >= 5:
                entries[c["offset"]] = _entry_from_commit(c, end)
                pos = data.find(COMMIT_MAGIC, end)
                continue
        pos = data.find(COMMIT_MAGIC, pos + 1)
    return [entries[o] for o in sorted(entries)]


def _scan_sequential(data: bytes, start: int, header: dict) -> list[dict]:
    """v1/v2 best-effort: walk records from the header, decode each chunk
    to establish its line range; stop at the first structural failure."""
    from .codec import _deserialize_template, decompress

    templates = [tuple(t) for t in header.get("seed_templates", [])]
    params = list(header.get("seed_params", []))
    entries: list[dict] = []
    pos, line = start, 0
    while data[pos:pos + 4] == CHUNK_MAGIC:
        try:
            off = pos
            bl, p = _take_varint(data, pos + 4)
            blob = data[p:p + bl]
            if len(blob) != bl:
                break
            doffset = p + bl
            tl, p = _take_varint(data, doffset)
            td = data[p:p + tl]
            p += tl
            pl, p = _take_varint(data, p)
            pd = data[p:p + pl]
            if len(td) != tl or len(pd) != pl:
                break
            p += pl
            tpl_base, pd_base = len(templates), len(params)
            new_t = [tuple(_deserialize_template(s))
                     for s in split_column(zlib.decompress(td))]
            new_p = split_column(zlib.decompress(pd))
            templates.extend(new_t)
            params.extend(new_p)
            lines = decompress(blob, ext_templates=templates, ext_params=params)
        except Exception:
            break
        entries.append({
            "offset": off, "length": p - off, "doffset": doffset,
            "line_start": line, "n_lines": len(lines),
            "tpl_base": tpl_base, "n_delta": len(new_t),
            "pd_base": pd_base, "pd_delta": len(new_p),
            "match_rate": 0.0, "manifest": None,
        })
        line += len(lines)
        pos = p
    return entries


def _has_unclaimed(data: bytes, start: int, index: list[dict]) -> bool:
    """True when a CHNK record sits in a byte range no entry claims —
    the double-fault case (commit AND footer both damaged)."""
    pos = start
    for e in index:
        if e["offset"] != pos:
            return True
        # commit-derived lengths stop at the commit; footer lengths span
        # any optional post-commit frames (SCRN) too — skip either way
        pos = skip_opt_frames(data, e["offset"] + e["length"])
    return data[pos:pos + 4] == CHUNK_MAGIC


def _rescue_unclaimed(data: bytes, start: int, by_offset: dict,
                      header: dict) -> list[dict]:
    """v3 gap walk: records whose commit AND footer entry are both gone
    can still be claimed when their envelope parses and every content
    frame passes its CRC — the metadata the commit would have carried
    (line range, dictionary bases) is re-derived by decoding along the
    chain. Stops at the first record that fails either test."""
    from .codec import _deserialize_template, decompress

    templates = [tuple(t) for t in header.get("seed_templates", [])]
    params = list(header.get("seed_params", []))
    rescued: list[dict] = []
    pos, line = start, 0
    while pos < len(data):
        e = by_offset.get(pos)
        if e is not None:
            # claimed record: trust its metadata, apply its delta frames
            # (pad on damage) so later unclaimed chunks keep decoding
            line = e["line_start"] + e["n_lines"]
            try:
                bl, tl, pl = e["g"] if e.get("g") else _parse_frame_lengths(
                    data, e["offset"])
                (_, _), (to, tl_), (po, pl_), _ = frame_positions(bl, tl, pl)
                td = data[e["offset"] + to:e["offset"] + to + tl_]
                pd = data[e["offset"] + po:e["offset"] + po + pl_]
                integrity.verify(td, data[e["offset"] + to + tl_:
                                          e["offset"] + to + tl_ + CRC_LEN],
                                 frame="template_delta")
                integrity.verify(pd, data[e["offset"] + po + pl_:
                                          e["offset"] + po + pl_ + CRC_LEN],
                                 frame="paramdict_delta")
                templates.extend(tuple(_deserialize_template(s))
                                 for s in split_column(zlib.decompress(td)))
                params.extend(split_column(zlib.decompress(pd)))
            except Exception:
                templates.extend([None] * e["n_delta"])
                params.extend([None] * e.get("pd_delta", 0))
            pos = skip_opt_frames(data, e["offset"] + e["length"])
            continue
        if data[pos:pos + 4] != CHUNK_MAGIC:
            break
        try:
            off = pos
            bl, p = _take_varint(data, pos + 4)
            blob = data[p:p + bl]
            if len(blob) != bl:
                break
            integrity.verify(blob, bytes(data[p + bl:p + bl + CRC_LEN]),
                             frame="chunk_payload", offset=p, chunk=-1)
            doffset = p + bl + CRC_LEN
            tl, p = _take_varint(data, doffset)
            td = data[p:p + tl]
            integrity.verify(td, bytes(data[p + tl:p + tl + CRC_LEN]),
                             frame="template_delta", offset=p, chunk=-1)
            p += tl + CRC_LEN
            pl, p = _take_varint(data, p)
            pd = data[p:p + pl]
            if len(td) != tl or len(pd) != pl:
                break
            integrity.verify(pd, bytes(data[p + pl:p + pl + CRC_LEN]),
                             frame="paramdict_delta", offset=p, chunk=-1)
            commit_at = p + pl + CRC_LEN
            tpl_base, pd_base = len(templates), len(params)
            new_t = [tuple(_deserialize_template(s))
                     for s in split_column(zlib.decompress(td))]
            new_p = split_column(zlib.decompress(pd))
            templates.extend(new_t)
            params.extend(new_p)
            lines = decompress(blob, ext_templates=templates, ext_params=params)
        except Exception:
            break
        # the commit's byte length is fully determined by the re-derived
        # values, so the record end is known even with the commit damaged
        end = commit_at + len(build_commit(
            off, bl, tl, pl, line, len(lines), tpl_base, len(new_t),
            pd_base, len(new_p)))
        if end > len(data):
            break  # commit region never landed: the record was not committed
        rescued.append({
            "offset": off, "length": end - off, "doffset": doffset,
            "line_start": line, "n_lines": len(lines),
            "tpl_base": tpl_base, "n_delta": len(new_t),
            "pd_base": pd_base, "pd_delta": len(new_p),
            "match_rate": 0.0, "manifest": None,
        })
        line += len(lines)
        # a rescued record's commit-derived end excludes any optional
        # screen frame the writer appended after the commit
        pos = skip_opt_frames(data, end)
    return rescued


def _parse_frame_lengths(data: bytes, off: int) -> tuple[int, int, int]:
    """(blob_len, td_len, pd_len) of the v3 record at ``off``, from its
    envelope varints; raises on structural damage."""
    if data[off:off + 4] != CHUNK_MAGIC:
        raise ValueError("bad magic")
    bl, p = _take_varint(data, off + 4)
    tl, p = _take_varint(data, p + bl + CRC_LEN)
    pl, _ = _take_varint(data, p + tl + CRC_LEN)
    return bl, tl, pl


def _expected_envelope(e: dict, bl: int, tl: int, pl: int):
    """The canonical envelope byte runs for a chunk record with the given
    frame lengths: (relative_offset, bytes) for the CHNK magic + blob
    varint, the two delta-length varints and the sealed commit. Every one
    of these is derivable from trusted metadata alone."""
    (bo, _), (to, _), (_po, _), cpos = frame_positions(bl, tl, pl)
    return (
        (0, CHUNK_MAGIC + _varint_bytes(bl)),
        (bo + bl + CRC_LEN, _varint_bytes(tl)),
        (to + tl + CRC_LEN, _varint_bytes(pl)),
        (cpos, build_commit(e["offset"], bl, tl, pl, e["line_start"],
                            e["n_lines"], e["tpl_base"], e["n_delta"],
                            e["pd_base"], e.get("pd_delta", 0))),
    )


def _verify_entry(data: bytes, k: int, e: dict, version: int) -> dict:
    """Frame-verify one chunk record in ``data`` -> {frame: error}."""
    rec = data[e["offset"]:e["offset"] + e["length"]]
    if len(rec) != e["length"]:
        return {"record": f"short record ({len(rec)}/{e['length']} bytes)"}
    try:
        parsed = parse_chunk_record(rec, k, e["offset"], version >= V3,
                                    geometry=e.get("g"))
    except ValueError as err:
        return {"record": str(err)}
    bad = {f: str(err) for f, err in parsed["bad"].items()}
    g = e.get("g")
    if g is not None and version >= V3:
        # geometry came from the commit, so the frame slicing above never
        # touched the envelope bytes — compare them to the canonical form
        # so flips there are surfaced (repair heals them losslessly)
        for rel, exp in _expected_envelope(e, *g):
            got = rec[rel:rel + len(exp)]
            if got != exp:
                bad.setdefault(
                    "envelope",
                    f"record envelope mismatch at byte {e['offset'] + rel}")
    return bad


# --------------------------------------------------------------- salvage

def salvage_scan(f) -> dict:
    """Best-effort index reconstruction over an open binary file — the
    engine behind ``LZJSReader(salvage=True)``, ``fsck`` and ``repair``.

    Merges two evidence sources, either of which survives any single
    fault alone: the footer (when it still verifies) and the per-chunk
    sealed commits. Every merged entry is then frame-verified; content
    damage becomes a ``"q"`` quarantine mark (the reader skips those),
    envelope damage on commit-backed entries is tolerated via the
    ``"g"`` geometry key (and healed by ``repair``)."""
    f.seek(0)
    data = f.read()
    version, header, header_end, header_ok = _parse_header(data)
    footer, footer_ok = None, False
    try:
        footer, _ = _parse_footer(data, version)
        footer_ok = True
    except ValueError:
        pass

    by_offset: dict[int, dict] = {}
    if footer_ok:
        for e in footer.get("chunks", []):
            by_offset[e["offset"]] = dict(e)
    if version >= V3:
        for e in scan_commits(data):
            cur = by_offset.get(e["offset"])
            if cur is None:
                by_offset[e["offset"]] = e
            else:
                # commit-verified geometry rides along with the footer
                # entry: frames stay readable even when the record's own
                # envelope bytes took the hit
                cur["g"] = e["g"]
    elif not footer_ok:
        for e in _scan_sequential(data, header_end, header):
            by_offset[e["offset"]] = e
    index = [by_offset[o] for o in sorted(by_offset)]
    if version >= V3 and _has_unclaimed(data, header_end, index):
        for e in _rescue_unclaimed(data, header_end, by_offset, header):
            by_offset[e["offset"]] = e
        index = [by_offset[o] for o in sorted(by_offset)]

    statuses = []
    for k, e in enumerate(index):
        bad = _verify_entry(data, k, e, version)
        # quarantine only on CONTENT damage: a broken commit alongside a
        # verified footer entry (or vice versa) still reads fine — that
        # is exactly the single-fault redundancy the format is built on
        content_bad = {fr: m for fr, m in bad.items()
                       if fr in _FRAMES or fr == "record"}
        if content_bad and not e.get("q"):
            e["q"] = "; ".join(f"{fr}: {m}" for fr, m in sorted(content_bad.items()))
        statuses.append(sorted(bad) if bad else "ok")

    n_lines = footer["n_lines"] if footer_ok else \
        max((e["line_start"] + e["n_lines"] for e in index), default=0)
    data_end = max((e["offset"] + e["length"] for e in index), default=header_end)
    lost = []
    expect = 0
    for e in index:
        if e["line_start"] > expect:
            lost.append([expect, e["line_start"]])
        if e.get("q"):
            lost.append([e["line_start"], e["line_start"] + e["n_lines"]])
        expect = max(expect, e["line_start"] + e["n_lines"])
    if n_lines > expect:
        lost.append([expect, n_lines])

    if footer is None:
        footer = {"v": version, "n_lines": n_lines,
                  "level": header.get("level"), "kernel": header.get("kernel"),
                  "format": header.get("format"), "chunks": index}
        if version >= V3 and "typed" in header:
            footer["typed"] = header["typed"]
    else:
        footer = dict(footer)
        footer["chunks"] = index
        footer["n_lines"] = n_lines
    report = {
        "version": version, "header_ok": header_ok, "footer_ok": footer_ok,
        "n_chunks": len(index), "n_lines": n_lines,
        "chunk_status": statuses,
        "quarantined": [k for k, e in enumerate(index) if e.get("q")],
        "lost_line_ranges": lost,
    }
    return {"version": version, "header": header, "footer": footer,
            "index": index, "n_lines": n_lines, "data_end": data_end,
            "report": report}


# ------------------------------------------------------------ fsck/repair

def _finish_report(report: dict) -> dict:
    report["clean"] = (report["footer_ok"] and report["header_ok"]
                       and all(s == "ok" for s in report["chunk_status"])
                       and not report["quarantined"]
                       and not report["lost_line_ranges"])
    report["repairable"] = not report["clean"]
    return report


def fsck(src) -> dict:
    """Read-only diagnosis of an LZJS container. Returns the salvage
    report plus ``clean`` (nothing wrong) and ``repairable``."""
    own = isinstance(src, (str, os.PathLike))
    f = open(src, "rb") if own else src
    try:
        res = salvage_scan(f)
    finally:
        if own:
            f.close()
    return _finish_report(dict(res["report"]))


def _restore_envelopes(f, data: bytes, index: list[dict]) -> int:
    """Heal damaged record envelopes in place (v3): the CHNK magic,
    length varints and commit bytes are all derivable from trusted
    metadata (commit geometry, or a verified footer entry plus the
    record's parsed frames), so flips there are rewritten instead of
    costing the chunk. Returns the number of records patched."""
    patched = 0
    for k, e in enumerate(index):
        off = e["offset"]
        if e.get("g"):
            bl, tl, pl = e["g"]
        else:
            # footer-backed entry, commit possibly damaged: recover the
            # frame lengths from the (intact) envelope parse
            try:
                parsed = parse_chunk_record(
                    data[off:off + e["length"]], k, off, True)
            except ValueError:
                continue  # content damage — quarantine handles it
            bl, tl, pl = (len(parsed["blob"]), len(parsed["td"]),
                          len(parsed["pd"]))
        dirty = False
        for rel, exp in _expected_envelope(e, bl, tl, pl):
            if data[off + rel:off + rel + len(exp)] != exp:
                f.seek(off + rel)
                f.write(exp)
                dirty = True
        if dirty:
            patched += 1
        e.pop("g", None)  # envelope now canonical: stored bytes trustworthy
    return patched


def repair(path) -> dict:
    """Repair an LZJS container in place: restore record envelopes,
    quarantine content-damaged chunks, test-decode every survivor and
    rewrite a verified footer after the last committed record. A clean
    container is left untouched. Returns the fsck-style report extended
    with the actions taken."""
    with open(path, "r+b") as f:
        res = salvage_scan(f)
        version, index = res["version"], res["index"]
        report = _finish_report(dict(res["report"]))
        if report["clean"]:
            report["envelopes_restored"] = 0
            report["decode_failed"] = []
            return report
        patched = 0
        if version >= V3:
            f.seek(0)
            patched = _restore_envelopes(f, f.read(), index)
            f.flush()

        # footer metadata: prefer the old footer, then the header, then
        # the first readable chunk's own framing
        footer = res["footer"]
        if not footer.get("kernel") or not footer.get("level"):
            for k, e in enumerate(index):
                if e.get("q"):
                    continue
                f.seek(e["offset"])
                rec = f.read(e["length"])
                try:
                    blob = parse_chunk_record(rec, k, e["offset"],
                                              version >= V3)["blob"]
                except ValueError:
                    continue
                footer["kernel"] = footer.get("kernel") or KERNEL_BY_ID.get(blob[4])
                footer["level"] = footer.get("level") or (blob[5] & 0x7F)
                break

    # test-decode on the healed bytes: chunks whose frames verify can
    # still be undecodable when they dereference templates/params lost
    # with an earlier quarantined chunk — find those now, not at some
    # future read
    probe = LZJSReader(path, salvage=True)
    decode_failed = []
    try:
        by_off = {e["offset"]: e for e in index}
        for k in range(len(probe)):
            pe = probe.index[k]
            e = by_off.get(pe["offset"])
            if e is None:
                continue
            if pe.get("q"):
                e["q"] = e.get("q") or pe["q"]
                continue
            if probe._chunk_lines_or_skip(k) is None:
                e["q"] = probe.index[k]["q"]
                decode_failed.append(k)
    finally:
        probe.close()

    with open(path, "r+b") as f:
        for e in index:
            e.pop("g", None)
        footer["chunks"] = index
        fb = zlib.compress(json.dumps(footer).encode("utf-8"))
        f.seek(res["data_end"])
        f.write(fb)
        if version >= V3:
            f.write(integrity.trailer(fb))
        f.write(len(fb).to_bytes(8, "little"))
        f.write(FOOTER_MAGIC)
        f.truncate()
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass

    report["quarantined"] = [k for k, e in enumerate(index) if e.get("q")]
    report["envelopes_restored"] = patched
    report["decode_failed"] = decode_failed
    lost = []
    expect = 0
    for e in index:
        if e["line_start"] > expect:
            lost.append([expect, e["line_start"]])
        if e.get("q"):
            lost.append([e["line_start"], e["line_start"] + e["n_lines"]])
        expect = max(expect, e["line_start"] + e["n_lines"])
    if footer["n_lines"] > expect:
        lost.append([expect, footer["n_lines"]])
    report["lost_line_ranges"] = lost
    return report


def ensure_clean(path) -> dict:
    """fsck; repair only when needed. The ingestion daemon's tenant
    bootstrap (DESIGN.md §15): every (re)open runs this first, so a
    session killed mid-write is healed before WAL replay resumes it.
    Returns the report, extended with ``n_lines`` — the durable line
    count the WAL replay starts from."""
    report = fsck(path)
    if not report["clean"]:
        report = repair(path)
    rd = LZJSReader(path)
    try:
        report["n_lines"] = rd.n_lines
    finally:
        rd.close()
    return report
