"""The port's durability layer against the JAX package's, byte for byte.

``repro_torch.core.{faultinject,wal}`` are the port's copies of the
reference's modules and ``repro_torch.core.recover`` its copy of
``repro.core.recover``. Over the fault matrix of
``tests/test_faultinject.py`` (same archive recipe: level 2, gzip, 500
lines, 120-line chunks; the port on ``device="cpu"``) the port's ``fsck``
and ``repair`` reports must equal the reference's on the same damaged
bytes, the repaired files must be equal, and the lines read back must be
equal. ``FaultyFile`` / ``FaultyOpener`` must land the same bytes and
raise on the same writes, and the WAL must write the same segment files
and replay the same records over the cases of
``tests/test_ingest_faults.py::TestWal``.
"""

import errno
import io
import os
from pathlib import Path

import pytest

from repro.core import faultinject as rfi
from repro.core import recover as rrecover
from repro.core import stream as rstream
from repro.core import wal as rwal
from repro.core.codec import LogzipConfig as RLogzipConfig
from repro_torch.core import faultinject as fi
from repro_torch.core import recover, stream, wal
from repro_torch.core.codec import LogzipConfig

FMT = "<Date> <Time> <Pid> <Level> <Component>: <Content>"
N_LINES = 500
CHUNK_LINES = 120
N_CHUNKS = -(-N_LINES // CHUNK_LINES)


def _lines(n: int = N_LINES) -> list[str]:
    return [
        f"081109 2035{i % 60:02d} {i} INFO dfs.DataNode$PacketResponder: "
        f"Received block blk_{(i * 2654435761) % 10**10} of size "
        f"{1000 + (i * 37) % 90000} from /10.250.{i % 256}.{i % 200}"
        for i in range(n)
    ]


def _cfg(pkg):
    """The fault suite's settings for ``pkg`` (the port on the CPU)."""
    if pkg == "port":
        return LogzipConfig(level=2, kernel="gzip", format=FMT, device="cpu")
    return RLogzipConfig(level=2, kernel="gzip", format=FMT)


# each package's modules, by name
PKGS = {"port": (stream, recover, fi, wal), "ref": (rstream, rrecover, rfi, rwal)}


def _session(pkg, sink, chunk_lines=CHUNK_LINES, **kw):
    return PKGS[pkg][0].StreamingCompressor(sink, _cfg(pkg), chunk_lines=chunk_lines, **kw)


@pytest.fixture(scope="module")
def archive():
    """(bytes, index, lines, footer_offset) of the clean v3 container, as
    the port writes it; the reference's is asserted equal."""
    lines = _lines()
    blobs = {}
    for pkg in PKGS:
        buf = io.BytesIO()
        sc = _session(pkg, buf)
        sc.feed(lines)
        sc.close()
        blobs[pkg] = buf.getvalue()
    assert blobs["port"] == blobs["ref"]
    data = blobs["port"]
    rd = stream.LZJSReader(io.BytesIO(data))
    index = [dict(e) for e in rd.index]
    fo = rd.footer_offset
    rd.close()
    assert len(index) == N_CHUNKS
    return data, index, lines, fo


def _read(mod, path, salvage=False) -> list[str]:
    rd = mod.LZJSReader(path, salvage=salvage)
    try:
        return rd.read_all()
    finally:
        rd.close()


def _repair_both(tmp_path, data: bytes, salvage=False) -> tuple[dict, list[str]]:
    """The same damaged bytes through each package's fsck and repair: the
    reports, the repaired files and the lines read back (in salvage mode
    with ``salvage``) must be equal -> (the port's repair report, its
    lines)."""
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"damaged-{pkg}.lzjs")
        with open(paths[pkg], "wb") as f:
            f.write(data)
    assert recover.fsck(paths["port"]) == rrecover.fsck(paths["ref"])
    rep = recover.repair(paths["port"])
    assert rep == rrecover.repair(paths["ref"])
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    got = _read(stream, paths["port"], salvage)
    assert got == _read(rstream, paths["ref"], salvage)
    return rep, got


def _committed(lines, index, n_bytes: int) -> list[str]:
    """Lines of every chunk whose commit lies inside the first ``n_bytes``."""
    out: list[str] = []
    for e in index:
        commit_end = e["sc"][0] if "sc" in e else e["offset"] + e["length"]
        if commit_end <= n_bytes:
            out.extend(lines[e["line_start"]:e["line_start"] + e["n_lines"]])
    return out


def test_clean_archive_equals_reference(archive):
    data, _, lines, _ = archive
    assert recover.fsck(io.BytesIO(data)) == rrecover.fsck(io.BytesIO(data))
    assert _read(stream, io.BytesIO(data)) == lines


# --------------------------------------------------------- torn writes

CUTS = {"start": lambda e: e["offset"], "start+1": lambda e: e["offset"] + 1,
        "mid": lambda e: e["offset"] + e["length"] // 2,
        "end-1": lambda e: e["offset"] + e["length"] - 1,
        "end": lambda e: e["offset"] + e["length"]}


@pytest.mark.parametrize("where", list(CUTS))
@pytest.mark.parametrize("k", range(N_CHUNKS))
def test_torn_write_at_record_boundary(archive, tmp_path, k, where):
    data, index, lines, _ = archive
    cut = CUTS[where](index[k])
    rep, got = _repair_both(tmp_path, data[:cut])
    assert got == _committed(lines, index, cut)
    assert not rep["quarantined"]


def test_torn_write_every_137th_byte(archive, tmp_path):
    data, index, lines, _ = archive
    for cut in list(range(index[0]["offset"], len(data), 137)) + [len(data) - 1]:
        rep, got = _repair_both(tmp_path, data[:cut])
        assert got == _committed(lines, index, cut), cut
        assert not rep["quarantined"], cut


# ----------------------------------------------------------- bit flips

FRAMES = ("payload", "template_delta", "paramdict_delta", "magic", "blob_varint", "commit")


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("k", range(N_CHUNKS))
def test_bit_flip_in_every_frame_type(archive, tmp_path, k, frame):
    data, index, lines, _ = archive
    e = index[k]
    off = e["offset"]
    rec = stream.parse_chunk_record(data[off:off + e["length"]], k, off, True)
    (bo, bl), (to, tl), (po, pl), _ = stream.frame_positions(
        len(rec["blob"]), len(rec["td"]), len(rec["pd"]))
    pos = {"payload": off + bo + bl // 2, "template_delta": off + to + tl // 2,
           "paramdict_delta": off + po + pl // 2, "magic": off, "blob_varint": off + 4,
           "commit": off + rec["commit_at"] + 6}[frame]
    rep, got = _repair_both(tmp_path, fi.flip_bit(data, pos))
    if frame in ("magic", "blob_varint", "commit"):
        assert got == lines and not rep["quarantined"]
    else:
        assert k in rep["quarantined"]
        assert [e["line_start"], e["line_start"] + e["n_lines"]] in rep["lost_line_ranges"]
        assert got == [line for i, line in enumerate(lines)
                       if not any(a <= i < b for a, b in rep["lost_line_ranges"])]


def test_bit_flip_footer(archive, tmp_path):
    data, _, lines, footer_offset = archive
    rep, got = _repair_both(tmp_path, fi.flip_bit(data, footer_offset + 10))
    assert got == lines and not rep["quarantined"] and not rep["lost_line_ranges"]


def test_bit_flip_header(archive, tmp_path):
    """Header damage: equal fsck reports, salvage reads every line in
    both, before and after repair, which acts the same in both."""
    data, _, lines, _ = archive
    bad = fi.flip_bit(data, 8)
    rep = recover.fsck(io.BytesIO(bad))
    assert not rep["header_ok"] and not rep["clean"]
    assert _read(stream, io.BytesIO(bad), True) == lines
    assert _read(rstream, io.BytesIO(bad), True) == lines
    assert _repair_both(tmp_path, bad, salvage=True)[1] == lines


def test_double_fault_commit_and_footer(archive, tmp_path):
    data, index, lines, footer_offset = archive
    e = index[2]
    rec = stream.parse_chunk_record(data[e["offset"]:e["offset"] + e["length"]],
                                    2, e["offset"], True)
    bad = fi.flip_bit(fi.flip_bit(data, e["offset"] + rec["commit_at"] + 6), footer_offset + 10)
    rep, got = _repair_both(tmp_path, bad)
    assert got == lines and not rep["quarantined"]


# ----------------------------------------------- ENOSPC / kill-mid-close

@pytest.mark.parametrize("k", [1, 3])
def test_enospc_mid_chunk(archive, tmp_path, k):
    """Each package's session writes through its own ``FaultyFile`` until
    the disk fills halfway into chunk ``k``: the same bytes land."""
    data, index, lines, _ = archive
    cut = index[k]["offset"] + index[k]["length"] // 2
    landed = {}
    for pkg, (_, _, finj, _) in PKGS.items():
        ff = finj.FaultyFile(io.BytesIO(), write_limit=cut)
        sc = _session(pkg, ff, pipeline=False)
        with pytest.raises(OSError):
            sc.feed(lines)
            sc.close()
        landed[pkg] = ff.getvalue()
    assert landed["port"] == landed["ref"] and len(landed["port"]) == cut
    rep, got = _repair_both(tmp_path, landed["port"])
    assert got == _committed(lines, index, cut) and not rep["quarantined"]


def test_kill_mid_close(archive, tmp_path):
    data, _, lines, _ = archive
    cut = len(data) - 40  # inside the footer
    landed = {}
    for pkg, (_, _, finj, _) in PKGS.items():
        ff = finj.FaultyFile(io.BytesIO(), write_limit=cut)
        sc = _session(pkg, ff, pipeline=False)
        sc.feed(lines)
        with pytest.raises(OSError):
            sc.close()
        landed[pkg] = ff.getvalue()
    assert landed["port"] == landed["ref"]
    rep, got = _repair_both(tmp_path, landed["port"])
    assert got == lines and not rep["quarantined"] and not rep["lost_line_ranges"]


def test_crash_mid_append(archive, tmp_path):
    """Kill an append session after its chunks' records landed: both
    packages repair to the same file, and a further append after the
    repair writes the same bytes."""
    data, _, lines, _ = archive
    extra = [f"appended event number {i} with payload {i * 17}" for i in range(100)]
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"append-{pkg}.lzjs")
        with open(paths[pkg], "wb") as f:
            f.write(data)
        sc = _session(pkg, paths[pkg], 50, append=True, pipeline=False)
        for line in extra:
            sc.feed_line(line)
        sc._f.flush()
        sc._f.close()
    reports = [mods[1].repair(paths[pkg]) for pkg, mods in PKGS.items()]
    assert reports[0] == reports[1] and not reports[0]["quarantined"]
    blobs = [Path(p).read_bytes() for p in paths.values()]
    assert blobs[0] == blobs[1]
    assert _read(stream, paths["port"]) == lines + extra
    for pkg in PKGS:
        with _session(pkg, paths[pkg], append=True) as sc:
            sc.feed_line("one more after repair")
    blobs = [Path(p).read_bytes() for p in paths.values()]
    assert blobs[0] == blobs[1]
    assert _read(stream, paths["port"]) == lines + extra + ["one more after repair"]


@pytest.mark.parametrize("state", ["clean", "torn", "salvaged"])
def test_ensure_clean_equals_reference(archive, tmp_path, state):
    """``ensure_clean`` on a clean file (left untouched), a file torn
    inside chunk 3 and a file whose footer is gone (read by salvage):
    equal reports, line counts and files."""
    data, index, lines, _ = archive
    bad = {"clean": data, "torn": data[:index[3]["offset"] + index[3]["length"] // 2],
           "salvaged": data[:-100]}[state]
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"{state}-{pkg}.lzjs")
        with open(paths[pkg], "wb") as f:
            f.write(bad)
    rep = recover.ensure_clean(paths["port"])
    assert rep == rrecover.ensure_clean(paths["ref"])
    blobs = [Path(p).read_bytes() for p in paths.values()]
    assert blobs[0] == blobs[1]
    assert rep["n_lines"] == len(_committed(lines, index, len(bad)))
    if state == "clean":
        assert rep["clean"] and blobs[0] == data


# ------------------------------------------------ FaultyFile / FaultyOpener

WRITES = [b"12345678", b"abcdef", b"", b"x", b"longer chunk of bytes", b"yz"]


def _drive(ff) -> list:
    """Each write's outcome: the count it returned, or the errno raised."""
    out = []
    for w in WRITES:
        try:
            out.append(ff.write(w))
        except OSError as e:
            out.append(("raised", e.errno))
    try:
        ff.flush()
        out.append("flushed")
    except OSError as e:
        out.append(("flush raised", e.errno))
    return out


@pytest.mark.parametrize("limit", [None, 0, 1, 8, 10, 14, 15, 37])
def test_faultyfile_semantics_equal_reference(limit):
    got = {}
    for pkg, (_, _, finj, _) in PKGS.items():
        ff = finj.FaultyFile(io.BytesIO(), write_limit=limit)
        got[pkg] = (_drive(ff), ff.getvalue(), ff.bytes_written, ff.broken, ff.faults)
    assert got["port"] == got["ref"]
    if limit is not None:
        assert len(got["port"][1]) == min(limit, sum(map(len, WRITES)))


@pytest.mark.parametrize("limit", [None, 5, 20])
def test_faultyopener_shares_one_budget_equal_reference(tmp_path, limit):
    """Two files of one opener fill one disk; a read-only open passes
    through; ``reset`` frees the disk. The same writes raise ENOSPC and
    the same bytes land in each package."""
    got = {}
    for pkg, (_, _, finj, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        op = finj.FaultyOpener(limit)
        a, b = op(d / "a", "wb"), op(d / "b", "ab")
        outcomes = []
        for f, w in ((a, b"0123456789"), (b, b"abcdefgh"), (a, b"XY"), (b, b"z")):
            try:
                outcomes.append(f.write(w))
            except OSError as e:
                outcomes.append(("raised", e.errno))
        a.close()
        b.close()
        state = (op.bytes_written, op.broken, op.faults)
        op.reset()
        with op(d / "a", "rb") as r:
            plain = not isinstance(r, finj.FaultyFile)
            first = r.read()
        got[pkg] = (outcomes, state, (d / "a").read_bytes(), (d / "b").read_bytes(), plain,
                    first, (op.bytes_written, op.broken, op.faults))
    assert got["port"] == got["ref"]
    assert ("raised", errno.ENOSPC) in got["port"][0] or limit is None or limit >= 21


# ------------------------------------------------------------------ WAL

def _line(i: int) -> str:
    return (f"081109 2035{i % 60:02d} {i} INFO dfs.DataNode$PacketResponder: "
            f"Received block blk_{i * 7 + 1} of size {i * 512} from /10.0.0.{i % 256}")


def _replay(mod, d, start=0) -> tuple:
    rep = mod.replay_wal(d, start=start)
    return rep.records, rep.end_seq, rep.torn, rep.segments


def _segments(mod, d) -> dict:
    return {os.path.basename(p): Path(p).read_bytes() for _, p in mod._segment_paths(d)}


def _feed_wal(pkg, d, segment_bytes, n=12, every=3):
    mod = PKGS[pkg][3]
    nasty = b"\xff\xfe raw bytes \x80".decode("utf-8", "surrogateescape")
    with mod.WalWriter(d, segment_bytes=segment_bytes) as w:
        for i in range(n):
            w.append(nasty if i == 5 else _line(i))
            if (i + 1) % every == 0:
                w.sync()
        w.append(_line(n))  # staged; close makes it durable


@pytest.mark.parametrize("segment_bytes", [64, 1 << 20])
def test_wal_segments_equal_reference(tmp_path, segment_bytes):
    for pkg in PKGS:
        _feed_wal(pkg, str(tmp_path / pkg), segment_bytes)
    segs = _segments(wal, str(tmp_path / "port"))
    assert segs == _segments(rwal, str(tmp_path / "ref"))
    assert len(segs) == (5 if segment_bytes == 64 else 1)  # a segment a sync
    rep = _replay(wal, str(tmp_path / "port"))
    assert rep == _replay(rwal, str(tmp_path / "ref"))
    assert [s for s, _ in rep[0]] == list(range(13)) and not rep[2]


def test_wal_replay_torn_at_every_byte_equal_reference(tmp_path):
    d = str(tmp_path / "w")
    with wal.WalWriter(d) as w:
        for i in range(8):
            w.append(_line(i))
        w.sync()
    (_, seg), = wal._segment_paths(d)
    blob = open(seg, "rb").read()
    assert wal._HEADER_LEN == rwal._HEADER_LEN
    for cut in range(wal._HEADER_LEN, len(blob) + 1):
        with open(seg, "wb") as f:
            f.write(blob[:cut])
        assert _replay(wal, d) == _replay(rwal, d), cut
    pos = wal._HEADER_LEN
    while pos < len(blob):
        assert wal.parse_record(blob, pos) == rwal.parse_record(blob, pos)
        pos = wal.parse_record(blob, pos)[2]


def test_wal_torn_header_equal_reference(tmp_path):
    d = str(tmp_path / "w")
    with wal.WalWriter(d, segment_bytes=64) as w:
        for i in range(4):
            w.append(_line(i))
            w.sync()
    segs = wal._segment_paths(d)
    blob = open(segs[0][1], "rb").read()
    with open(segs[0][1], "wb") as f:
        f.write(fi.flip_bit(blob, 1))
    rep = _replay(wal, d)
    assert rep == _replay(rwal, d)
    assert rep[2] and [s for s, _ in rep[0]] == [1, 2, 3]


@pytest.mark.parametrize("watermark", [0, 3, 4, 100])
def test_wal_gc_equal_reference(tmp_path, watermark):
    """``gc`` by a live writer and by one restarted on segments it found
    on disk: the same files are left."""
    left = {}
    for pkg in PKGS:
        mod = PKGS[pkg][3]
        d = str(tmp_path / pkg)
        w = mod.WalWriter(d, segment_bytes=64)
        for i in range(6):
            w.append(_line(i))
            w.sync()
        removed = w.gc(watermark)
        w.close()
        w2 = mod.WalWriter(d, next_seq=mod.replay_wal(d).end_seq, segment_bytes=64)
        w2.append(_line(6))
        w2.sync()
        removed2 = w2.gc(watermark + 2)
        w2.close()
        left[pkg] = (removed, removed2, _segments(mod, d))
    assert left["port"] == left["ref"]


def test_wal_missing_record_raises_in_both(tmp_path):
    d = str(tmp_path / "w")
    with wal.WalWriter(d, segment_bytes=64) as w:
        for i in range(4):
            w.append(_line(i))
            w.sync()
    os.unlink(wal._segment_paths(d)[1][1])
    with pytest.raises(wal.WalError, match="gap"):
        wal.replay_wal(d)
    with pytest.raises(rwal.WalError, match="gap"):
        rwal.replay_wal(d)


def test_wal_enospc_sync_goes_to_a_fresh_segment_in_both(tmp_path):
    got = {}
    for pkg, (_, _, finj, mod) in PKGS.items():
        d = str(tmp_path / pkg)
        op = finj.FaultyOpener()
        w = mod.WalWriter(d, opener=op)
        w.append("a" * 40)
        assert w.sync() == 1
        op.write_limit = op.bytes_written + 10
        w.append("b" * 40)
        w.append("c" * 40)
        with pytest.raises(OSError):
            w.sync()
        durable = w.durable_seq
        op.write_limit = None
        op.reset()
        after = w.sync()
        w.close()
        got[pkg] = (durable, after, _segments(mod, d), *_replay(mod, d))
    assert got["port"] == got["ref"]
    durable, after, segs, records, _, torn, _ = got["port"]
    assert (durable, after, len(segs), torn) == (1, 3, 2, True)
    assert [(s, t[0]) for s, t in records] == [(0, "a"), (1, "b"), (2, "c")]
