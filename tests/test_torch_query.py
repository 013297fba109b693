"""The port's compressed-domain query engine against the JAX package's,
on the same archive bytes.

Archives are written by the reference (the port writes the same bytes,
``tests/test_torch_stream.py``): LZJF, LZJM and screened LZJS over an
HDFS corpus with a rare-template burst (the corpus of
``tests/test_query.py``), and screened and unscreened LZJS over a
synthetic HDFS corpus (the shape of ``tests/test_screens.py``'s). Over
the predicates of those tests, ``search``, ``count``, ``sample``,
``plan``, ``explain`` and ``extract_records`` must equal the
reference's, ``QueryStats`` field by field; so must the aggregations
``count_by_template``, ``top_k`` and ``time_histogram``, which run on
``device="cpu"`` here, and each must reach the port's
``ops.distinct_counts`` wherever it opens a chunk.
"""

import collections
import dataclasses
import io

import pytest

from repro.core import query as RQ
from repro.core.codec import LogzipConfig
from repro.core.ise import ISEConfig
from repro.core.parallel import compress_parallel
from repro.core.stream import StreamingCompressor
from repro.data.loggen import DATASETS, generate_lines
from repro_torch.core import query as Q
from repro_torch.kernels import ops

FMT = DATASETS["HDFS"]["format"]
BURST = [f"081109 203545 99 INFO dfs.FSNamesystem: Starting decommission of "
         f"node /10.9.{i % 7}.{i % 11} remaining {i}" for i in range(60)]


def _lzjs(lines, cfg, chunk_lines):
    buf = io.BytesIO()
    with StreamingCompressor(buf, cfg, chunk_lines=chunk_lines) as sc:
        sc.feed(lines)
    return buf.getvalue()


def _screens_corpus(n=2000):
    lines = []
    for i in range(n):
        head = f"081109 {203500 + i // 100} {i % 900}"
        if i % 3 == 0:
            lines.append(f"{head} INFO dfs.DataNode$PacketResponder: PacketResponder 1 for "
                         f"block blk_{900000000 + i} terminating")
        elif i % 3 == 1:
            lines.append(f"{head} INFO dfs.DataNode$DataXceiver: Receiving block "
                         f"blk_{800000000 + i} src: /10.250.{i % 20}.{i % 100}:"
                         f"{40000 + i % 1000} dest: /10.250.{i % 20}.{i % 100}:50010")
        else:
            lines.append(f"{head} WARN dfs.FSNamesystem: BLOCK* NameSystem.addStoredBlock: "
                         f"blockMap updated: 10.251.{i % 9}.{i % 13}:50010 is added "
                         f"to blk_{700000000 + i} size {1024 + i}")
    at = (n * 7) // 10
    for j in range(40):
        lines.insert(at, f"081109 203545 99 INFO dfs.FSNamesystem: Starting "
                         f"decommission of node /10.9.{j % 7}.{j % 11} remaining {j}")
    return lines


@pytest.fixture(scope="module")
def archives():
    """{name: (archive bytes, the lines it holds)}."""
    lines = list(generate_lines("HDFS", 2500, seed=11))
    lines[1700:1700] = BURST
    cfg = LogzipConfig(level=3, format=FMT, ise=ISEConfig(min_sample=200, max_iters=2))
    from repro.core.codec import compress

    scr = _screens_corpus()
    return {
        "lzjf": (compress(lines, cfg), lines),
        "lzjm": (compress_parallel(lines, cfg, n_workers=1, chunk_lines=500), lines),
        "lzjs": (_lzjs(lines, cfg, 320), lines),
        "screened": (_lzjs(scr, LogzipConfig(format=FMT, level=3), 300), scr),
        "unscreened": (_lzjs(scr, LogzipConfig(format=FMT, level=3, screens=False), 300), scr),
    }


def _stats(st) -> dict:
    return dataclasses.asdict(st)


# predicates as builders over either package's query module
PREDICATES = {
    **{f"substring {s!r}": (lambda s: lambda M: M.Substring(s))(s) for s in [
        "terminating", "decommission", "blk_", "WARN", "### corrupt",
        "no-such-needle-xyzzy", "", "size 1024 from", "blk_900000003", "blk_800003901",
        "blk_999999999", "10.251.3.7"]},
    **{f"regex {p!r}": (lambda p: lambda M: M.Regex(p))(p) for p in [
        r"blk_(-?\d+) terminating", r"decommission of node /10\.9\.\d+",
        r"^081109 2035\d\d 99 ", r"src: /10\.\d+\.\d+\.\d+:\d+", r"(?i:TERMINATING)"]},
    **{f"field {f}={v}": (lambda f, v: lambda M: M.FieldEq(f, v))(f, v) for f, v in [
        ("Level", "WARN"), ("Level", "TRACE"), ("Time", "203545"), ("Pid", "99"),
        ("Component", "dfs.FSNamesystem"), ("Time", "203541")]},
    "and line range": lambda M: M.And(M.LineRange(400, 1200), M.Substring("blk_")),
    "line range": lambda M: M.LineRange(0, 3),
    "event 0": lambda M: M.EventIs(0),
    "param range": lambda M: M.ParamRange(0, 0, 900000000, 900001000),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_search_count_and_plan_equal_reference(archives, name):
    for kind, (blob, _) in archives.items():
        pst, rst = Q.QueryStats(), RQ.QueryStats()
        hits = list(Q.search(blob, PREDICATES[name](Q), stats=pst))
        assert hits == list(RQ.search(blob, PREDICATES[name](RQ), stats=rst)), kind
        assert _stats(pst) == _stats(rst), kind
        pst, rst = Q.QueryStats(), RQ.QueryStats()
        assert Q.count(blob, PREDICATES[name](Q), stats=pst) == len(hits)
        RQ.count(blob, PREDICATES[name](RQ), stats=rst)
        assert _stats(pst) == _stats(rst), kind
        assert Q.plan(blob, PREDICATES[name](Q)) == RQ.plan(blob, PREDICATES[name](RQ)), kind


def test_substring_hits_equal_grep(archives):
    for kind, (blob, lines) in archives.items():
        for s in ("blk_", "decommission", "terminating"):
            assert list(Q.search(blob, Q.Substring(s))) == \
                [(i, l) for i, l in enumerate(lines) if s in l], kind


@pytest.mark.parametrize("kind", ["lzjf", "lzjm", "lzjs", "screened"])
def test_sample_explain_and_extract_equal_reference(archives, kind):
    blob, _ = archives[kind]
    pst, rst = Q.QueryStats(), RQ.QueryStats()
    assert Q.sample(blob, Q.Substring("blk_"), 5, stats=pst) == \
        RQ.sample(blob, RQ.Substring("blk_"), 5, stats=rst)
    assert _stats(pst) == _stats(rst)
    for needle in ("terminating", "blk_"):
        assert Q.explain(blob, Q.Substring(needle)) == RQ.explain(blob, RQ.Substring(needle))
    pst, rst = Q.QueryStats(), RQ.QueryStats()
    recs = list(Q.extract_records(blob, line_range=(100, 900), stats=pst))
    assert recs and recs == list(RQ.extract_records(blob, line_range=(100, 900), stats=rst))
    assert _stats(pst) == _stats(rst)
    event = recs[0]["event"]
    assert list(Q.extract_records(blob, event=event)) == \
        list(RQ.extract_records(blob, event=event))


def _most_frequent_event(blob):
    cbt = RQ.count_by_template(blob)
    return max(cbt, key=cbt.get)


AGGREGATIONS = {
    "count_by_template": lambda M, blob, **kw: M.count_by_template(blob, **kw),
    "top_k Level": lambda M, blob, **kw: M.top_k(blob, "Level", k=3, **kw),
    "top_k Pid": lambda M, blob, **kw: M.top_k(blob, "Pid", k=10, **kw),
    "top_k Component": lambda M, blob, **kw: M.top_k(blob, "Component", k=50, **kw),
    "top_k param": lambda M, blob, **kw: M.top_k(
        blob, event=_most_frequent_event(blob), star=0, k=5, **kw),
    "time_histogram 10": lambda M, blob, **kw: M.time_histogram(blob, "Time", bucket=10, **kw),
    "time_histogram 60": lambda M, blob, **kw: M.time_histogram(blob, "Time", bucket=60, **kw),
}


def _port(agg, blob, **kw):
    return AGGREGATIONS[agg](Q, blob, device="cpu", **kw)


@pytest.mark.parametrize("agg", list(AGGREGATIONS))
@pytest.mark.parametrize("kind", ["lzjf", "lzjm", "lzjs", "screened", "unscreened"])
def test_aggregations_equal_reference(archives, kind, agg):
    blob, _ = archives[kind]
    pst, rst = Q.QueryStats(), RQ.QueryStats()
    got = _port(agg, blob, stats=pst)
    assert got and got == AGGREGATIONS[agg](RQ, blob, stats=rst)
    assert _stats(pst) == _stats(rst)


def test_aggregations_equal_a_count_over_the_lines(archives):
    blob, lines = archives["screened"]
    heads = [line.split(" ", 5) for line in lines]
    level = collections.Counter(h[3] for h in heads)
    assert _port("top_k Level", blob) == sorted(level.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    pid = collections.Counter(h[2] for h in heads)
    assert _port("top_k Pid", blob) == sorted(pid.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    hist = collections.Counter(int(h[1]) // 10 for h in heads)
    assert _port("time_histogram 10", blob) == dict(sorted(hist.items()))
    events = collections.Counter(r["event"] for r in Q.extract_records(blob))
    assert _port("count_by_template", blob) == dict(events)


@pytest.mark.parametrize("agg", ["count_by_template", "top_k Level", "time_histogram 60"])
def test_aggregations_on_a_damaged_archive_equal_reference(archives, agg):
    blob, _ = archives["screened"]
    dead = blob[:-12] + b"\x00" * 12
    pst, rst = Q.QueryStats(), RQ.QueryStats()
    assert _port(agg, dead, stats=pst, salvage=True) == \
        AGGREGATIONS[agg](RQ, dead, stats=rst, salvage=True)
    assert _stats(pst) == _stats(rst)


@pytest.mark.parametrize("agg", list(AGGREGATIONS))
@pytest.mark.parametrize("kind", ["lzjf", "unscreened", "screened"])
def test_each_aggregation_reaches_distinct_counts(monkeypatch, archives, kind, agg):
    """One ``distinct_counts`` call per chunk the aggregation opens and
    finds rows in; a screened archive's ``count_by_template`` reads the
    manifests' histograms and calls nothing."""
    seen = []
    monkeypatch.setattr(ops, "input_hook", lambda name, args: seen.append((name, args)))
    blob, _ = archives[kind]
    st = Q.QueryStats()
    _port(agg, blob, stats=st)
    assert {name for name, _ in seen} <= {"distinct_counts"}
    if kind == "screened" and agg == "count_by_template":
        assert not seen and st.chunks_counted_from_manifest == st.chunks_total
    else:
        assert 0 < len(seen) <= st.chunks_opened
        assert sum(int(a[1].sum()) for _, a in seen) == st.hits


@pytest.mark.parametrize("typed", [False, True])
def test_header_distinct_equals_the_header_column(typed):
    """Header columns hold text, never ParaIDs. The reference's
    ``ChunkReader.header_distinct`` decodes a text header column of a
    level-3 chunk as ParaIDs (typed_columns=False, or a chunk whose
    column stays text), so its ``top_k`` / ``time_histogram`` on such an
    archive report ParamDict values: on 200 HDFS lines (seed 42) untyped,
    ``top_k("Level")`` gives ``[('112', 40), ('6297667978513372143', 39),
    ...]`` where the lines hold INFO 192, WARN 6. The port decodes them as
    ``header_column`` does and counts what the lines hold."""
    from repro.core.codec import compress
    from repro_torch.core.codec import ChunkReader, open_container

    lines = list(generate_lines("HDFS", 200, seed=42))
    blob = compress(lines, LogzipConfig(format=FMT, typed_columns=typed))
    cr = ChunkReader(*open_container(blob))
    for field in ("Date", "Time", "Pid", "Level", "Component"):
        uniq, inv = cr.header_distinct(field)
        assert [uniq[j] for j in inv] == cr.header_column(field)
    heads = [line.split(" ", 5) for line in lines if not line.startswith("###")]
    level = collections.Counter(h[3] for h in heads)
    want = sorted(level.items(), key=lambda kv: (-kv[1], kv[0]))
    assert Q.top_k(blob, "Level", device="cpu") == want
    hist = collections.Counter(int(h[1]) // 60 for h in heads)
    assert Q.time_histogram(blob, "Time", device="cpu") == dict(sorted(hist.items()))
    assert (RQ.top_k(blob, "Level") == want) is typed
