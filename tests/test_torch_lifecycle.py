"""The port's archive lifecycle against the JAX package's, byte for byte.

``repro_torch.lifecycle`` is the port's copy of ``repro.lifecycle``:
``recluster`` exactly, ``compact`` and ``retention`` with a ``device``
argument (here ``"cpu"``, where each kernel wrapper runs its plain torch
version). Over the cases of ``tests/test_lifecycle.py`` each package
compacts the same input sessions in a directory of its own; the output
bytes, the reports (paths taken relative to that directory), the remap
tables and the lines read back must be equal. ``bench_compaction``'s
input (``benchmarks/throughput.py``: three duplicate-heavy HDFS tenants
under ``ISE_FAST``) is one of the cases, at 1,800 lines.
"""

import collections
import functools
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks.throughput import ISE_FAST, _dup_heavy
from repro import lifecycle as rlifecycle
from repro.core import recover as rrecover
from repro.core import stream as rstream
from repro.core.ise import ISEConfig as RISEConfig
from repro.core.stages import LogzipConfig as RLogzipConfig
from repro.data.loggen import DATASETS, generate_lines, generate_multitenant
from repro.ingest import service as rservice
from repro.lifecycle import recluster as rrecluster
from repro.lifecycle import retention as rretention
from repro_torch import lifecycle
from repro_torch.core import query, recover, stream
from repro_torch.core.ise import ISEConfig
from repro_torch.core.stages import LogzipConfig
from repro_torch.ingest import service
from repro_torch.lifecycle import recluster, retention

FMT = "<Date> <Time> <Pid> <Level> <Component>: <Content>"


def _port_cfg(**kw):
    return LogzipConfig(device="cpu", **kw)


def _port_compact(*a, **kw):
    return lifecycle.compact(*a, device="cpu", **kw)


PKGS = {
    "ref": SimpleNamespace(
        Cfg=RLogzipConfig, ISE=RISEConfig, stream=rstream, recover=rrecover,
        compact=rlifecycle.compact, Policy=rlifecycle.RetentionPolicy,
        Manager=rlifecycle.RetentionManager, recluster=rrecluster,
        prune=rretention.prune_manifests, Store=rservice.TenantStore,
        Worker=rservice.TenantWorker, store_kw={}, roll_kw={}),
    "port": SimpleNamespace(
        Cfg=_port_cfg, ISE=ISEConfig, stream=stream, recover=recover, compact=_port_compact,
        Policy=lifecycle.RetentionPolicy, Manager=lifecycle.RetentionManager,
        recluster=recluster, prune=retention.prune_manifests, Store=service.TenantStore,
        Worker=service.TenantWorker, store_kw={"device": "cpu"}, roll_kw={"device": "cpu"}),
}


def _cfg(k, fmt=FMT, **kw):
    return k.Cfg(level=3, kernel="gzip", format=fmt, **kw)


_SESSIONS: dict = {}


def _session(k, path, lines, fmt=FMT, chunk_lines=200, ise=None):
    """Write the LZJS session of ``lines`` at ``path``. Each package writes
    it once (the port's plain matcher is slow on the CPU) and the two must
    be equal; every case then starts from those bytes."""
    key = (hash("\n".join(lines)), len(lines), fmt, chunk_lines, ise)
    if key not in _SESSIONS:
        blobs = []
        for kk in PKGS.values():
            cfg = _cfg(kk, fmt) if ise is None else _cfg(kk, fmt, ise=kk.ISE(**dict(ise)))
            buf = io.BytesIO()
            with kk.stream.StreamingCompressor(buf, cfg, chunk_lines=chunk_lines) as sc:
                sc.feed(lines)
            blobs.append(buf.getvalue())
        assert blobs[0] == blobs[1]
        _SESSIONS[key] = blobs[0]
    with open(path, "wb") as f:
        f.write(_SESSIONS[key])
    return str(path)


def _read(k, path):
    rd = k.stream.LZJSReader(path)
    try:
        return rd.read_range(0, rd.n_lines)
    finally:
        rd.close()


def _rel(obj, root):
    """``obj`` with every path under ``root`` made relative to it."""
    if isinstance(obj, str):
        return obj.replace(root + os.sep, "")
    if isinstance(obj, dict):
        return {_rel(a, root): _rel(b, root) for a, b in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rel(v, root) for v in obj)
    return obj


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _both(case, tmp_path, *args):
    got = {}
    for name, k in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        got[name] = _rel(case(k, str(root), *args), str(root))
    assert got["port"] == got["ref"]
    return got["port"]


@pytest.fixture(scope="module")
def tenant_streams():
    streams = collections.defaultdict(list)
    for t, line in generate_multitenant(
            [("a", "HDFS"), ("b", "HDFS"), ("c", "HDFS")], 1800, seed=5):
        streams[t].append(line)
    return streams


@pytest.fixture(scope="module")
def hdfs():
    return list(generate_lines("HDFS", 2500, seed=11))


# ------------------------------------------------------- re-clustering

RECLUSTER_CASES = {
    "fold_near_duplicates": ("fold", [("open", "file", None, "mode", "rw"),
                                      ("open", "file", "core.log", "mode", "rw"),
                                      ("close", "handle", None)], [100, 10, 5]),
    "fold_no_all_star": ("fold", [("x", None), (None, "x")], [2, 1]),
    "gc_fold_remap": ("recluster", [[("open", "file", None), ("never", "used", None)],
                                    [("open", "file", "core.log")]],
                      [{0: 50}, {0: 3}], {}),
    "deterministic": ("recluster", [[("a", None, "x"), ("b", "y", None)], [("a", None, "z")]],
                      [{0: 5, 1: 5}, {0: 5}], {}),
    "specialization": ("recluster", [[("mount", None, "ok")]], [{0: 9}],
                       {"specialize": {("mount", None, "ok"): {0: "/dev/sda1"}}}),
    "salvage_padding": ("recluster", [[None, ("live", None)]], [{0: 4, 1: 4}], {}),
    "no_fold": ("recluster", [[("open", "file", None)], [("open", "file", "core.log")]],
                [{0: 5}, {0: 5}], {"fold": False}),
    "specialize_template": ("specialize", ("a", None, "b", None), {0: "J", 1: "K"}),
}


@pytest.mark.parametrize("name", list(RECLUSTER_CASES))
def test_recluster_case_equals_reference(name):
    kind, *args = RECLUSTER_CASES[name]
    got = {}
    for pkg, k in PKGS.items():
        if kind == "fold":
            got[pkg] = k.recluster.fold_templates(*args)
        elif kind == "specialize":
            got[pkg] = k.recluster.specialize_template(*args)
        else:
            tpls, usage, kw = args
            res = k.recluster.recluster_stores(tpls, usage, **kw)
            got[pkg] = (res.store.templates, res.remaps, res.report)
    assert got["port"] == got["ref"]


def test_recluster_random_stores_equal_reference():
    """Random stores over a small vocabulary, so that folds happen."""
    rng = np.random.default_rng(3)
    vocab = ["open", "close", "file", "blk", "read", "write", "ok", "fail"]
    stores, usage = [], []
    for _ in range(3):
        tpls = []
        for _ in range(int(rng.integers(5, 15))):
            n = int(rng.integers(2, 7))
            tpls.append(tuple(None if rng.random() < 0.3 else str(rng.choice(vocab))
                              for _ in range(n)))
        stores.append(tpls)
        usage.append({g: int(rng.integers(0, 30)) for g in range(len(tpls))})
    got = {pkg: k.recluster.recluster_stores(stores, usage) for pkg, k in PKGS.items()}
    assert got["port"].store.templates == got["ref"].store.templates
    assert got["port"].remaps == got["ref"].remaps
    assert got["port"].report == got["ref"].report


# ------------------------------------------------ merged == concatenation

def _report(rep):
    return rep.to_dict(), rep.remaps


def _tenants(k, root, streams, **kw):
    paths, want = [], []
    for t in sorted(streams):
        paths.append(_session(k, os.path.join(root, f"{t}.lzjs"), streams[t], **kw))
        want += streams[t]
    return paths, want


def _roundtrip(k, root, streams):
    paths, want = _tenants(k, root, streams)
    out = os.path.join(root, "merged.lzjs")
    rep = k.compact(paths, out)
    assert _read(k, out) == want
    assert rep.lost_lines == 0 and not rep.skipped
    assert k.recover.fsck(out)["clean"]
    return _report(rep), _files(root)


def _deterministic(k, root, streams):
    paths, _ = _tenants(k, root, streams)
    o1, o2 = os.path.join(root, "m1.lzjs"), os.path.join(root, "m2.lzjs")
    r1, r2 = k.compact(paths, o1), k.compact(paths, o2)
    assert r1.remaps == r2.remaps
    with open(o1, "rb") as f1, open(o2, "rb") as f2:
        assert f1.read() == f2.read()
    return _report(r1), _files(root)


def _no_fold_no_specialize(k, root, streams):
    paths, want = _tenants(k, root, streams)
    out = os.path.join(root, "m.lzjs")
    rep = k.compact(paths, out, fold=False, specialize=False, chunk_lines=256,
                    kernel="bzip2", level=2)
    assert _read(k, out) == want
    return _report(rep), _files(root)


def _salvaged_input(k, root, streams):
    paths, _ = _tenants(k, root, streams)
    span = _quarantine_chunk(k, paths[1], 1)
    out = os.path.join(root, "m.lzjs")
    rep = k.compact(paths, out)
    assert len(rep.skipped) == 1 and rep.lost_lines == span[1]
    assert k.recover.fsck(out)["clean"]
    return span, _report(rep), _files(root)


def _strict_refuses_damage(k, root, streams):
    paths, _ = _tenants(k, root, {"a": streams["a"]})
    _quarantine_chunk(k, paths[0], 0)
    with pytest.raises(ValueError) as ei:
        k.compact(paths, os.path.join(root, "m.lzjs"), salvage=False)
    return str(ei.value), _files(root)


def _query_on_compacted(k, root, streams):
    paths, want = _tenants(k, root, streams)
    out = os.path.join(root, "m.lzjs")
    k.compact(paths, out, chunk_lines=256)
    with open(out, "rb") as f:
        blob = f.read()
    hits = {}
    for needle in ("PacketResponder", "blk_", "no-such-needle-zz"):
        hits[needle] = list(query.search(blob, query.Substring(needle)))
        assert hits[needle] == [(i, ln) for i, ln in enumerate(want) if needle in ln]
    events = sorted({r["event"] for r in query.extract_records(blob)})
    assert events
    return hits, events, _files(root)


COMPACT_CASES = [_roundtrip, _deterministic, _no_fold_no_specialize, _salvaged_input,
                 _strict_refuses_damage, _query_on_compacted]


@pytest.mark.parametrize("case", COMPACT_CASES, ids=lambda c: c.__name__.strip("_"))
def test_compact_case_equals_reference(tmp_path, tenant_streams, case):
    _both(case, tmp_path, tenant_streams)


def _quarantine_chunk(k, path, chunk):
    """Corrupt ``chunk``'s payload, then repair: the chunk is quarantined
    with its line range recorded."""
    rd = k.stream.LZJSReader(path)
    off = rd.index[chunk]["offset"] + 40
    span = (rd.index[chunk]["line_start"], rd.index[chunk]["n_lines"])
    rd.close()
    with open(path, "r+b") as f:
        f.seek(off)
        f.write(b"\xff" * 16)
    k.recover.repair(path)
    return span


def _single_input(k, root, hdfs):
    p = _session(k, os.path.join(root, "a.lzjs"), hdfs, chunk_lines=128)
    out = os.path.join(root, "m.lzjs")
    rep = k.compact([p], out)
    assert _read(k, out) == hdfs
    assert rep.bytes_out < os.path.getsize(p)
    return _report(rep), _files(root)


def _mixed_formats_and_empty(k, root, hdfs):
    p1 = _session(k, os.path.join(root, "a.lzjs"), hdfs[:300])
    p2 = _session(k, os.path.join(root, "b.lzjs"), hdfs[300:600], fmt=None)
    errors = []
    for inputs in ([p1, p2], []):
        with pytest.raises(ValueError) as ei:
            k.compact(inputs, os.path.join(root, "m.lzjs"))
        errors.append(str(ei.value))
    return errors, _files(root)


def _bench_compaction_input(k, root, hdfs):
    """``bench_compaction``'s input at 1,800 lines: three duplicate-heavy
    tenants, ``ISE_FAST``, chunks of ``max(500, per_tenant // 8)``."""
    per_tenant = 600
    ise = (("sample_rate", ISE_FAST.sample_rate), ("min_sample", ISE_FAST.min_sample),
           ("max_iters", ISE_FAST.max_iters))
    paths, want = [], []
    for i in range(3):
        lines = _dup_heavy("HDFS", per_tenant, seed=i)
        paths.append(_session(k, os.path.join(root, f"tenant{i}.lzjs"), lines,
                              fmt=DATASETS["HDFS"]["format"], ise=ise,
                              chunk_lines=max(500, per_tenant // 8)))
        want += lines
    out = os.path.join(root, "merged.lzjs")
    rep = k.compact(paths, out)
    assert rep.bytes_out < rep.bytes_in
    assert _read(k, out) == want and k.recover.fsck(out)["clean"]
    return _report(rep), _files(root)


@pytest.mark.parametrize("case", [_single_input, _mixed_formats_and_empty,
                                  _bench_compaction_input],
                         ids=lambda c: c.__name__.strip("_"))
def test_compact_input_case_equals_reference(tmp_path, hdfs, case):
    _both(case, tmp_path, hdfs)


def _random_sessions(seed):
    """Sessions over a NUL / multibyte / CR alphabet, as the reference's
    property test draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    alphabet = list("ab \x00\ré𝛑,:=")
    out = []
    for _ in range(int(rng.integers(1, 5))):
        out.append(["".join(rng.choice(alphabet, int(rng.integers(0, 19))))
                    for _ in range(int(rng.integers(0, 41)))])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_compact_random_sessions_equal_reference(tmp_path, seed):
    sessions = _random_sessions(seed)

    def case(k, root):
        cfg = k.Cfg(level=3, kernel="gzip", format=None)
        paths, want = [], []
        for i, lines in enumerate(sessions):
            p = os.path.join(root, f"s{i}.lzjs")
            with k.stream.StreamingCompressor(p, cfg, chunk_lines=16) as sc:
                sc.feed(lines)
            paths.append(p)
            want += lines
        out = os.path.join(root, "m.lzjs")
        rep = k.compact(paths, out, chunk_lines=32)
        assert _read(k, out) == want and rep.lost_lines == 0
        return _report(rep), _files(root)

    _both(case, tmp_path)


# --------------------------------------------------------- retention

def _roll_seal_rollup(k, root):
    pol = k.Policy(rollup_after=2, kernel="gzip", chunk_lines=512)
    mgr = k.Manager(root, pol, clock=lambda: 1754700000.0)
    want, results = [], []
    for i in range(2):
        lines = list(generate_lines("HDFS", 500, seed=20 + i))
        want += lines
        _session(k, os.path.join(root, "acme.lzjs"), lines, chunk_lines=128)
        results.append(mgr.roll_tenant("acme", **k.roll_kw))
    tiers = mgr.tiers("acme")
    assert tiers["hot"] is None and tiers["sealed"] == [] and len(tiers["rollup"]) == 1
    assert _read(k, tiers["rollup"][0]) == want
    return results, tiers, _files(root)


def _refuses_roll_with_live_wal(k, root):
    p = _session(k, os.path.join(root, "acme.lzjs"), list(generate_lines("HDFS", 50, seed=1)))
    os.makedirs(p + ".wal")
    res = k.Manager(root, k.Policy()).roll_tenant("acme", **k.roll_kw)
    assert res and "skipped" in res and os.path.exists(p)
    return res, k.Manager(root, k.Policy()).roll_tenant("ghost", **k.roll_kw), _files(root)


def _prune_manifests(k, root):
    lines = []
    for i, ln in enumerate(generate_lines("HDFS", 800, seed=11)):
        lines.append(ln)
        if i % 97 == 0:
            lines.append(f"!!corrupt frame {i}??")
    p = _session(k, os.path.join(root, "a.lzjs"), lines, chunk_lines=128)
    pruned = k.prune(p)
    assert pruned > 0 and k.recover.fsck(p)["clean"]
    with open(p, "rb") as f:
        hits = list(query.search(f.read(), query.Substring("corrupt frame")))
    assert hits == [(i, ln) for i, ln in enumerate(lines) if "corrupt frame" in ln]
    return pruned, _files(root)


def _daemon_roll_over(k, root):
    """A tenant worker drains -> seal -> the retention hook moves the hot
    session into the sealed tier."""
    lines = list(generate_lines("HDFS", 200, seed=11))
    mgr = k.Manager(root, k.Policy(rollup_after=None, kernel="gzip", chunk_lines=256))
    st = k.Store(root, "t", _cfg(k), chunk_lines=64, **k.store_kw)
    w = k.Worker(st, on_seal=functools.partial(mgr.roll_tenant, **k.roll_kw))
    w.start()
    for i, ln in enumerate(lines):
        w.queue.put(("line", i, ln))
    w.queue.put(None)
    assert w.done.wait(60.0)
    assert w.failed is None
    tiers = mgr.tiers("t")
    assert tiers["hot"] is None and len(tiers["sealed"]) == 1
    assert _read(k, tiers["sealed"][0]) == lines
    return tiers, _files(root)


@pytest.mark.parametrize("case", [_roll_seal_rollup, _refuses_roll_with_live_wal,
                                  _prune_manifests, _daemon_roll_over],
                         ids=lambda c: c.__name__.strip("_"))
def test_retention_case_equals_reference(tmp_path, case):
    _both(case, tmp_path)


# ------------------------------------------------------------ no card here --

def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' runs the kernels")
    src = tmp_path / "a.lzjs"
    buf = io.BytesIO()
    with stream.StreamingCompressor(buf, _port_cfg(format=FMT)) as sc:
        sc.feed(["x"])
    src.write_bytes(buf.getvalue())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lifecycle.compact([str(src)], str(tmp_path / "m.lzjs"))
    assert not (tmp_path / "m.lzjs").exists()
    mgr = lifecycle.RetentionManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.roll_tenant("a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.rollup("a")
    assert (tmp_path / "a.lzjs").exists() and not (tmp_path / "sealed").exists()
    assert mgr.roll_tenant("ghost", device="cpu") is None
