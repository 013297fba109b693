"""The port's ingest daemon against the JAX package's, byte for byte.

``repro_torch.ingest`` is the port's copy of ``repro.ingest`` with a
``device`` argument (here ``"cpu"``, where each kernel wrapper runs its
plain torch version). Every case runs once on each package, from the same
inputs, in a directory of its own:

- ``TenantStore`` with no sockets, over the cases of
  ``tests/test_ingest_faults.py`` (torn journal tails, a crash at every
  ack watermark, ENOSPC on the journal and on the archive, forced flushes
  by bytes and by an injected clock): every file the store leaves (the
  archive and the journal's segments), the resume points, the replayed
  records and the acked watermarks are equal.
- ``IngestDaemon`` over a unix socket, over the feeds of
  ``tests/test_ingest_service.py``: decoded lines, ack watermarks and
  error codes are equal, and so are the archive bytes wherever
  ``chunk_lines`` and the client's flushes fix the chunk cuts. Where a
  worker's timing decides them (a forced abort mid-drain), the lines are
  compared.
- A reference client feeds a port daemon and a port client a reference
  daemon; each package reads the other's archive.

Every socket test bounds its waits (``wait_ack(timeout=)``, joins) and
shuts its daemons down in ``finally``.
"""

import os
import shutil
import tempfile
import threading
from types import SimpleNamespace

import pytest
import torch

from repro.core.codec import LogzipConfig as RLogzipConfig
from repro.core.faultinject import FaultyOpener as RFaultyOpener
from repro.core.parallel import RetryPolicy as RRetryPolicy
from repro.core.stream import LZJSReader as RLZJSReader
from repro.data.loggen import DATASETS, generate_multitenant
from repro.ingest import protocol as rprotocol
from repro.ingest import service as rservice
from repro.ingest import supervisor as rsupervisor
from repro_torch.core.codec import LogzipConfig
from repro_torch.core.faultinject import FaultyOpener
from repro_torch.core.parallel import RetryPolicy
from repro_torch.core.stream import LZJSReader
from repro_torch.ingest import protocol, service, supervisor

FMT = "<Date> <Time> <Pid> <Level> <Component>: <Content>"
WAIT = 60.0  # seconds any one socket wait may take


def _with_device(cls):
    return lambda *a, **kw: cls(*a, device="cpu", **kw)


PKGS = {
    "ref": SimpleNamespace(
        cfg=RLogzipConfig(level=2, kernel="gzip", format=FMT), P=rprotocol,
        Store=rservice.TenantStore, Worker=rservice.TenantWorker,
        Daemon=rservice.IngestDaemon, Client=rprotocol.IngestClient,
        Supervisor=rsupervisor.TenantSupervisor, Breaker=rsupervisor.CircuitBreaker,
        Retry=RRetryPolicy, Opener=RFaultyOpener, Reader=RLZJSReader),
    "port": SimpleNamespace(
        cfg=LogzipConfig(level=2, kernel="gzip", format=FMT, device="cpu"), P=protocol,
        Store=_with_device(service.TenantStore), Worker=service.TenantWorker,
        Daemon=_with_device(service.IngestDaemon), Client=protocol.IngestClient,
        Supervisor=supervisor.TenantSupervisor, Breaker=supervisor.CircuitBreaker,
        Retry=RetryPolicy, Opener=FaultyOpener, Reader=LZJSReader),
}


def _line(i: int) -> str:
    return (f"081109 2035{i % 60:02d} {i} INFO dfs.DataNode$PacketResponder: "
            f"Received block blk_{i * 7 + 1} of size {i * 512} from /10.0.0.{i % 256}")


def _lines(n: int) -> list[str]:
    return [_line(i) for i in range(n)]


def _read(k, path: str) -> list[str]:
    rd = k.Reader(path)
    try:
        return rd.read_all()
    finally:
        rd.close()


def _files(root: str) -> dict[str, bytes]:
    """Every regular file under ``root`` (archives, journal segments), by
    relative path; sockets are left out."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def _both(case, tmp_path, *args):
    """Run ``case(k, root, *args)`` for each package -> its results, which
    must be equal."""
    got = {}
    for name, k in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        got[name] = case(k, str(root), *args)
    assert got["port"] == got["ref"]
    return got["port"]


# ------------------------------------------------ TenantStore, no sockets --

def _kill_between_ack_batches(k, root, n_acked):
    lines = _lines(24)
    st = k.Store(root, "t", k.cfg, chunk_lines=8)
    for i in range(n_acked):
        st.submit(i, lines[i])
        if (i + 1) % 4 == 0:
            st.ack_sync()
    acked = st.ack_sync()
    for i in range(n_acked, min(n_acked + 3, 24)):
        st.submit(i, lines[i])  # staged only: allowed to vanish
    st.crash()
    wreck = _files(root)
    st2 = k.Store(root, "t", k.cfg, chunk_lines=8)
    resumed = (st2.resumed, st2.next_seq, st2.replayed)
    for i in range(st2.next_seq, 24):
        st2.submit(i, lines[i])
    st2.ack_sync()
    st2.seal()
    assert _read(k, st2.archive_path) == lines
    assert not os.path.exists(st2.wal_dir)
    return acked, wreck, resumed, _files(root)


@pytest.mark.parametrize("n_acked", range(25))
def test_replay_at_every_watermark_equals_reference(tmp_path, n_acked):
    acked, _, (resumed, next_seq, _), _ = _both(_kill_between_ack_batches, tmp_path, n_acked)
    assert acked == n_acked and resumed and next_seq == n_acked


def _double_crash(k, root):
    lines = _lines(30)
    st = k.Store(root, "t", k.cfg, chunk_lines=8)
    for i in range(11):
        st.submit(i, lines[i])
    st.ack_sync()
    st.crash()
    st2 = k.Store(root, "t", k.cfg, chunk_lines=8)
    first = (st2.next_seq, st2.replayed)
    for i in range(st2.next_seq, 23):
        st2.submit(i, lines[i])
    st2.ack_sync()
    st2.crash()
    wreck = _files(root)
    st3 = k.Store(root, "t", k.cfg, chunk_lines=8)
    second = (st3.next_seq, st3.replayed)
    for i in range(23, 30):
        st3.submit(i, lines[i])
    st3.seal()
    assert _read(k, st3.archive_path) == lines
    return first, second, wreck, _files(root)


def _resend_below_watermark(k, root):
    st = k.Store(root, "t", k.cfg)
    lines = _lines(10)
    for i, ln in enumerate(lines):
        st.submit(i, ln)
    st.ack_sync()
    dups = (st.submit(3, lines[3]), st.submit(9, lines[9]))
    st.seal()
    assert _read(k, st.archive_path) == lines
    return dups, _files(root)


def _seq_gap(k, root):
    st = k.Store(root, "t", k.cfg)
    with pytest.raises(k.P.ProtocolError) as ei:
        st.submit(5, "skipped ahead")
    st.seal()
    return ei.value.code, str(ei.value), _files(root)


def _enospc_on_wal(k, root):
    wal_op = k.Opener()
    st = k.Store(root, "t", k.cfg, chunk_lines=64, wal_opener=wal_op)
    lines = _lines(10)
    for i in range(6):
        st.submit(i, lines[i])
    first = st.ack_sync()
    wal_op.write_limit = wal_op.bytes_written + 5
    for i in range(6, 10):
        st.submit(i, lines[i])
    with pytest.raises(OSError):
        st.ack_sync()
    durable = st.wal.durable_seq
    wreck = _files(root)
    wal_op.reset()
    wal_op.write_limit = None
    second = st.ack_sync()
    st.seal()
    assert _read(k, st.archive_path) == lines
    return first, durable, second, wreck, _files(root)


def _enospc_on_archive(k, root):
    lines = _lines(30)
    arch_op = k.Opener()
    st = k.Store(root, "t", k.cfg, chunk_lines=8, archive_opener=arch_op)
    arch_op.write_limit = arch_op.bytes_written + 200
    sent = 0
    try:
        for i in range(30):
            st.submit(i, lines[i])
            sent = i + 1
            if (i + 1) % 8 == 0:
                st.ack_sync()
        st.ack_sync()
        st.flush()
    except OSError:
        pass
    assert arch_op.faults > 0
    st.crash()
    wreck = _files(root)
    st2 = k.Store(root, "t", k.cfg, chunk_lines=8)
    resume = (st2.next_seq, st2.replayed)
    for i in range(st2.next_seq, 30):
        st2.submit(i, lines[i])
    st2.seal()
    assert _read(k, st2.archive_path) == lines
    return sent, arch_op.faults, resume, wreck, _files(root)


def _replay_onto_salvaged(k, root):
    lines = _lines(20)
    st = k.Store(root, "t", k.cfg, chunk_lines=8)
    for i in range(20):
        st.submit(i, lines[i])
    st.ack_sync()
    st.crash()
    with open(st.archive_path, "ab") as f:
        f.write(b"CHNK" + bytes(range(200, 237)))  # a torn partial record
    st2 = k.Store(root, "t", k.cfg, chunk_lines=8)
    resume = (st2.next_seq, st2.replayed)
    st2.seal()
    assert _read(k, st2.archive_path) == lines
    return resume, _files(root)


def _zero_line_tenant(k, root):
    st = k.Store(root, "t", k.cfg)
    st.seal()
    st.seal()
    sealed = _files(root)
    assert _read(k, st.archive_path) == []
    st2 = k.Store(root, "t", k.cfg)
    resume = (st2.resumed, st2.next_seq)
    st2.seal()
    return sealed, resume, _files(root)


def _crash_right_after_bootstrap(k, root):
    st = k.Store(root, "t", k.cfg)
    st.crash()
    wreck = _files(root)
    st2 = k.Store(root, "t", k.cfg)
    resume = (st2.resumed, st2.next_seq)
    lines = _lines(5)
    for i, ln in enumerate(lines):
        st2.submit(i, ln)
    st2.seal()
    assert _read(k, st2.archive_path) == lines
    return wreck, resume, _files(root)


def _size_trigger(k, root):
    lines = _lines(120)
    st = k.Store(root, "t", k.cfg, chunk_lines=100_000, wal_segment_bytes=512,
                 wal_flush_bytes=2048, wal_flush_age=None)
    trace = []
    for i, line in enumerate(lines):
        st.submit(i, line)
        st.ack_sync()
        trace.append((st.maybe_force_flush(), st.wal.journal_bytes()))
    assert max(b for _, b in trace) <= 2048 + 512 + 256
    assert st.session.committed_lines > 0
    st.seal()
    assert _read(k, st.archive_path) == lines
    return trace, _files(root)


def _no_trigger_below_thresholds(k, root):
    st = k.Store(root, "t", k.cfg, chunk_lines=100_000, wal_flush_bytes=1 << 20,
                 wal_flush_age=None)
    for i in range(5):
        st.submit(i, _line(i))
    st.ack_sync()
    got = (st.maybe_force_flush(), st.session.committed_lines)
    assert got == (None, 0)
    st.seal()
    return got, _files(root)


def _age_trigger(k, root):
    now = [0.0]
    st = k.Store(root, "t", k.cfg, chunk_lines=100_000, wal_flush_bytes=None,
                 wal_flush_age=300.0, clock=lambda: now[0])
    for i in range(3):
        st.submit(i, _line(i))
    st.ack_sync()
    flushed = [st.maybe_force_flush()]
    now[0] = 301.0
    flushed.append(st.maybe_force_flush())
    journal = _files(root)
    now[0] = 700.0
    flushed.append(st.maybe_force_flush())
    assert flushed == [None, 3, None]
    st.seal()
    assert _read(k, st.archive_path) == _lines(3)
    return flushed, journal, _files(root)


def _kill_mid_forced_flush(k, root):
    lines = _lines(40)
    arch_op = k.Opener()
    st = k.Store(root, "t", k.cfg, chunk_lines=100_000, wal_segment_bytes=256,
                 wal_flush_bytes=512, wal_flush_age=None, archive_opener=arch_op)
    arch_op.write_limit = arch_op.bytes_written + 300
    acked = 0
    try:
        for i, line in enumerate(lines):
            st.submit(i, line)
            acked = st.ack_sync()
            st.maybe_force_flush()
    except OSError:
        pass
    assert arch_op.faults > 0 and acked > 0
    st.crash()
    wreck = _files(root)
    st2 = k.Store(root, "t", k.cfg, chunk_lines=100_000)
    resume = (st2.resumed, st2.next_seq, st2.replayed)
    assert st2.next_seq == acked
    for i in range(st2.next_seq, len(lines)):
        st2.submit(i, lines[i])
    st2.seal()
    assert _read(k, st2.archive_path) == lines
    return acked, wreck, resume, _files(root)


STORE_CASES = [_double_crash, _resend_below_watermark, _seq_gap, _enospc_on_wal,
               _enospc_on_archive, _replay_onto_salvaged, _zero_line_tenant,
               _crash_right_after_bootstrap, _size_trigger, _no_trigger_below_thresholds,
               _age_trigger, _kill_mid_forced_flush]


@pytest.mark.parametrize("case", STORE_CASES, ids=lambda c: c.__name__.strip("_"))
def test_store_fault_case_equals_reference(tmp_path, case):
    _both(case, tmp_path)


# ------------------------------------------- retry policy, circuit breaker --

def _breaker_cycle(k, root):
    t = [0.0]
    br = k.Breaker(threshold=2, cooldown=10.0, clock=lambda: t[0])
    trace = [br.allow()]
    br.record_failure()
    trace += [br.open, br.allow()]
    br.record_failure()
    trace += [br.open, br.allow()]
    t[0] = 10.0
    trace += [br.allow(), br.allow()]  # the half-open probe is exclusive
    br.record_failure()
    trace.append(br.allow())
    t[0] = 20.0
    trace.append(br.allow())
    br.record_success()
    trace += [br.open, br.allow()]
    assert trace == [True, False, True, True, False, True, False, False, True, False, True]
    return trace


def _supervisor_schedule(k, root):
    t = [0.0]
    slept, calls, codes = [], [], []
    sup = k.Supervisor(k.Retry(attempts=2, base_delay=0.01, sleep=slept.append,
                               rng=lambda: 0.5),
                       breaker_threshold=2, breaker_cooldown=5.0, clock=lambda: t[0])

    def transient():
        calls.append("transient")
        raise OSError("mount gone (injected)")

    def fatal():
        calls.append("fatal")
        raise ValueError("corrupt beyond repair")

    for factory in (transient, transient, transient):
        with pytest.raises(k.P.ProtocolError) as ei:
            sup.open_store("t", factory)
        codes.append((ei.value.code, str(ei.value)))
    t[0] = 5.0
    ok = object()
    assert sup.open_store("t", lambda: ok) is ok
    with pytest.raises(k.P.ProtocolError) as ei:
        sup.open_store("u", fatal)
    codes.append((ei.value.code, str(ei.value)))
    sup.record_failure("u")
    return slept, calls, codes, sup.status()


@pytest.mark.parametrize("case", [_breaker_cycle, _supervisor_schedule],
                         ids=lambda c: c.__name__.strip("_"))
def test_supervisor_case_equals_reference(tmp_path, case):
    _both(case, tmp_path)


# ------------------------------------------------- TenantWorker, no sockets --

def _worker_idle_loop_forced_flush(k, root):
    """The worker's idle branch cuts the chunk once the injected clock
    passes the age cap: the cut is fixed by the clock, not by timing."""
    now = [0.0]
    st = k.Store(root, "t", k.cfg, chunk_lines=100_000, wal_flush_bytes=None,
                 wal_flush_age=60.0, clock=lambda: now[0])
    w = k.Worker(st)
    w.start()
    try:
        for i in range(4):
            w.queue.put(("line", i, _line(i)))
        _until(lambda: st.wal.durable_seq == 4)
        committed = st.session.committed_lines
        now[0] = 61.0
        _until(lambda: st.session.committed_lines == 4)
    finally:
        w.queue.put(None)
        assert w.done.wait(WAIT)
    assert _read(k, st.archive_path) == _lines(4)
    return committed, _files(root)


def _worker_failure_isolated(k, root):
    st = k.Store(root, "t", k.cfg)
    failures, frames = [], []
    w = k.Worker(st, on_failure=lambda t, e: failures.append((t, type(e).__name__, e.code)))
    w.sender = frames.append
    w.start()
    w.queue.put(("line", 7, "a gap the store must reject"))
    assert w.done.wait(WAIT)
    errs = [k.P.unpack_json(fr[5:]) for fr in frames if fr[0] == k.P.T_ERROR]
    assert failures and errs and errs[0]["code"] == "seq_gap"
    return failures, errs, w.failed.code


def _until(cond, limit=WAIT):
    ev = threading.Event()
    for _ in range(int(limit / 0.01)):
        if cond():
            return
        ev.wait(0.01)
    raise AssertionError("condition not met in time")


@pytest.mark.parametrize("case", [_worker_idle_loop_forced_flush, _worker_failure_isolated],
                         ids=lambda c: c.__name__.strip("_"))
def test_worker_case_equals_reference(tmp_path, case):
    _both(case, tmp_path)


def test_kill_mid_drain_recovers_every_acked_line(tmp_path):
    """A drain cut by an abort: where the worker stood is a matter of
    timing, so each package is held to the contract (every acked line
    back exactly once) and the final lines are compared."""
    def case(k, root):
        lines = _lines(200)
        st = k.Store(root, "t", k.cfg, chunk_lines=16)
        frames = []
        w = k.Worker(st, batch_lines=8)
        w.sender = frames.append
        w.start()
        for i, ln in enumerate(lines):
            w.queue.put(("line", i, ln))
        w.drain()
        w.abort()
        assert w.done.wait(WAIT)
        watermark = max((k.P.unpack_u64(fr[5:]) for fr in frames if fr[0] == k.P.T_ACK),
                        default=0)
        st2 = k.Store(root, "t", k.cfg, chunk_lines=16)
        assert st2.next_seq >= watermark
        for i in range(st2.next_seq, len(lines)):
            st2.submit(i, lines[i])
        st2.seal()
        return _read(k, st2.archive_path)

    assert _both(case, tmp_path) == _lines(200)


# ------------------------------------------------- the daemon over a socket --

def short_tmpdir(prefix: str) -> str:
    """A new directory in the temporary directory, named relative to the
    working directory where that is the shorter name: unix socket paths
    are capped at ~108 bytes, and the sockets go two levels below it."""
    d = tempfile.mkdtemp(prefix=prefix)
    return min(d, os.path.relpath(d), key=len)


@pytest.fixture
def sock_root():
    # stay out of pytest's deeply nested tmp_path
    d = short_tmpdir("lzt-")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _daemon_both(case, sock_root, *args):
    """``case(k, root, *args)`` for each package in a directory of its own
    under ``sock_root``; every daemon it starts is shut down after it."""
    got = {}
    for name, k in PKGS.items():
        root = os.path.join(sock_root, name)
        os.mkdir(root)
        started = []
        real = k.Daemon

        def daemon(*a, _real=real, _started=started, **kw):
            d = _real(*a, **kw)
            _started.append(d)
            return d

        kk = SimpleNamespace(**{**vars(k), "Daemon": daemon})
        try:
            got[name] = case(kk, root, *args)
        finally:
            for d in started:
                d.shutdown(timeout=WAIT)
    assert got["port"] == got["ref"]
    return got["port"]


def _single_tenant(k, root):
    lines = _lines(100)
    daemon = k.Daemon(root, cfg=k.cfg, chunk_lines=32).start()
    with k.Client(daemon.address, "t") as c:
        hello = (c.resumed, c.next_seq)
        for ln in lines:
            c.send(ln)
        acked = c.wait_ack(99, timeout=WAIT)
        flushed = c.flush(timeout=WAIT)
    daemon.shutdown(timeout=WAIT)
    assert _read(k, os.path.join(root, "t.lzjs")) == lines
    return hello, acked, flushed, _files(root)


def _tcp_ephemeral_port(k, root):
    daemon = k.Daemon(root, ("127.0.0.1", 0), cfg=k.cfg).start()
    assert daemon.address[1] != 0
    with k.Client(daemon.address, "t") as c:
        c.send("hello over tcp")
        acked = c.wait_ack(0, timeout=WAIT)
    daemon.shutdown(timeout=WAIT)
    assert _read(k, os.path.join(root, "t.lzjs")) == ["hello over tcp"]
    return acked, _files(root)


def _restart_resume(k, root):
    lines = _lines(100)
    spath = os.path.join(root, "d.sock")
    d1 = k.Daemon(root, spath, cfg=k.cfg, chunk_lines=32).start()
    with k.Client(spath, "t") as c:
        for i in range(60):
            c.send(lines[i])
        first = c.wait_ack(59, timeout=WAIT)
    d1.shutdown(timeout=WAIT)
    sealed = _files(root)
    d2 = k.Daemon(root, spath, cfg=k.cfg, chunk_lines=32).start()
    with k.Client(spath, "t") as c2:
        hello = (c2.resumed, c2.next_seq)
        for i in range(60, 100):
            c2.send(lines[i])
        flushed = c2.flush(timeout=WAIT)
    d2.shutdown(timeout=WAIT)
    assert hello == (True, 60)
    assert _read(k, os.path.join(root, "t.lzjs")) == lines
    return first, sealed, hello, flushed, _files(root)


def _zero_line_over_socket(k, root):
    spath = os.path.join(root, "d.sock")
    d1 = k.Daemon(root, spath, cfg=k.cfg).start()
    k.Client(spath, "empty").close()
    d1.shutdown(timeout=WAIT)
    sealed = _files(root)
    d2 = k.Daemon(root, spath, cfg=k.cfg).start()
    with k.Client(spath, "empty") as c:
        hello = (c.resumed, c.next_seq)
    d2.shutdown(timeout=WAIT)
    assert _read(k, os.path.join(root, "empty.lzjs")) == []
    return sealed, hello, _files(root)


TENANTS = [("alpha", "HDFS"), ("beta", "Spark"), ("gamma", "Windows")]


def _multitenant_bursty(k, root):
    stream = list(generate_multitenant(TENANTS, 600, seed=7, burstiness=0.8,
                                       weights=[3, 1, 1]))
    per = {tid: [ln for t, ln in stream if t == tid] for tid, _ in TENANTS}
    daemon = k.Daemon(root, cfg=None, chunk_lines=64, queue_lines=128, batch_lines=16).start()
    clients = {tid: k.Client(daemon.address, tid,
                             cfg={"format": DATASETS[name]["format"], "level": 2})
               for tid, name in TENANTS}
    acked = {}
    try:
        for tid, ln in stream:
            clients[tid].send(ln)
        for tid, _ in TENANTS:
            acked[tid] = clients[tid].wait_ack(len(per[tid]) - 1, timeout=WAIT)
    finally:
        for c in clients.values():
            c.close()
    daemon.shutdown(timeout=WAIT)
    for tid, _ in TENANTS:
        assert _read(k, os.path.join(root, tid + ".lzjs")) == per[tid], tid
        assert acked[tid] == len(per[tid])
    return acked, _files(root)


def _backpressure(k, root):
    P = k.P
    daemon = k.Daemon(root, cfg=k.cfg, chunk_lines=4096, queue_lines=8, batch_lines=2).start()
    sock = P.connect(daemon.address)
    try:
        P.send_all(sock, P.pack_json(P.T_HELLO, {"tenant": "t"}))
        assert P.recv_frame(sock)[0] == P.T_WELCOME
        seen: list[int] = []
        done = threading.Event()

        def reader():
            try:
                while True:
                    got = P.recv_frame(sock)
                    if got is None:
                        return
                    seen.append(got[0])
                    if got[0] == P.T_ACK and P.unpack_u64(got[1]) >= 300:
                        done.set()
            except (OSError, P.ProtocolError):
                pass

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for i in range(300):
            P.send_all(sock, P.pack_line(i, _line(i)))
        assert done.wait(WAIT)
        assert seen.index(P.T_PAUSE) < seen.index(P.T_RESUME)
        P.send_all(sock, P.pack_frame(P.T_BYE))
    finally:
        sock.close()
    daemon.shutdown(timeout=WAIT)
    t.join(WAIT)
    assert _read(k, os.path.join(root, "t.lzjs")) == _lines(300)
    return _files(root)


def _admission_errors(k, root):
    codes = []
    daemon = k.Daemon(root, cfg=k.cfg, max_tenants=1).start()
    c1 = k.Client(daemon.address, "t1")
    try:
        for tenant, cfg in (("t1", None), ("t2", None), ("../escape", None),
                            ("t1", {"workers": 8})):
            with pytest.raises(k.P.ProtocolError) as ei:
                k.Client(daemon.address, tenant, cfg=cfg)
            codes.append(ei.value.code)
    finally:
        c1.close()
    daemon.shutdown(timeout=WAIT)
    assert codes == ["busy", "admission", "bad_tenant", "bad_cfg"]
    return codes


def _seq_gap_error_frame(k, root):
    P = k.P
    daemon = k.Daemon(root, cfg=k.cfg).start()
    sock = P.connect(daemon.address)
    sock.settimeout(WAIT)
    try:
        P.send_all(sock, P.pack_json(P.T_HELLO, {"tenant": "t"}))
        assert P.recv_frame(sock)[0] == P.T_WELCOME
        P.send_all(sock, P.pack_line(5, "a gap"))
        err = None
        while err is None:
            got = P.recv_frame(sock)
            if got is None:
                break
            if got[0] == P.T_ERROR:
                err = P.unpack_json(got[1])
    finally:
        sock.close()
    daemon.shutdown(timeout=WAIT)
    assert err and err["code"] == "seq_gap" and err["fatal"]
    return err


def _reconnect_after_retirement(k, root):
    daemon = k.Daemon(root, cfg=k.cfg).start()
    with pytest.raises(k.P.ProtocolError) as ei:
        with k.Client(daemon.address, "t") as c:
            c._sock.sendall(k.P.pack_line(9, "gap"))
            c.wait_ack(9, timeout=WAIT)
    with k.Client(daemon.address, "t") as c2:
        hello = c2.next_seq
        c2.send("after the crash")
        acked = c2.wait_ack(0, timeout=WAIT)
    daemon.shutdown(timeout=WAIT)
    assert _read(k, os.path.join(root, "t.lzjs")) == ["after the crash"]
    return ei.value.code, hello, acked, _files(root)


DAEMON_CASES = [_single_tenant, _tcp_ephemeral_port, _restart_resume, _zero_line_over_socket,
                _multitenant_bursty, _backpressure, _admission_errors, _seq_gap_error_frame,
                _reconnect_after_retirement]


@pytest.mark.parametrize("case", DAEMON_CASES, ids=lambda c: c.__name__.strip("_"))
def test_daemon_case_equals_reference(sock_root, case):
    _daemon_both(case, sock_root)


def test_double_shutdown_forces_abort_then_recovers(sock_root):
    """The second shutdown aborts mid-drain: how far the worker got is a
    matter of timing, so the resume is held to the contract and the lines
    are compared."""
    def case(k, root):
        spath = os.path.join(root, "d.sock")
        lines = _lines(400)
        d1 = k.Daemon(root, spath, cfg=k.cfg, chunk_lines=16, batch_lines=8).start()
        c = k.Client(spath, "t")
        try:
            for ln in lines:
                c.send(ln)
            t = threading.Thread(target=d1.shutdown, daemon=True)
            t.start()
            d1.shutdown(timeout=WAIT)
            assert d1.wait(WAIT)
            t.join(WAIT)
            acked = c.acked
        finally:
            c.close()
        d2 = k.Daemon(root, spath, cfg=k.cfg, chunk_lines=16).start()
        with k.Client(spath, "t") as c2:
            assert acked <= c2.next_seq <= len(lines)
            for i in range(c2.next_seq, len(lines)):
                c2.send(lines[i])
            c2.wait_ack(len(lines) - 1, timeout=WAIT)
        d2.shutdown(timeout=WAIT)
        return _read(k, os.path.join(root, "t.lzjs"))

    assert _daemon_both(case, sock_root) == _lines(400)


# --------------------------------------------------------------- interop --

@pytest.mark.parametrize("client,daemon", [("ref", "port"), ("port", "ref")])
def test_client_and_daemon_of_the_other_package(sock_root, client, daemon):
    """The wire format is the reference's: either package's client feeds
    either package's daemon, and each package reads the archive."""
    kc, kd = PKGS[client], PKGS[daemon]
    lines = _lines(150)
    spath = os.path.join(sock_root, "d.sock")
    d1 = kd.Daemon(sock_root, spath, cfg=kd.cfg, chunk_lines=32).start()
    try:
        with kc.Client(spath, "t", cfg={"format": FMT, "level": 2}) as c:
            for ln in lines[:90]:
                c.send(ln)
            assert c.wait_ack(89, timeout=WAIT) == 90
    finally:
        d1.shutdown(timeout=WAIT)
    d2 = kd.Daemon(sock_root, spath, cfg=kd.cfg, chunk_lines=32).start()
    try:
        with kc.Client(spath, "t") as c:
            assert (c.resumed, c.next_seq) == (True, 90)
            for ln in lines[90:]:
                c.send(ln)
            assert c.flush(timeout=WAIT) == 150
    finally:
        d2.shutdown(timeout=WAIT)
    path = os.path.join(sock_root, "t.lzjs")
    assert _read(PKGS["ref"], path) == lines
    assert _read(PKGS["port"], path) == lines


# ------------------------------------------------------------ no card here --

def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' runs the kernels")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.TenantStore(str(tmp_path), "t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.IngestDaemon(str(tmp_path), os.path.join(str(tmp_path), "d.sock"))
    assert os.listdir(tmp_path) == []  # raised before any file or socket


def test_cfg_on_another_device_is_refused(tmp_path):
    """The device is one setting: a cfg naming another device raises
    before any file or socket, and is never silently overridden."""
    with pytest.raises(ValueError, match="differs from device"):
        service.TenantStore(str(tmp_path), "t", LogzipConfig(device="cuda"), device="cpu")
    with pytest.raises(ValueError, match="differs from device"):
        service.IngestDaemon(str(tmp_path), os.path.join(str(tmp_path), "d.sock"),
                             cfg=LogzipConfig(device="cuda"), device="cpu")
    assert os.listdir(tmp_path) == []


def test_daemon_hands_its_device_to_the_retention_hook(sock_root):
    """A ``device="cpu"`` daemon's roll-over compacts on the CPU (on
    ``"cuda"`` it would raise here and fail the tenant)."""
    from repro_torch.lifecycle import RetentionManager, RetentionPolicy

    lines = _lines(150)
    mgr = RetentionManager(sock_root, RetentionPolicy(rollup_after=None, kernel="gzip"))
    daemon = service.IngestDaemon(sock_root, cfg=PKGS["port"].cfg, chunk_lines=64,
                                  retention=mgr, device="cpu").start()
    try:
        with protocol.IngestClient(daemon.address, "t") as c:
            for ln in lines:
                c.send(ln)
            c.wait_ack(len(lines) - 1, timeout=WAIT)
    finally:
        daemon.shutdown(timeout=WAIT)
    assert daemon.supervisor.status()["t"]["failures"] == 0
    tiers = mgr.tiers("t")
    assert tiers["hot"] is None and len(tiers["sealed"]) == 1
    assert _read(PKGS["port"], tiers["sealed"][0]) == lines


def test_device_is_not_on_the_wire_and_not_in_the_archive(sock_root):
    """A tenant's HELLO cfg carries only level / kernel / format, and the
    append session runs on the daemon's device with the footer's
    settings, as the reference's ``cfg=None`` append does."""
    assert service._CFG_KEYS == rservice._CFG_KEYS == ("level", "kernel", "format")
    daemon = service.IngestDaemon(sock_root, device="cpu").start()
    try:
        with pytest.raises(protocol.ProtocolError) as ei:
            protocol.IngestClient(daemon.address, "t", cfg={"device": "cpu"})
        assert ei.value.code == "bad_cfg"
        with protocol.IngestClient(daemon.address, "t", cfg={"format": FMT, "level": 1}) as c:
            c.send(_line(0))
            c.wait_ack(0, timeout=WAIT)
            worker = daemon._workers["t"]
            assert worker.store.session.cfg.device == "cpu"
            assert worker.store.session.cfg.level == 1
    finally:
        daemon.shutdown(timeout=WAIT)
    rd = LZJSReader(os.path.join(sock_root, "t.lzjs"))
    try:
        assert "device" not in rd.footer and rd.footer["level"] == 1
    finally:
        rd.close()


@pytest.mark.parametrize("tcp", [False, True])
def test_shutdown_ends_the_accept_thread(sock_root, tcp):
    """``shutdown`` leaves no thread behind: the accept loop, blocked in
    ``accept()``, returns (closing the listener alone does not wake it on
    Linux, so each daemon shut down kept one thread for good)."""
    address = ("127.0.0.1", 0) if tcp else None
    daemon = service.IngestDaemon(sock_root, address, device="cpu").start()
    thread = daemon._accept_thread
    assert thread.is_alive()
    with protocol.IngestClient(daemon.address, "t", cfg={"format": FMT}) as c:
        c.send(_line(0))
        c.wait_ack(0, timeout=WAIT)
    assert daemon.shutdown(timeout=WAIT)
    thread.join(WAIT)
    assert not thread.is_alive()
    assert not [t for t in threading.enumerate() if t is thread]


def _late_client(k, root):
    """A client that connects after the drain began, before the listener
    closed: the window ``shutdown`` opens with ``_draining = True``."""
    daemon = k.Daemon(root, cfg=k.cfg).start()
    with daemon._lock:
        daemon._draining = True
    with pytest.raises(k.P.ProtocolError) as ei:
        k.Client(daemon.address, "t0")
    return ei.value.code, str(ei.value)


def test_a_client_connecting_during_the_drain_gets_code_draining(sock_root):
    """Both packages hand the late connection to ``_admit``, which rejects
    it with an ERROR frame of code ``draining``; the port's accept loop
    used to close it unanswered (code ``rejected``)."""
    assert _daemon_both(_late_client, sock_root) == ("draining", "daemon is shutting down")
