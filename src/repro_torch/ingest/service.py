"""Multi-tenant ingestion daemon (DESIGN.md §15).

Three layers, separable for testing:

- ``TenantStore`` — the crash-exact persistence core for ONE tenant:
  WAL + appendable LZJS session, bootstrapped through ``ensure_clean``
  and WAL replay so that after ANY crash, reopening yields exactly the
  acked prefix of the stream (fault tests drive this class directly,
  no sockets involved).
- ``TenantWorker`` — a thread draining one bounded queue into a
  ``TenantStore`` with group-commit acks.
- ``IngestDaemon`` — the socket front end: accepts connections, runs
  the handshake, enforces admission control, routes frames to workers,
  and orchestrates graceful (or forced) drain on SIGTERM.

Durability contract (the one the tests prove): an ACK covering sequence
``s`` means line ``s`` is fsync-durable in the tenant WAL; a line's
sequence number IS its line index in the tenant archive; after any
crash + restart, the archive extended by WAL replay contains every
acked line exactly once, in order.

Device: every tenant session runs its kernels (``wildcard_match_first``,
``colcodec_transform``) on the ``device`` given to ``TenantStore`` or
``IngestDaemon``, default ``"cuda"``, which raises where there is no
card. It is the one device setting: a ``cfg`` given beside it must name
the same device (else ``ValueError``), a client's cfg is built on it, and
the daemon hands it to the retention hook. It is never sent on the wire
(``_CFG_KEYS``) and never written to an archive. Tenant workers are
threads of one process, so they share one CUDA context.
"""

from __future__ import annotations

import functools
import json
import os
import queue
import shutil
import socket
import threading
import time

from ..core import recover, wal
from ..core.stages import LogzipConfig
from ..core.stream import LZJSReader, StreamingCompressor
from ..kernels.ops import check_device
from . import protocol as P
from .protocol import ProtocolError

DEFAULT_QUEUE_LINES = 1024
DEFAULT_BATCH_LINES = 256    # max lines per group-commit fsync
DEFAULT_MAX_LINE_BYTES = 1 << 20
PAUSE_HIGH = 0.75            # queue fill ratio that triggers PAUSE
PAUSE_LOW = 0.25             # ... and the refill ratio that RESUMEs
# forced flush+trim (WAL GC for trickling tenants): a tenant that never
# reaches the chunk threshold never fires the archive commit hook, so
# its journal would grow without bound. When the journal exceeds the
# byte cap OR uncommitted lines have sat past the age cap, the worker
# force-cuts a (partial) chunk — the commit advances the watermark and
# the hook trims covered segments.
DEFAULT_WAL_FLUSH_BYTES = 4 << 20
DEFAULT_WAL_FLUSH_AGE = 300.0

_CFG_KEYS = ("level", "kernel", "format")


def _tenant_ok(name: str) -> bool:
    """Tenant ids become file names — keep them boring."""
    return (0 < len(name) <= 128 and
            all(c.isalnum() or c in "-_." for c in name) and
            not name.startswith("."))


def _cfg_from_dict(d: dict | None, device: str) -> LogzipConfig | None:
    if not d:
        return None
    bad = set(d) - set(_CFG_KEYS)
    if bad:
        raise ProtocolError("bad_cfg", f"unknown cfg keys: {sorted(bad)}")
    return LogzipConfig(device=device, **{k: d[k] for k in _CFG_KEYS if k in d})


def _check_cfg_device(cfg: LogzipConfig | None, device: str) -> None:
    if cfg is not None and cfg.device != device:
        raise ValueError(f"cfg.device {cfg.device!r} differs from device {device!r}")


def footer_cfg(path: str, device: str) -> LogzipConfig:
    """The config an append session builds from the archive's footer when
    given none (its level, kernel and format), on ``device``."""
    rd = LZJSReader(path)
    try:
        f = rd.footer
    finally:
        rd.close()
    return LogzipConfig(level=f["level"], kernel=f["kernel"], format=f["format"],
                        device=device)


class TenantStore:
    """WAL + archive session for one tenant, crash-exact across reopens.

    Reopen order matters and is the recovery proof obligation:

    1. ``ensure_clean`` heals the archive (a kill mid-chunk-write leaves
       a torn record; repair rewinds to the last sealed commit). Its
       line count ``A`` is the durable archive watermark.
    2. ``replay_wal(start=A)`` yields the acked-but-uncommitted suffix:
       records below ``A`` are already in the archive (dropped — that is
       the dedup), records from ``A`` on are re-fed in sequence order.
    3. The WAL writer restarts at ``max(A, wal_end)`` in a FRESH
       segment, never appending after a torn tail.

    A line's sequence number equals its archive line index, so step 2's
    "replay only ``seq >= A``" is exactly-once by arithmetic, not by
    searching the archive for duplicates.
    """

    def __init__(self, root: str, tenant: str, cfg: LogzipConfig | None = None,
                 *, chunk_lines: int = 4096, wal_segment_bytes: int = 1 << 20,
                 wal_flush_bytes: int | None = DEFAULT_WAL_FLUSH_BYTES,
                 wal_flush_age: float | None = DEFAULT_WAL_FLUSH_AGE,
                 clock=time.monotonic, wal_opener=open, archive_opener=open,
                 device: str = "cuda"):
        check_device(device)
        _check_cfg_device(cfg, device)
        if not _tenant_ok(tenant):
            raise ProtocolError("bad_tenant", f"invalid tenant id {tenant!r}")
        self.tenant = tenant
        self.archive_path = os.path.join(root, tenant + ".lzjs")
        self.wal_dir = self.archive_path + ".wal"
        self.resumed = os.path.exists(self.archive_path)
        self.sealed = False
        self.wal_flush_bytes = wal_flush_bytes
        self.wal_flush_age = wal_flush_age
        self._clock = clock
        self._last_commit = clock()
        if not self.resumed:
            # bootstrap: publish an EMPTY sealed archive first (tmp +
            # atomic rename inside close()), then run in append mode —
            # there is no instant at which a crash leaves a half-written
            # file under the tenant's name
            stale = self.archive_path + ".tmp"
            if os.path.exists(stale):
                os.unlink(stale)  # wreckage of a crashed bootstrap
            StreamingCompressor(self.archive_path, cfg or LogzipConfig(device=device),
                                opener=archive_opener).close()
            base = 0
        else:
            base = recover.ensure_clean(self.archive_path)["n_lines"]
        replay = wal.replay_wal(self.wal_dir, start=base)
        if replay.records and replay.records[0][0] > base:
            raise wal.WalError(
                f"tenant {tenant}: archive ends at line {base} but the "
                f"journal resumes at {replay.records[0][0]} — an acked "
                f"record is gone")
        self.session = StreamingCompressor(
            self.archive_path, footer_cfg(self.archive_path, device),
            chunk_lines=chunk_lines, append=True,
            pipeline=False, sync_on_commit=True, on_commit=self._on_commit,
            opener=archive_opener)
        self.wal = wal.WalWriter(self.wal_dir,
                                 next_seq=max(base, replay.end_seq),
                                 segment_bytes=wal_segment_bytes,
                                 opener=wal_opener)
        self.replayed = len(replay.records)
        for _seq, text in replay.records:
            self.session.feed_line(text)
        self._staged: list[str] = []

    def _on_commit(self, committed: int) -> None:
        # a CMT1 commit covering line `committed - 1` just fsynced: WAL
        # segments wholly below it are dead weight
        self._last_commit = self._clock()
        w = getattr(self, "wal", None)
        if w is not None:
            w.gc(committed)

    # -- the ingest path ----------------------------------------------
    @property
    def next_seq(self) -> int:
        return self.wal.next_seq

    def submit(self, seq: int, line: str) -> bool:
        """Stage one line. False = duplicate (already durable or staged,
        dropped); a sequence gap is a protocol violation and raises."""
        expected = self.wal.next_seq
        if seq < expected:
            return False
        if seq > expected:
            raise ProtocolError(
                "seq_gap", f"tenant {self.tenant}: got seq {seq}, "
                f"expected {expected} (lines lost in transit?)")
        self.wal.append(line)
        self._staged.append(line)
        return True

    def ack_sync(self) -> int:
        """Group commit: fsync the staged batch into the WAL, then hand
        it to the (buffering) archive session. Returns the durable
        sequence watermark — THE number an ACK frame may carry. On
        ENOSPC nothing is acked and the batch stays staged."""
        durable = self.wal.sync()
        staged, self._staged = self._staged, []
        for line in staged:
            self.session.feed_line(line)
        return durable

    def flush(self) -> int:
        """Cut + fsync-commit a chunk; returns committed archive lines.
        (``on_commit`` has already GC'd covered WAL segments.)"""
        return self.session.sync()

    def stats(self) -> dict:
        """Cheap observability snapshot (soak harness / ops): WAL and
        archive watermarks plus store growth. No locks; values may lag
        one in-flight chunk."""
        s = self.session.stats()
        s.update({
            "tenant": self.tenant,
            "durable_seq": self.wal.durable_seq,
            "journal_bytes": self.wal.journal_bytes(),
        })
        return s

    def maybe_force_flush(self) -> int | None:
        """Forced flush+trim for trickling tenants (DESIGN.md §15): when
        acked-but-uncommitted lines exist AND the journal is over its
        byte cap (or the oldest uncommitted line is over the age cap),
        cut a partial chunk now. The commit advances the archive
        watermark, whose hook GC's every covered journal segment — the
        journal stays bounded even for a tenant that never fills a
        chunk. Returns the committed watermark, or None when nothing
        forced a flush. Crash-safe at every instant: a kill mid-flush
        leaves WAL records ≥ the last sealed commit, which replay re-feeds
        exactly (the same recovery path as any other crash)."""
        if self.sealed or self.wal.durable_seq <= self.session.committed_lines:
            return None
        over_size = self.wal_flush_bytes is not None and \
            self.wal.journal_bytes() > self.wal_flush_bytes
        over_age = self.wal_flush_age is not None and \
            self._clock() - self._last_commit >= self.wal_flush_age
        if not (over_size or over_age):
            return None
        return self.flush()

    def seal(self) -> None:
        """Graceful close: everything staged becomes durable, the
        archive is footer-sealed, and the (now redundant) journal is
        deleted. Idempotent; crash-replayable at every step — until the
        journal deletion the WAL still covers any line the archive
        hasn't committed."""
        if self.sealed:
            return
        self.ack_sync()
        self.session.close()
        self.wal.close()
        if self.session.committed_lines >= self.wal.next_seq:
            shutil.rmtree(self.wal_dir, ignore_errors=True)
        self.sealed = True

    def crash(self) -> None:
        """Test hook: die NOW — no flush, no seal, no journal cleanup.
        Under ``sync_on_commit`` every archive write is already fsynced
        at commit granularity, so dropping the handles is byte-faithful
        to ``kill -9``."""
        self.wal.abandon()
        for f in (self.session._f,):
            try:
                f.close()
            except (OSError, ValueError):
                pass

    def lines(self) -> list[str]:
        """Debug/test: full decoded tenant stream (seal first)."""
        from ..core.stream import LZJSReader

        rd = LZJSReader(self.archive_path)
        try:
            return rd.read_all()
        finally:
            rd.close()


class TenantWorker(threading.Thread):
    """Drains one bounded queue into a ``TenantStore``.

    Queue items: ``("line", seq, text)``, ``("flush",)`` and the
    ``None`` drain sentinel. Lines are batched up to
    ``DEFAULT_BATCH_LINES`` per WAL fsync (group commit); the ACK after
    each batch carries ``ack_sync``'s watermark. ``sender`` (set by the
    connection handler, swapped on reconnect) delivers frames back to
    whichever client is currently attached — acks with no client
    attached are simply dropped, durability does not depend on them."""

    def __init__(self, store: TenantStore, *, on_failure=None, on_seal=None,
                 queue_lines: int = DEFAULT_QUEUE_LINES,
                 batch_lines: int = DEFAULT_BATCH_LINES):
        super().__init__(daemon=True, name=f"ingest-{store.tenant}")
        self.store = store
        self.on_seal = on_seal        # callable(tenant) | None — retention hook
        self.queue: queue.Queue = queue.Queue(maxsize=queue_lines)
        self.batch_lines = batch_lines
        self.paused = False           # a PAUSE frame is outstanding
        self._low = int(queue_lines * PAUSE_LOW)
        self.sender = None            # callable(frame_bytes) | None
        self.on_failure = on_failure  # callable(tenant, exc) | None
        self.failed: Exception | None = None
        self.force = threading.Event()
        self.done = threading.Event()

    def _send(self, frame: bytes) -> None:
        snd = self.sender
        if snd is not None:
            try:
                snd(frame)
            except OSError:
                pass  # client went away; durability already happened

    def run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 — isolate: one tenant, not the daemon
            self.failed = e
            if self.on_failure is not None:
                self.on_failure(self.store.tenant, e)
            self._send(P.pack_json(P.T_ERROR, {
                "code": getattr(e, "code", "tenant_failed"),
                "message": str(e), "fatal": True}))
        finally:
            self.done.set()

    def _maybe_resume(self) -> None:
        # RESUME rides on the DRAIN side: a client that honors PAUSE by
        # going silent would otherwise never hear the queue empty out
        if self.paused and self.queue.qsize() <= self._low:
            self.paused = False
            self._send(P.pack_frame(P.T_RESUME))

    def _loop(self) -> None:
        while True:
            if self.force.is_set():
                self.store.crash()
                return
            self._maybe_resume()
            try:
                item = self.queue.get(timeout=0.1)
            except queue.Empty:
                # idle is exactly when a trickling tenant's journal
                # would otherwise grow forever — check the forced-flush
                # triggers here, off the ingest hot path
                self.store.maybe_force_flush()
                continue
            batch = 0
            flushes = 0
            draining = False
            while item is not ...:
                if item is None:
                    draining = True
                elif item[0] == "line":
                    if self.store.submit(item[1], item[2]):
                        batch += 1
                elif item[0] == "flush":
                    flushes += 1
                if draining or batch >= self.batch_lines or self.force.is_set():
                    break
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    break
            if self.force.is_set():
                self.store.crash()
                return
            if batch or flushes:
                durable = self.store.ack_sync()
                self._send(P.pack_u64(P.T_ACK, durable))
            for _ in range(flushes):
                self._send(P.pack_u64(P.T_FLUSHED, self.store.flush()))
            if batch and not flushes:
                # under sustained sub-chunk trickle the queue is never
                # empty, so the size cap must also be enforced inline
                self.store.maybe_force_flush()
            self._maybe_resume()
            if draining:
                self.store.seal()
                if self.on_seal is not None:
                    # tenant roll-over: hand the sealed session to the
                    # retention policy (recompress/rollup — see
                    # repro_torch.lifecycle). The archive is already sealed
                    # and durable; a retention failure surfaces as a
                    # tenant error, never as data loss.
                    self.on_seal(self.store.tenant)
                return

    def drain(self) -> None:
        """Ask the worker to finish its queue, seal, and exit."""
        self.queue.put(None)

    def abort(self) -> None:
        """Crash-equivalent stop (second SIGTERM): no seal, recovery is
        the WAL's job."""
        self.force.set()


class IngestDaemon:
    """Socket front end: one listener, a thread per connection, a
    ``TenantWorker`` per tenant (living across reconnects until drain).

    ``address``: a filesystem path = unix socket; a ``(host, port)``
    tuple = TCP (port 0 picks a free one — read ``self.address`` back).
    """

    def __init__(self, root: str, address=None, *,
                 cfg: LogzipConfig | None = None, chunk_lines: int = 4096,
                 queue_lines: int = DEFAULT_QUEUE_LINES,
                 batch_lines: int = DEFAULT_BATCH_LINES,
                 max_tenants: int = 64,
                 max_line_bytes: int = DEFAULT_MAX_LINE_BYTES,
                 wal_segment_bytes: int = 1 << 20,
                 wal_flush_bytes: int | None = DEFAULT_WAL_FLUSH_BYTES,
                 wal_flush_age: float | None = DEFAULT_WAL_FLUSH_AGE,
                 retention=None, supervisor=None, device: str = "cuda"):
        from .supervisor import TenantSupervisor

        check_device(device)
        _check_cfg_device(cfg, device)
        self.device = device
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.cfg = cfg
        self.chunk_lines = chunk_lines
        self.queue_lines = queue_lines
        self.batch_lines = batch_lines
        self.max_tenants = max_tenants
        self.max_line_bytes = max_line_bytes
        self.wal_segment_bytes = wal_segment_bytes
        self.wal_flush_bytes = wal_flush_bytes
        self.wal_flush_age = wal_flush_age
        # lifecycle policy hook (DESIGN.md §16): invoked with the tenant
        # id after a worker seals its session on drain/roll-over
        self.retention = retention
        self.supervisor = supervisor or TenantSupervisor()
        self._lock = threading.Lock()
        self._workers: dict[str, TenantWorker] = {}
        self._conns: dict[str, socket.socket] = {}   # tenant -> live socket
        self._all_socks: set = set()
        self._draining = False
        self._drained = threading.Event()
        self._stop_accept = threading.Event()  # shutdown's, before its wake-up
        self._accept_thread: threading.Thread | None = None

        if address is None:
            address = os.path.join(self.root, "ingest.sock")
        if isinstance(address, (tuple, list)):
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind(tuple(address))
            self.address = self._listener.getsockname()[:2]
        else:
            path = str(address)
            if os.path.exists(path):
                os.unlink(path)  # stale socket from a dead daemon
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(path)
            self.address = path
        self._listener.listen(64)

    def stats(self) -> dict:
        """Per-tenant observability snapshot (soak harness / ops)."""
        with self._lock:
            workers = dict(self._workers)
        out = {}
        for tid, w in workers.items():
            s = w.store.stats()
            s["queue_depth"] = w.queue.qsize()
            s["paused"] = w.paused
            s["failed"] = repr(w.failed) if w.failed is not None else None
            out[tid] = s
        return out

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "IngestDaemon":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ingest-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: drain begun
            # every connection goes to _handle: once draining, _admit rejects
            # a late client with code "draining", as the reference's does;
            # shutdown's own wake-up connection sends nothing, and its
            # _handle ends at once
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="ingest-conn")
            t.start()
            if self._stop_accept.is_set():
                return

    def shutdown(self, timeout: float = 30.0) -> bool:
        """First call: graceful drain — stop admitting, let every worker
        finish its queue, seal every session. Second call (or a second
        SIGTERM): forced abort, crash-equivalent — sessions are dropped
        mid-flight and the WAL carries recovery. Returns True when every
        worker exited within ``timeout``."""
        with self._lock:
            first = not self._draining
            self._draining = True
            workers = list(self._workers.values())
            conns = list(self._conns.values()) + list(self._all_socks)
        # closing the listener does not wake a thread blocked in accept()
        # on it (Linux): a connection of our own does, and the loop, seeing
        # the stop, returns after handing it on
        self._stop_accept.set()
        if self._wake_accept() and self._accept_thread is not None:
            self._accept_thread.join(timeout)
        try:
            self._listener.close()
        except OSError:
            pass
        if isinstance(self.address, str):
            try:
                os.unlink(self.address)
            except OSError:
                pass
        if first:
            for w in workers:
                w.drain()
        else:
            for w in workers:
                w.abort()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RD)  # unblock readers; writes drain
            except OSError:
                pass
        ok = True
        for w in workers:
            ok = w.done.wait(timeout) and ok
        self._drained.set()
        return ok

    def _wake_accept(self) -> bool:
        """Connect to the listener once; False if that failed."""
        family = socket.AF_UNIX if isinstance(self.address, str) else socket.AF_INET
        try:
            with socket.socket(family, socket.SOCK_STREAM) as s:
                s.settimeout(5.0)
                s.connect(self.address)
        except OSError:
            return False
        return True

    def wait(self, timeout: float | None = None) -> bool:
        return self._drained.wait(timeout)

    # -- per-connection protocol ---------------------------------------
    def _reject(self, conn, code: str, message: str) -> None:
        try:
            conn.sendall(P.pack_json(P.T_ERROR, {
                "code": code, "message": message, "fatal": True}))
        except OSError:
            pass

    def _handle(self, conn: socket.socket) -> None:
        tenant = None
        try:
            with self._lock:
                self._all_socks.add(conn)
            got = P.recv_frame(conn)
            if got is None or got[0] != P.T_HELLO:
                self._reject(conn, "bad_handshake", "HELLO must come first")
                return
            hello = P.unpack_json(got[1])
            tenant = hello.get("tenant")
            if not isinstance(tenant, str) or not _tenant_ok(tenant):
                self._reject(conn, "bad_tenant", f"invalid tenant id {tenant!r}")
                tenant = None
                return
            try:
                worker = self._admit(tenant, conn, hello.get("cfg"))
            except ProtocolError as e:
                self._reject(conn, e.code, str(e))
                tenant = None
                return
            send_lock = threading.Lock()

            def sender(frame: bytes) -> None:
                with send_lock:
                    conn.sendall(frame)

            worker.sender = sender
            sender(P.pack_json(P.T_WELCOME, {
                "next_seq": worker.store.next_seq,
                "resumed": worker.store.resumed}))
            self._pump(conn, worker, sender)
        except (ProtocolError, OSError, json.JSONDecodeError) as e:
            code = getattr(e, "code", "io")
            self._reject(conn, code, str(e))
        finally:
            with self._lock:
                self._all_socks.discard(conn)
                if tenant is not None and self._conns.get(tenant) is conn:
                    del self._conns[tenant]
                    w = self._workers.get(tenant)
                    if w is not None:
                        w.sender = None
            try:
                conn.close()
            except OSError:
                pass

    def _admit(self, tenant: str, conn, cfg_dict) -> TenantWorker:
        """Admission control + tenant worker acquisition (one connection
        per tenant; tenant count capped; circuit breaker consulted)."""
        cfg = _cfg_from_dict(cfg_dict, self.device) or self.cfg
        with self._lock:
            if self._draining:
                raise ProtocolError("draining", "daemon is shutting down")
            if tenant in self._conns:
                raise ProtocolError("busy",
                                    f"tenant {tenant} already has a connection")
            worker = self._workers.get(tenant)
            if worker is not None and worker.failed is not None:
                del self._workers[tenant]   # retired; reopen goes through
                worker = None               # the circuit breaker below
            if worker is None and len(self._workers) >= self.max_tenants:
                raise ProtocolError(
                    "admission", f"tenant cap {self.max_tenants} reached")
            self._conns[tenant] = conn
        if worker is None:
            try:
                store = self.supervisor.open_store(
                    tenant, lambda: TenantStore(
                        self.root, tenant, cfg,
                        chunk_lines=self.chunk_lines,
                        wal_segment_bytes=self.wal_segment_bytes,
                        wal_flush_bytes=self.wal_flush_bytes,
                        wal_flush_age=self.wal_flush_age,
                        device=self.device))
            except ProtocolError:
                with self._lock:
                    self._conns.pop(tenant, None)
                raise
            except Exception as e:
                with self._lock:
                    self._conns.pop(tenant, None)
                raise ProtocolError("open_failed",
                                    f"tenant {tenant}: {e}") from e
            on_seal = None
            if self.retention is not None:
                # the retention hook compacts on the daemon's device
                on_seal = functools.partial(self.retention.roll_tenant,
                                            device=self.device)
            worker = TenantWorker(store,
                                  on_failure=self.supervisor.record_failure,
                                  on_seal=on_seal,
                                  queue_lines=self.queue_lines,
                                  batch_lines=self.batch_lines)
            with self._lock:
                if self._draining:
                    self._conns.pop(tenant, None)
                    store.seal()
                    raise ProtocolError("draining", "daemon is shutting down")
                self._workers[tenant] = worker
            worker.start()
        return worker

    def _pump(self, conn, worker: TenantWorker, sender) -> None:
        """Read frames until EOF/BYE, feeding the worker queue with
        PAUSE/RESUME watermarks around it."""
        q = worker.queue
        high = max(1, int(q.maxsize * PAUSE_HIGH))
        while True:
            if worker.failed is not None:
                return  # run() already sent the structured ERROR frame
            got = P.recv_frame(conn)
            if got is None:
                return
            ftype, payload = got
            if ftype == P.T_BYE:
                return
            if ftype == P.T_LINE:
                if len(payload) - 8 > self.max_line_bytes:
                    raise ProtocolError(
                        "line_too_large",
                        f"line of {len(payload) - 8} bytes exceeds "
                        f"{self.max_line_bytes}")
                seq, text = P.unpack_line(payload)
                # PAUSE rides the fill side; the matching RESUME is the
                # worker's (it sees the queue drain — a client that goes
                # silent on PAUSE still gets woken)
                if not worker.paused and q.qsize() >= high:
                    worker.paused = True
                    sender(P.pack_frame(P.T_PAUSE))
                q.put(("line", seq, text))
            elif ftype == P.T_FLUSH:
                q.put(("flush",))
            else:
                raise ProtocolError("bad_frame",
                                    f"unexpected frame type {ftype}")
