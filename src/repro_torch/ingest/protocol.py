"""Wire protocol of the ingestion daemon (DESIGN.md §15).

Length-prefixed binary frames over a unix or TCP socket::

    u8 frame_type | u32le payload_len | payload

Handshake: the client sends HELLO ``{"tenant": ..., "cfg": {...}?}``,
the daemon answers WELCOME ``{"next_seq": N, "resumed": bool}`` — the
client MUST (re)send from sequence ``N``; anything below is a duplicate
the daemon drops, anything above is a gap it rejects. Lines ride as
LINE frames (``u64le seq | utf-8 text``); the daemon acks durability
with ACK (``u64le next_undurable_seq``) — **an ack covers every
sequence strictly below its value, fsync-durable in the tenant WAL**.

Backpressure: PAUSE/RESUME are advisory frames around the daemon's
bounded per-tenant queue; a client that ignores PAUSE is throttled by
TCP flow control anyway (the daemon stops reading its socket), so a
firehose tenant degrades only itself. FLUSH forces the tenant session
to cut + commit a chunk and answers FLUSHED (``u64le committed_lines``).
Fatal conditions come back as ERROR frames carrying a structured JSON
body ``{"code", "message", "fatal"}`` before the daemon closes the
connection.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

T_HELLO = 1
T_WELCOME = 2
T_LINE = 3
T_ACK = 4
T_FLUSH = 5
T_FLUSHED = 6
T_PAUSE = 7
T_RESUME = 8
T_ERROR = 9
T_BYE = 10

_HEAD = struct.Struct("<BI")
_U64 = struct.Struct("<Q")
MAX_FRAME = 16 << 20  # bounds daemon memory per read, not per tenant


class ProtocolError(ValueError):
    """Malformed or out-of-contract frame; ``code`` travels in ERROR
    frames so clients can dispatch without parsing prose."""

    def __init__(self, code: str, message: str, *, fatal: bool = True):
        super().__init__(message)
        self.code = code
        self.fatal = fatal


def pack_frame(ftype: int, payload: bytes = b"") -> bytes:
    if len(payload) > MAX_FRAME:
        raise ProtocolError("frame_too_large",
                            f"frame of {len(payload)} bytes exceeds {MAX_FRAME}")
    return _HEAD.pack(ftype, len(payload)) + payload


def pack_line(seq: int, text: str) -> bytes:
    return pack_frame(T_LINE, _U64.pack(seq) +
                      text.encode("utf-8", "surrogateescape"))


def unpack_line(payload: bytes) -> tuple[int, str]:
    if len(payload) < 8:
        raise ProtocolError("bad_line_frame", "LINE frame shorter than its seq")
    return (_U64.unpack_from(payload)[0],
            payload[8:].decode("utf-8", "surrogateescape"))


def pack_u64(ftype: int, value: int) -> bytes:
    return pack_frame(ftype, _U64.pack(value))


def unpack_u64(payload: bytes) -> int:
    if len(payload) != 8:
        raise ProtocolError("bad_frame", "expected a u64 payload")
    return _U64.unpack(payload)[0]


def pack_json(ftype: int, obj: dict) -> bytes:
    return pack_frame(ftype, json.dumps(obj).encode("utf-8"))


def unpack_json(payload: bytes) -> dict:
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError("bad_json", f"undecodable JSON payload: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError("bad_json", "JSON payload must be an object")
    return obj


def recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary."""
    buf = bytearray()
    while len(buf) < n:
        try:
            got = sock.recv(n - len(buf))
        except (ConnectionResetError, BrokenPipeError):
            got = b""
        if not got:
            if buf:
                raise ProtocolError("torn_frame",
                                    f"connection died {len(buf)}/{n} bytes "
                                    f"into a frame")
            return None
        buf += got
    return bytes(buf)


def recv_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    """-> (type, payload), or None on clean EOF."""
    head = recv_exact(sock, _HEAD.size)
    if head is None:
        return None
    ftype, ln = _HEAD.unpack(head)
    if ln > MAX_FRAME:
        raise ProtocolError("frame_too_large",
                            f"frame of {ln} bytes exceeds {MAX_FRAME}")
    payload = recv_exact(sock, ln) if ln else b""
    if ln and payload is None:
        raise ProtocolError("torn_frame", "connection died before the payload")
    return ftype, payload or b""


def send_all(sock: socket.socket, data: bytes) -> None:
    sock.sendall(data)


def connect(address) -> socket.socket:
    """Dial a daemon address: a string path = unix socket, a (host,
    port) tuple = TCP."""
    if isinstance(address, (tuple, list)):
        return socket.create_connection(tuple(address))
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(str(address))
    return s


class IngestClient:
    """Blocking tenant client with a background ack reader.

    ``send`` assigns the next sequence number and honors daemon PAUSE
    frames (blocks until RESUME). ``flush`` forces a chunk commit and
    returns the archive's committed line count. ``acked`` is the highest
    durability watermark received — every seq below it survived an
    fsync, whatever happens to the daemon afterwards."""

    def __init__(self, address, tenant: str, cfg: dict | None = None,
                 *, timeout: float = 30.0):
        self.tenant = tenant
        self.timeout = timeout
        self._sock = connect(address)
        self._sock.settimeout(timeout)
        self._lock = threading.Lock()          # frame writes are atomic
        self._cond = threading.Condition()
        self.acked = 0
        self.paused = False
        self.closed = False
        self.error: ProtocolError | None = None
        self._flushed: list[int] = []
        hello = {"tenant": tenant}
        if cfg:
            hello["cfg"] = cfg
        send_all(self._sock, pack_json(T_HELLO, hello))
        got = recv_frame(self._sock)
        if got is None:
            raise ProtocolError("rejected", "daemon closed during handshake")
        ftype, payload = got
        if ftype == T_ERROR:
            err = unpack_json(payload)
            raise ProtocolError(err.get("code", "error"),
                                err.get("message", "rejected"))
        if ftype != T_WELCOME:
            raise ProtocolError("bad_frame", f"expected WELCOME, got {ftype}")
        w = unpack_json(payload)
        self.next_seq = int(w["next_seq"])
        self.resumed = bool(w.get("resumed"))
        with self._cond:
            self.acked = self.next_seq
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"ingest-client-{tenant}")
        self._reader.start()

    # -- background reader --------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                got = recv_frame(self._sock)
                if got is None:
                    break
                ftype, payload = got
                with self._cond:
                    if ftype == T_ACK:
                        self.acked = max(self.acked, unpack_u64(payload))
                    elif ftype == T_FLUSHED:
                        self._flushed.append(unpack_u64(payload))
                    elif ftype == T_PAUSE:
                        self.paused = True
                    elif ftype == T_RESUME:
                        self.paused = False
                    elif ftype == T_ERROR:
                        err = unpack_json(payload)
                        self.error = ProtocolError(
                            err.get("code", "error"),
                            err.get("message", "daemon error"),
                            fatal=bool(err.get("fatal", True)))
                    elif ftype == T_BYE:
                        break
                    self._cond.notify_all()
        except (OSError, ProtocolError) as e:
            with self._cond:
                if self.error is None:
                    self.error = e if isinstance(e, ProtocolError) else \
                        ProtocolError("io", str(e))
        finally:
            with self._cond:
                self.closed = True
                self._cond.notify_all()

    def _check(self) -> None:
        if self.error is not None and self.error.fatal:
            raise self.error
        if self.closed:
            raise ProtocolError("closed", "connection is closed")

    # -- sending -------------------------------------------------------
    def send(self, line: str) -> int:
        """Queue one line; returns its sequence number. Blocks while the
        daemon has us paused. NOT durable until ``acked`` passes it."""
        with self._cond:
            while self.paused and not self.closed and self.error is None:
                if not self._cond.wait(self.timeout):
                    raise ProtocolError("pause_timeout",
                                        "daemon kept us paused past the timeout")
            self._check()
            seq = self.next_seq
            self.next_seq = seq + 1
        with self._lock:
            send_all(self._sock, pack_line(seq, line))
        return seq

    def wait_ack(self, seq: int, timeout: float | None = None) -> int:
        """Block until the durability watermark passes ``seq``."""
        deadline = timeout if timeout is not None else self.timeout
        with self._cond:
            def ready():
                return self.acked > seq or self.closed or self.error is not None
            if not self._cond.wait_for(ready, deadline):
                raise ProtocolError("ack_timeout",
                                    f"no ack for seq {seq} within {deadline}s")
            if self.acked <= seq:
                self._check()
            return self.acked

    def flush(self, timeout: float | None = None) -> int:
        """Force a chunk commit; returns the committed line count."""
        with self._cond:
            self._check()
            n_before = len(self._flushed)
        with self._lock:
            send_all(self._sock, pack_frame(T_FLUSH))
        deadline = timeout if timeout is not None else self.timeout
        with self._cond:
            def ready():
                return (len(self._flushed) > n_before or self.closed
                        or self.error is not None)
            if not self._cond.wait_for(ready, deadline):
                raise ProtocolError("flush_timeout",
                                    f"no FLUSHED within {deadline}s")
            if len(self._flushed) <= n_before:
                self._check()
            return self._flushed[-1]

    def close(self) -> None:
        """Polite goodbye; daemon-side state is sealed by its own
        lifecycle, not by our departure."""
        try:
            with self._lock:
                send_all(self._sock, pack_frame(T_BYE))
        except OSError:
            pass
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        self._reader.join(timeout=self.timeout)
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "IngestClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
