"""Write-ahead journal for the ingestion daemon (DESIGN.md §15).

A line handed to the daemon is *acked* only after it is fsync-durable in
this journal — the archive session behind it may buffer, batch and crash
freely, because restart-time replay (``replay_wal`` + the archive's own
committed-line watermark) reconstructs exactly the acked suffix the
archive never sealed. Records are keyed by the tenant's line sequence
number, which is by construction the line's index in the tenant archive:
dedup on replay is an integer comparison, not a heuristic.

Layout (one directory per tenant)::

    <wal_dir>/<base_seq:020d>.wal
        b"LZWL" | u8 version | crc4                      (segment header)
        repeat: varint(seq) | varint(len) | payload | crc4(varints+payload)

Frame sealing reuses ``core.integrity`` (CRC32C, same trailer the LZJS
container uses). The journal is append-only; a crash tears at most the
unsynced tail of a segment, and replay stops scanning a segment at the
first record that fails its checksum — everything before the tear was
fsynced and is therefore intact; anything acked after it lives in a
later segment (a surviving writer retires a torn segment and re-journals
into a fresh one).

Segments are garbage-collected once the archive's sealed ``CMT1`` commit
covering their last record is fsync-durable (``gc(watermark)``): the
journal holds only the acked-but-not-yet-committed window, so its size
is bounded by the session's chunk budget, not the stream length.

A restarted writer never appends after a torn tail (records there would
sit beyond the replay horizon and be silently lost) — it always opens a
fresh segment at the recovery sequence number.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import threading

from . import integrity
from .encode import write_varint
from .integrity import CRC_LEN

WAL_MAGIC = b"LZWL"
WAL_VERSION = 1
SEGMENT_SUFFIX = ".wal"
_HEADER = WAL_MAGIC + bytes([WAL_VERSION])
_HEADER_LEN = len(_HEADER) + CRC_LEN


class WalError(ValueError):
    """Structural damage the journal cannot absorb (a gap in the acked
    record chain); torn tails are NOT errors — they are the expected
    crash wreckage and replay simply stops there."""


def _take_varint(buf: bytes, pos: int) -> tuple[int, int]:
    cur = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        cur |= (b & 0x7F) << shift
        if not b & 0x80:
            return cur, pos
        shift += 7


def encode_record(seq: int, text: str) -> bytes:
    """One sealed WAL record. ``text`` round-trips arbitrary log lines
    (surrogateescape, same convention as the CLI readers)."""
    payload = text.encode("utf-8", "surrogateescape")
    rec = bytearray()
    write_varint(rec, seq)
    write_varint(rec, len(payload))
    rec += payload
    rec += integrity.trailer(bytes(rec))
    return bytes(rec)


def parse_record(buf: bytes, pos: int) -> tuple[int, str, int] | None:
    """Parse + verify the record at ``pos`` -> (seq, text, end); None when
    the bytes there are torn or fail their seal (replay horizon)."""
    try:
        seq, p = _take_varint(buf, pos)
        ln, p = _take_varint(buf, p)
    except ValueError:
        return None
    payload = buf[p:p + ln]
    if len(payload) != ln:
        return None
    stored = buf[p + ln:p + ln + CRC_LEN]
    if len(stored) != CRC_LEN or \
            integrity.crc32c(buf[pos:p + ln]) != int.from_bytes(stored, "little"):
        return None
    return seq, payload.decode("utf-8", "surrogateescape"), p + ln + CRC_LEN


def _segment_paths(wal_dir: str) -> list[tuple[int, str]]:
    """(base_seq, path) of every segment, sorted by base sequence."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return []
    for name in names:
        if not name.endswith(SEGMENT_SUFFIX):
            continue
        stem = name[:-len(SEGMENT_SUFFIX)]
        if stem.isdigit():
            out.append((int(stem), os.path.join(wal_dir, name)))
    out.sort()
    return out


def _fsync_dir(path: str) -> None:
    try:
        dfd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


@dataclasses.dataclass
class WalReplay:
    """Everything recovery needs from one scan of the journal."""
    records: list  # [(seq, text)] of every intact record, seq-ascending
    end_seq: int   # next sequence number after the last intact record
    torn: bool     # a record failed its seal (expected after a crash)
    segments: int  # segment files seen


def replay_wal(wal_dir: str, start: int = 0) -> WalReplay:
    """Scan the journal and return every intact record with
    ``seq >= start`` in sequence order.

    A record that fails its seal ends the scan of ITS segment (no way to
    find the next record boundary past a tear) but later segments are
    still read: a writer that survived an ``ENOSPC`` retires the torn
    segment and re-journals the staged batch into a fresh one, so acked
    records can legitimately live past a tear — in a *later* segment,
    never the same one. Duplicate sequence numbers across segments keep
    the later copy (a retried writer generation re-journaled the line);
    a genuinely missing acked record still fails the gap check below."""
    by_seq: dict[int, str] = {}
    segs = _segment_paths(wal_dir)
    torn = False
    end_seq = 0
    for base, path in segs:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            torn = True
            continue
        if data[:len(_HEADER)] != _HEADER or \
                len(data) < _HEADER_LEN or \
                integrity.crc32c(_HEADER) != int.from_bytes(
                    data[len(_HEADER):_HEADER_LEN], "little"):
            torn = True
            continue
        pos = _HEADER_LEN
        while pos < len(data):
            got = parse_record(data, pos)
            if got is None:
                torn = True
                break
            seq, text, pos = got
            by_seq[seq] = text
            end_seq = max(end_seq, seq + 1)
    records = [(seq, by_seq[seq]) for seq in sorted(by_seq) if seq >= start]
    for (a, _), (b, _) in zip(records, records[1:]):
        if b != a + 1:
            raise WalError(
                f"WAL gap: record {a} is followed by {b} — an acked record "
                f"is missing (multi-fault damage beyond the torn-tail model)")
    return WalReplay(records=records, end_seq=end_seq, torn=torn,
                     segments=len(segs))


class WalWriter:
    """Append-only journal writer with group commit.

    ``append`` stages records in memory; ``sync`` writes the staged
    batch in one system write, fsyncs, and returns the durable sequence
    watermark — the ack the daemon sends covers exactly ``sync``'s
    return. A crash before ``sync`` loses only staged (unacked) records;
    a torn ``sync`` write loses only the torn suffix, which by
    definition was never acked either.

    ``opener`` is injectable for fault tests (``FaultyOpener``); files
    are opened unbuffered so the bytes the OS saw are exactly the bytes
    ``sync`` pushed — in-process crash simulation stays faithful.

    Thread-safety: ``append``/``sync`` (tenant worker) and ``gc``
    (archive commit callback, possibly another thread) take the same
    lock."""

    def __init__(self, wal_dir: str, *, next_seq: int = 0,
                 segment_bytes: int = 1 << 20, opener=open):
        self.wal_dir = os.fspath(wal_dir)
        self.segment_bytes = int(segment_bytes)
        self._opener = opener
        self._lock = threading.Lock()
        self._pending = bytearray()
        self._pending_first: int | None = None
        self.next_seq = int(next_seq)        # next sequence to append
        self.durable_seq = int(next_seq)     # everything below is fsynced
        self._f = None
        self._seg_path: str | None = None
        self._seg_size = 0
        # base_seq -> (path, last_seq) of sealed (non-current) segments
        self._sealed: dict[int, tuple[str, int]] = {
            base: (path, -1) for base, path in _segment_paths(self.wal_dir)}
        os.makedirs(self.wal_dir, exist_ok=True)

    # -- appending -----------------------------------------------------
    def append(self, text: str) -> int:
        """Stage one line; returns its sequence number. NOT yet durable —
        ack only after ``sync``."""
        with self._lock:
            seq = self.next_seq
            if self._pending_first is None:
                self._pending_first = seq
            self._pending += encode_record(seq, text)
            self.next_seq = seq + 1
            return seq

    def sync(self) -> int:
        """Write + fsync every staged record; returns the durable
        sequence watermark (1 + last durable seq). Raises ``OSError``
        (ENOSPC et al.) with nothing acked for the staged batch — the
        staged records stay staged, so a recovered sink can retry."""
        with self._lock:
            if not self._pending:
                return self.durable_seq
            self._rotate_if_needed(len(self._pending))
            data = bytes(self._pending)
            try:
                self._f.write(data)
                os.fsync(self._f.fileno())
            except OSError:
                # the write may have torn mid-record: retire this segment
                # (its intact prefix still replays; the tear ends it) so
                # a retried sync re-journals the WHOLE batch into a fresh
                # segment — never after a torn tail
                self._retire_segment()
                raise
            self._seg_size += len(data)
            self._pending.clear()
            self._pending_first = None
            self.durable_seq = self.next_seq
            return self.durable_seq

    def _retire_segment(self) -> None:
        """Stop writing to the current segment after a failed sync; its
        durable records (everything below ``durable_seq``) stay eligible
        for gc, and the next sync opens a fresh segment."""
        if self._f is None:
            return
        try:
            self._f.close()
        except OSError:
            pass
        base = int(os.path.basename(self._seg_path)[:-len(SEGMENT_SUFFIX)])
        self._sealed[base] = (self._seg_path, self.durable_seq - 1)
        self._f = None
        self._seg_path = None
        self._seg_size = 0

    def _rotate_if_needed(self, incoming: int) -> None:
        if self._f is not None and self._seg_size + incoming <= self.segment_bytes:
            return
        base = self._pending_first if self._pending_first is not None \
            else self.next_seq
        if self._f is not None:
            # seal the previous segment: its last record is base - 1
            try:
                self._f.close()
            except OSError:
                pass
            prev_base = int(os.path.basename(self._seg_path)[:-len(SEGMENT_SUFFIX)])
            self._sealed[prev_base] = (self._seg_path, base - 1)
        path = os.path.join(self.wal_dir, f"{base:020d}{SEGMENT_SUFFIX}")
        f = self._opener(path, "wb", buffering=0)
        f.write(_HEADER + integrity.trailer(_HEADER))
        os.fsync(f.fileno())
        _fsync_dir(self.wal_dir)  # the new name must survive a crash too
        self._f = f
        self._seg_path = path
        self._seg_size = _HEADER_LEN

    def journal_bytes(self) -> int:
        """On-disk size of the journal (sealed segments + the current
        one). The ingestion daemon's forced-flush trigger keys on this:
        a tenant that trickles lines below the chunk threshold never
        fires the archive commit hook, so without a size/age trigger its
        journal would grow without bound."""
        with self._lock:
            total = self._seg_size
            for path, _last in self._sealed.values():
                try:
                    total += os.path.getsize(path)
                except OSError:
                    pass
            return total

    # -- garbage collection --------------------------------------------
    def gc(self, watermark: int) -> int:
        """Drop every sealed segment whose records all precede
        ``watermark`` (= archive committed-line count, fsync-durable).
        The current segment is never dropped. Returns segments removed."""
        removed = 0
        with self._lock:
            for base in sorted(self._sealed):
                path, last = self._sealed[base]
                if last < 0:
                    # found on disk at startup: its last record is bounded
                    # by the next segment's base (or this writer's start)
                    later = [b for b in self._sealed if b > base]
                    if self._seg_path is not None:
                        later.append(int(os.path.basename(
                            self._seg_path)[:-len(SEGMENT_SUFFIX)]))
                    later.append(self.next_seq)
                    last = min(later) - 1
                if last < watermark:
                    try:
                        os.unlink(path)
                    except OSError as e:
                        if e.errno != errno.ENOENT:
                            continue
                    del self._sealed[base]
                    removed += 1
            if removed:
                _fsync_dir(self.wal_dir)
        return removed

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        """Durable close: sync staged records, then release the handle."""
        with self._lock:
            if self._pending:
                self._rotate_if_needed(len(self._pending))
                self._f.write(bytes(self._pending))
                os.fsync(self._f.fileno())
                self._pending.clear()
                self._pending_first = None
                self.durable_seq = self.next_seq
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    def abandon(self) -> None:
        """Test hook: drop the handle WITHOUT flushing staged records —
        the in-process equivalent of ``kill -9`` between ack batches."""
        with self._lock:
            self._pending.clear()
            self._pending_first = None
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
