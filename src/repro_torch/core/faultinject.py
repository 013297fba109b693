"""Write-fault injection for durability testing (DESIGN.md §13).

``FaultyFile`` wraps any binary file object and cuts writes off at a
configurable byte budget, the way a full disk or a killed process does:
the write that crosses the budget lands only a prefix (a torn write) and
every write after it raises ``OSError(ENOSPC)``. Reads, seeks and
closes keep working, so the wreckage can be inspected in place.

``tests/test_faultinject.py`` drives the recovery property with this:
inject a fault at every record boundary (and a dense sample of
mid-record positions), then assert ``recover.repair`` gets every line of
every committed chunk back.
"""

from __future__ import annotations

import errno
import io


class FaultyFile(io.RawIOBase):
    """Binary file wrapper that tears writes after ``write_limit`` bytes.

    - total bytes written stays <= ``write_limit``: the crossing write
      lands its allowed prefix only, then raises ``OSError(ENOSPC)``;
    - every later write (and flush, once broken) raises too — a broken
      sink stays broken, like a full disk;
    - ``write_limit=None`` passes everything through (control runs).
    """

    def __init__(self, raw, write_limit: int | None = None, *,
                 shared=None, close_raw: bool = False):
        super().__init__()
        self.raw = raw
        self._close_raw = close_raw
        # ``shared`` (a FaultyOpener or any object with write_limit /
        # bytes_written / broken / faults attrs) pools the byte budget
        # across several files — "this filesystem is full", not "this
        # file is full". Without it the file carries its own budget.
        self._budget = shared if shared is not None else self
        if shared is None:
            self.write_limit = write_limit
            self.bytes_written = 0
            self.broken = False
            self.faults = 0

    # -- fault-injected write path ------------------------------------
    def write(self, data) -> int:
        data = bytes(data)
        bd = self._budget
        if bd.broken:
            bd.faults += 1
            raise OSError(errno.ENOSPC, "no space left on device (injected)")
        if bd.write_limit is not None and \
                bd.bytes_written + len(data) > bd.write_limit:
            allowed = max(0, bd.write_limit - bd.bytes_written)
            if allowed:
                self.raw.write(data[:allowed])
                bd.bytes_written += allowed
            bd.broken = True
            bd.faults += 1
            raise OSError(errno.ENOSPC, "no space left on device (injected)")
        n = self.raw.write(data)
        bd.bytes_written += len(data) if n is None else n
        return len(data)

    def flush(self) -> None:
        if getattr(self.raw, "closed", False):
            return  # RawIOBase.close() flushes after close_raw already ran
        if self._budget.broken:
            self._budget.faults += 1
            raise OSError(errno.EIO, "flush on broken sink (injected)")
        self.raw.flush()

    # -- transparent passthrough --------------------------------------
    def read(self, *a):
        return self.raw.read(*a)

    def seek(self, *a):
        return self.raw.seek(*a)

    def tell(self):
        return self.raw.tell()

    def truncate(self, *a):
        return self.raw.truncate(*a)

    def fileno(self):
        return self.raw.fileno()

    def readable(self) -> bool:
        return self.raw.readable()

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return self.raw.seekable()

    def close(self) -> None:
        # by default never closes the wrapped object: tests read the
        # wreckage after; opener-owned real files DO close (close_raw)
        if self._close_raw:
            try:
                self.raw.close()
            except OSError:
                pass
        super().close()

    def getvalue(self) -> bytes:
        """Bytes that actually landed (BytesIO sinks)."""
        return self.raw.getvalue()


class FaultyOpener:
    """``open()``-compatible factory whose files share ONE write budget —
    the per-subsystem ENOSPC model (DESIGN.md §15): hand one instance to
    the WAL and another to the archive session and the disk fills under
    each independently. Read-only modes pass through untouched."""

    def __init__(self, write_limit: int | None = None):
        self.write_limit = write_limit
        self.bytes_written = 0
        self.broken = False
        self.faults = 0

    def __call__(self, path, mode="r", *a, **kw):
        f = open(path, mode, *a, **kw)
        if "w" not in mode and "a" not in mode and "+" not in mode:
            return f
        return FaultyFile(f, shared=self, close_raw=True)

    def reset(self) -> None:
        """Clear the broken state + counters (the disk was 'freed')."""
        self.bytes_written = 0
        self.broken = False
        self.faults = 0


def flip_bit(data: bytes, offset: int, mask: int = 0x40) -> bytes:
    """One-byte corruption at ``offset`` (returns a copy)."""
    out = bytearray(data)
    out[offset] ^= mask
    return bytes(out)
