"""Frame integrity for v3 archives (DESIGN.md §13): CRC32C trailers and
the structured ``IntegrityError``.

Every frame a v3 container writes — the LZJF kernel blob, the LZJS
session header, per-chunk payload / template-delta / ParamDict-delta
frames, the commit record and the footer index — is followed by a
4-byte little-endian CRC32C (Castagnoli) of the frame bytes.  Readers
verify on touch and raise ``IntegrityError`` carrying *which* frame
failed, at *which* byte offset, in *which* chunk — the difference
between "archive corrupt" and an actionable fsck report.

CRC32C (not zlib's CRC-32/ISO-HDLC) because it is the storage-stack
convention (iSCSI, ext4, btrfs, leveldb): a torn write that splices two
archives generated with the same tooling still fails the check, and
hardware-accelerated verification is available everywhere this format
could be re-implemented.  Large frames take a numpy-vectorized path
(independent per-block table CRCs + a log-depth GF(2) fold), small ones
a slicing-by-16 scalar loop — either way checksumming stays invisible
next to the entropy kernel.
"""

from __future__ import annotations

import struct

CRC_LEN = 4  # trailer size in bytes

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected


def _build_tables() -> list[list[int]]:
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t0.append(c)
    tables = [t0]
    for _ in range(15):
        prev = tables[-1]
        tables.append([t0[v & 0xFF] ^ (v >> 8) for v in prev])
    return tables


_T = _build_tables()
_U16 = struct.Struct("<QQ")


def _crc_scalar(data, crc: int = 0) -> int:
    """Slicing-by-16 CRC-32C, continuing from ``crc``."""
    crc = ~crc & 0xFFFFFFFF
    mv = memoryview(data)
    n = len(mv)
    i = 0
    t = _T
    # slicing-by-16: fold the running crc into the first word, then
    # 16 independent table lookups per iteration
    end16 = n - (n % 16)
    while i < end16:
        lo, hi = _U16.unpack_from(mv, i)
        lo ^= crc
        crc = (
            t[15][lo & 0xFF] ^ t[14][(lo >> 8) & 0xFF]
            ^ t[13][(lo >> 16) & 0xFF] ^ t[12][(lo >> 24) & 0xFF]
            ^ t[11][(lo >> 32) & 0xFF] ^ t[10][(lo >> 40) & 0xFF]
            ^ t[9][(lo >> 48) & 0xFF] ^ t[8][(lo >> 56) & 0xFF]
            ^ t[7][hi & 0xFF] ^ t[6][(hi >> 8) & 0xFF]
            ^ t[5][(hi >> 16) & 0xFF] ^ t[4][(hi >> 24) & 0xFF]
            ^ t[3][(hi >> 32) & 0xFF] ^ t[2][(hi >> 40) & 0xFF]
            ^ t[1][(hi >> 48) & 0xFF] ^ t[0][(hi >> 56) & 0xFF]
        )
        i += 16
    t0 = t[0]
    while i < n:
        crc = t0[(crc ^ mv[i]) & 0xFF] ^ (crc >> 8)
        i += 1
    return ~crc & 0xFFFFFFFF


# ------------------------------------------------- vectorized bulk path
#
# CRC is GF(2)-linear in the message: with zero initial state,
# raw(A || B) = shift_{|B|}(raw(A)) ^ raw(B), where shift_L is the linear
# map "multiply by x^{8L} mod P".  The bulk path computes the raw CRC of
# every 16-byte block with pure table XORs (numpy, no data dependence),
# then folds pairs level by level — shift_L at each level is applied to
# the whole vector of partial CRCs through four 256-entry tables.  A
# Python loop therefore runs O(log n) vector steps instead of O(n/16)
# scalar steps.  Equality with ``_crc_scalar`` is property-tested.

_NPT = None          # (16, 256) uint32: per-position block tables
_SHIFT_TABLES: dict[int, object] = {}   # L bytes -> (4, 256) uint32 map


def _gf2_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: list[int]) -> list[int]:
    return [_gf2_times(mat, mat[i]) for i in range(32)]


_SHIFT_MATS: dict[int, list[int]] = {}


def _shift_matrix(nbytes: int) -> list[int]:
    """Columns of the linear map ``state -> state after nbytes zero bytes``."""
    out = _SHIFT_MATS.get(nbytes)
    if out is None:
        # one zero byte: state -> T0[state & 0xFF] ^ (state >> 8)
        mat = [_T[0][(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
        out = [1 << i for i in range(32)]  # identity
        n = nbytes
        while n:
            if n & 1:
                out = [_gf2_times(mat, out[i]) for i in range(32)]
            mat = _gf2_square(mat)
            n >>= 1
        _SHIFT_MATS[nbytes] = out
    return out


def _shift_table(nbytes: int):
    """(4, 256) uint32 tables applying ``_shift_matrix(nbytes)`` to a
    uint32 vector byte-by-byte."""
    import numpy as np

    tab = _SHIFT_TABLES.get(nbytes)
    if tab is None:
        mat = _shift_matrix(nbytes)
        tab = np.zeros((4, 256), np.uint32)
        for b in range(4):
            base = [mat[8 * b + i] for i in range(8)]
            row = tab[b]
            for v in range(256):
                acc = 0
                vv = v
                i = 0
                while vv:
                    if vv & 1:
                        acc ^= base[i]
                    vv >>= 1
                    i += 1
                row[v] = acc
        _SHIFT_TABLES[nbytes] = tab
    return tab


def _shift_vec(crcs, nbytes: int):
    tab = _shift_table(nbytes)
    return (tab[0][crcs & 0xFF] ^ tab[1][(crcs >> 8) & 0xFF]
            ^ tab[2][(crcs >> 16) & 0xFF] ^ tab[3][crcs >> 24])


def _crc_bulk(data, crc: int = 0) -> int:
    import numpy as np

    global _NPT
    if _NPT is None:
        _NPT = np.asarray(_T, np.uint32)
    n = len(data)
    m = n // 16
    head = m * 16
    arr = np.frombuffer(data, np.uint8, count=head).reshape(m, 16)
    bc = _NPT[15][arr[:, 0]]
    for j in range(1, 16):
        bc ^= _NPT[15 - j][arr[:, j]]
    # fold the initial state into the first block — same as the scalar
    # loop's ``lo ^= crc``, expressed through the position tables
    init = ~crc & 0xFFFFFFFF
    bc[0] ^= (_NPT[15][init & 0xFF] ^ _NPT[14][(init >> 8) & 0xFF]
              ^ _NPT[13][(init >> 16) & 0xFF] ^ _NPT[12][init >> 24])
    # pad the FRONT to a power of two: leading zero blocks leave a
    # zero-state raw CRC unchanged, so the fold lengths stay uniform
    m2 = 1 << (m - 1).bit_length()
    if m2 != m:
        bc = np.concatenate([np.zeros(m2 - m, np.uint32), bc])
    level = 16
    while len(bc) > 1:
        bc = _shift_vec(bc[0::2], level) ^ bc[1::2]
        level *= 2
    state = int(bc[0])
    t0 = _T[0]
    for b in memoryview(data)[head:]:
        state = t0[(state ^ b) & 0xFF] ^ (state >> 8)
    return ~state & 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc`` (chainable)."""
    if len(data) >= 512:
        return _crc_bulk(data, crc)
    return _crc_scalar(data, crc)


def trailer(data: bytes) -> bytes:
    """The 4-byte little-endian CRC32C trailer for one frame."""
    return crc32c(data).to_bytes(CRC_LEN, "little")


class IntegrityError(ValueError):
    """A frame failed its CRC32C check (or a sealed commit record is
    missing/invalid).

    Subclasses ``ValueError`` so every pre-v3 caller that guards decode
    paths with ``except ValueError`` keeps working; carries structured
    fields so fsck / salvage tooling can report and quarantine precisely.

    Attributes: ``frame`` (e.g. ``"chunk_payload"``, ``"template_delta"``,
    ``"footer"``), ``offset`` (byte position of the frame in the
    container, when known) and ``chunk`` (chunk index, when applicable).
    """

    def __init__(self, message: str, *, frame: str, offset: int | None = None,
                 chunk: int | None = None):
        loc = f" frame={frame}"
        if chunk is not None:
            loc += f" chunk={chunk}"
        if offset is not None:
            loc += f" offset={offset}"
        super().__init__(f"{message} [{loc.strip()}]")
        self.frame = frame
        self.offset = offset
        self.chunk = chunk


def verify(data: bytes, stored: bytes, *, frame: str, offset: int | None = None,
           chunk: int | None = None) -> None:
    """Check ``data`` against its stored trailer; raise ``IntegrityError``
    on mismatch (including a short/missing trailer)."""
    if len(stored) != CRC_LEN:
        raise IntegrityError(
            f"missing CRC32C trailer ({len(stored)}/{CRC_LEN} bytes)",
            frame=frame, offset=offset, chunk=chunk)
    got = crc32c(data)
    want = int.from_bytes(stored, "little")
    if got != want:
        raise IntegrityError(
            f"CRC32C mismatch: computed {got:#010x}, stored {want:#010x}",
            frame=frame, offset=offset, chunk=chunk)
