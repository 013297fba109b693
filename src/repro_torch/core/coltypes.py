"""Typed parameter-column codecs (DESIGN.md §12).

The v1 layout stores every parameter column as escaped text behind the
sub-field ``ColumnCodec`` (+ a flat ParamDict at level 3) — which wastes
the structure most log parameters have: timestamps tick, block ids and
counters are integers, levels come from a tiny set, IPs factor into
subnet/host. LogShrink's ablation puts the variability structure of
parameter values at roughly the same CR contribution as template
extraction itself; this module is that idea for our columns.

``infer_column`` classifies one column over its distinct values into the
type lattice::

    TEXT  <  LOW_CARDINALITY_DICT
    TEXT  <  IP_HEX
    TEXT  <  NUMERIC  <  MONOTONE_INT
    TEXT  <  NUMERIC  <  TIMESTAMP

and ``encode_typed``/``decode_typed`` serialize per type:

- ``MONOTONE_INT``  — first value + plain varint deltas (>= 0);
- ``TIMESTAMP``     — delta-of-delta + zigzag varints (fixed-width digit
  columns whose deltas are near-constant: wall clocks, sequence ids);
- ``NUMERIC``       — frame-of-reference: zigzag(min) + varint offsets;
- ``LOW_CARDINALITY_DICT`` — per-column mini-dict + varint indices
  (local ids are denser than global ParaIDs and skip the sub-field
  machinery entirely);
- ``IP_HEX``        — dotted-quad IPv4 split into an interned ``a.b``
  subnet dict + 2 raw host bytes per row, or fixed-width hex packed two
  nibbles per byte.

A shared prefix/suffix over the whole column (``blk_``, ``0x``, ``/``)
is stripped into the descriptor before the core is classified, so block
ids and hex handles land in the integer/hex types.

Losslessness is decided at *classification* time: a type is only
claimed when re-rendering is provably exact (canonical integers, or
uniformly zero-padded non-negative ones; canonical octets; uniform-case
uniform-width hex). Anything else — mixed types, leading zeros, ``-0``,
unicode digits — falls back to TEXT, i.e. the untouched v1 layout.
Every typed encoding round-trips byte-exactly (fuzzed in
``tests/test_coltypes.py``).

Serialized layout per typed column ``name``:

    name.ct  descriptor: varint type id | varint flags
             [varint width]           (flag ZPAD / hex)
             [varint len + bytes]     (flag PREFIX)
             [varint len + bytes]     (flag SUFFIX)
             type params (first value / min+max, zigzag varints)
    name.cv  the main varint payload (deltas / offsets / dict ids /
             subnet ids / packed nibbles)
    name.cd  mini-dict values (DICT) or subnet dict (IPv4)
    name.ch  raw host byte pairs (IPv4)

The presence of ``name.ct`` is what selects the typed decode path —
v1 archives carry no descriptors and decode exactly as before.

The integer transforms (delta / delta-of-delta / frame-of-reference +
zigzag) have a device twin in ``repro_torch.kernels.colcodec`` (a CUDA
kernel) used when the kernel path is enabled; host and kernel bytes are
identical, small-magnitude columns ride the kernel and wide ones take the
arbitrary-precision host path.
"""

from __future__ import annotations

import re

import numpy as np

from .encode import (
    decode_varints,
    encode_varints,
    factorize,
    join_column,
    split_column,
    write_varint,
)

# type ids — serialized in descriptors, stable across versions
TEXT = 0
MONOTONE_INT = 1
TIMESTAMP = 2
NUMERIC = 3
LOW_CARDINALITY_DICT = 4
IP_HEX = 5

TYPE_NAMES = {
    TEXT: "text",
    MONOTONE_INT: "monotone_int",
    TIMESTAMP: "timestamp",
    NUMERIC: "numeric",
    LOW_CARDINALITY_DICT: "dict",
    IP_HEX: "ip_hex",
}

# descriptor flag bits
_F_ZPAD = 1       # fixed-width zero-padded integers (width follows)
_F_PREFIX = 2     # shared prefix follows
_F_SUFFIX = 4     # shared suffix follows
_F_HEX = 8        # IP_HEX: hex subkind (else dotted-quad IPv4)
_F_UPPER = 16     # IP_HEX/hex: uppercase digits

# shared with the query engine's typed-column screens — the screens'
# soundness depends on matching EXACTLY what classification admits
INT_RE = re.compile(r"-?[0-9]+\Z")
_INT_RE = INT_RE
_IP_RE = re.compile(r"([0-9]{1,3})\.([0-9]{1,3})\.([0-9]{1,3})\.([0-9]{1,3})\Z")
_HEX_LO_RE = re.compile(r"[0-9a-f]+\Z")
_HEX_UP_RE = re.compile(r"[0-9A-F]+\Z")

# columns whose |values| stay below this ride the int64 numpy transform;
# wider ones take the arbitrary-precision python path (same bytes)
_INT64_SAFE = 1 << 62
# the CUDA kernel works in 32-bit lanes: second differences of values
# below this bound cannot overflow (|dod| <= 4 * 2**28 < 2**31)
KERNEL_SAFE = 1 << 28

# mini-dict admission: enough rows to amortize the dict, and few enough
# distinct values that indices stay ~1 byte
_DICT_MAX_VALUES = 256
_DICT_MAX_FRACTION = 4  # n_distinct <= n_rows // 4

# streaming sessions keep integer cores at or above this width in the
# TEXT layout: wide identifiers (block ids, request ids) are
# stream-global entities whose value reuse happens ACROSS chunks, and
# the session ParamDict is the structure that dedups them across chunks
# (and gives the CLP-style dictionary screen its per-chunk watermark).
# Frame-of-reference varints of near-random 64-bit ids cost ~10 B/row
# in every chunk; a shared dict entry costs ~20 B once plus ~2 B/row.
# Narrow columns (timestamps, counters, ports) repeat poorly and delta
# well, so they stay typed.
WIDE_INT_TEXT = 12


def canonical_int(s: str) -> bool:
    """Is ``s`` a canonically-rendered decimal integer — the exact rule
    ``_classify_ints`` admits for width-0 (non-zero-padded) columns? The
    query engine's full-core needle screen must use this same predicate:
    a needle rejected under a STALE rule would skip a chunk that holds a
    hit."""
    return bool(INT_RE.match(s)) and \
        (s == "0" or not s.lstrip("-").startswith("0")) and s != "-0"


def int_value_realizable(entry: dict, value: str) -> bool:
    """Can a column summarized by the manifest ``tcol`` ``entry`` (an
    integer-family summary carrying ``lo``/``hi`` bounds and possibly
    shared affixes / a zero-pad width) realize ``value``?

    Used by the query engine's ``FieldEq`` chunk screen — soundness
    means answering True on ANY doubt (unknown affixes, no bounds), and
    rejecting only values provably outside what classification admitted:
    wrong affix, non-canonical rendering, or out of [lo, hi].
    """
    if entry.get("u"):
        return True  # affixes unserializable: realizable set unknown
    core = value
    pre, suf = entry.get("pre", ""), entry.get("suf", "")
    if pre:
        if not core.startswith(pre):
            return False
        core = core[len(pre):]
    if suf:
        if not core.endswith(suf):
            return False
        core = core[:len(core) - len(suf)]
    lo = entry.get("lo")
    if lo is None:
        return True  # no integer bounds recorded (e.g. ip_hex): undecidable
    if entry.get("w", 0):
        if len(core) != entry["w"] or not core.isdigit():
            return False
    elif not canonical_int(core):
        return False
    return lo <= int(core) <= entry["hi"]


def zigzag(v: int) -> int:
    return (v << 1) if v >= 0 else ((-v << 1) - 1)


def unzigzag(u: int) -> int:
    return (u >> 1) if not (u & 1) else -((u + 1) >> 1)


# --------------------------------------------------------------- inference

def _common_affixes(uvals: list[str]) -> tuple[str, str]:
    """Longest shared prefix and (non-overlapping) suffix of ``uvals``."""
    pre = uvals[0]
    for v in uvals[1:]:
        while not v.startswith(pre):
            pre = pre[:-1]
            if not pre:
                break
        if not pre:
            break
    cores = [v[len(pre):] for v in uvals]
    suf = cores[0]
    for v in cores[1:]:
        while not v.endswith(suf):
            suf = suf[1:]
            if not suf:
                break
        if not suf:
            break
    # digits at the affix/core boundary belong to the numeric payload:
    # a shared leading "203" of a timestamp column must not be peeled
    # off the values it is part of
    pre = pre.rstrip("0123456789")
    suf = suf.lstrip("0123456789")
    return pre, suf


def _classify_ints(cores: list[str]) -> dict | None:
    """Integer-family gate: every core is a canonically-rendered int —
    either no leading zeros (and no ``-0``), or all non-negative with one
    shared zero-padded width. Returns {vals, width} or None."""
    if not cores or any(not _INT_RE.match(c) for c in cores):
        return None
    widths = {len(c) for c in cores}
    canonical = all(canonical_int(c) for c in cores)
    uniform = len(widths) == 1 and not any(c.startswith("-") for c in cores)
    if canonical:
        return {"vals": [int(c) for c in cores], "width": 0,
                "uw": widths.pop() if uniform else 0}
    if uniform:
        w = widths.pop()
        return {"vals": [int(c) for c in cores], "width": w, "uw": w}
    return None


def _classify_ip4(cores: list[str]) -> bool:
    for c in cores:
        m = _IP_RE.match(c)
        if m is None:
            return False
        for o in m.groups():
            if int(o) > 255 or (len(o) > 1 and o[0] == "0"):
                return False
    return True


def _classify_hex(cores: list[str]) -> dict | None:
    if not cores:
        return None
    w = len(cores[0])
    if w < 4 or any(len(c) != w for c in cores):
        return None
    for rx, upper in ((_HEX_LO_RE, False), (_HEX_UP_RE, True)):
        if all(rx.match(c) for c in cores):
            letters = "abcdef" if not upper else "ABCDEF"
            if any(ch in letters for c in cores for ch in c):
                return {"width": w, "upper": upper}
            return None  # pure digits: the integer family owns it
    return None


def infer_column(values: list[str], uvals: list[str] | None = None, *,
                 wide_ints_text: bool = False) -> dict | None:
    """Classify one column -> descriptor info dict, or None for TEXT.

    The info dict always carries ``t`` (type id) / ``pre`` / ``suf``;
    integer types add ``vals`` (per-row python ints), ``width``
    (zero-pad, 0 = canonical) and ``lo``/``hi`` bounds; DICT adds the
    distinct ``dict_vals``; IP_HEX adds ``hex`` (subkind) and for hex
    ``width``/``upper``.

    ``wide_ints_text`` (streaming sessions): integer columns whose cores
    reach ``WIDE_INT_TEXT`` characters classify TEXT so they keep riding
    the session's cross-chunk ParamDict (see the constant's rationale).
    """
    n = len(values)
    if n == 0:
        return None
    if uvals is None:
        uvals = factorize(values)[1]
    if len(uvals) == 1:
        return {"t": LOW_CARDINALITY_DICT, "pre": "", "suf": "",
                "dict_vals": list(uvals)}
    # dotted quads are self-delimiting: check before affix stripping, which
    # would otherwise absorb a shared subnet ("10.9.") into the prefix
    if _classify_ip4(values):
        return {"t": IP_HEX, "pre": "", "suf": "", "hex": False, "cores": values}
    pre, suf = _common_affixes(uvals)
    cores = [v[len(pre):len(v) - len(suf)] if suf else v[len(pre):]
             for v in values]

    ints = _classify_ints(cores)
    if ints is not None and wide_ints_text and \
            max(len(c) for c in cores) >= WIDE_INT_TEXT:
        return None  # wide stream-global ids: the shared dict wins
    if ints is not None:
        vals = ints["vals"]
        info = {"pre": pre, "suf": suf, "vals": vals, "width": ints["width"],
                "lo": min(vals), "hi": max(vals)}
        if n >= 4 and all(b >= a for a, b in zip(vals, vals[1:])):
            info["t"] = MONOTONE_INT
        elif ints["uw"] >= 4:
            info["t"] = TIMESTAMP  # fixed-width digit column: wall clock /
            #                        sequence regime, near-constant deltas
        else:
            info["t"] = NUMERIC
        return info
    # IPs keep their dots in the payload too ("/10.251..." must not lose
    # the shared "/10." to the prefix)
    pre_ip = pre.rstrip("0123456789.")
    suf_ip = suf.lstrip("0123456789.")
    cores_ip = [v[len(pre_ip):len(v) - len(suf_ip)] if suf_ip else v[len(pre_ip):]
                for v in values]
    if _classify_ip4(cores_ip):
        return {"t": IP_HEX, "pre": pre_ip, "suf": suf_ip, "hex": False,
                "cores": cores_ip}
    hx = _classify_hex(cores)
    if hx is not None:
        return {"t": IP_HEX, "pre": pre, "suf": suf, "hex": True,
                "width": hx["width"], "upper": hx["upper"], "cores": cores}
    if n >= 16 and len(uvals) <= min(_DICT_MAX_VALUES, n // _DICT_MAX_FRACTION):
        return {"t": LOW_CARDINALITY_DICT, "pre": "", "suf": "",
                "dict_vals": list(uvals)}
    return None


# ------------------------------------------------------- integer transforms

def transform_ints(vals: list[int], kind: int) -> list[int]:
    """Reference transform, python ints (arbitrary precision).

    Returns the full-length transformed stream (index-aligned with
    ``vals``); the encoder slices off the entries its descriptor already
    carries. Semantics are mirrored bit-for-bit by the numpy fast path
    and the CUDA kernel (``repro_torch.kernels.colcodec``):

    - NUMERIC (frame-of-reference): ``t[i] = v[i] - min(v)``;
    - MONOTONE_INT (delta): ``t[0] = 0, t[i] = v[i] - v[i-1]``;
    - TIMESTAMP (delta-of-delta): first differences ``d`` (``d[0]=0``),
      then ``t = zigzag(d[i] - d[i-1])`` with ``d[-1]`` taken as 0.
    """
    if kind == NUMERIC:
        lo = min(vals)
        return [v - lo for v in vals]
    if kind == MONOTONE_INT:
        return [0] + [b - a for a, b in zip(vals, vals[1:])]
    if kind == TIMESTAMP:
        d = [0] + [b - a for a, b in zip(vals, vals[1:])]
        return [zigzag(b - a) for a, b in zip([0] + d[:-1], d)]
    raise ValueError(f"not an integer-family type: {kind}")


def untransform_ints(t: list[int], kind: int, first: int) -> list[int]:
    """Exact inverse of ``transform_ints`` over the full-length stream
    ``t``; ``first`` is the descriptor scalar (NUMERIC: min, else v0)."""
    if kind == NUMERIC:
        return [v + first for v in t]
    if kind == MONOTONE_INT:
        out = []
        cur = first
        for i, d in enumerate(t):
            cur = first if i == 0 else cur + d
            out.append(cur)
        return out
    if kind == TIMESTAMP:
        out = []
        cur = first
        d = 0
        for i, u in enumerate(t):
            d += unzigzag(u)
            cur = first if i == 0 else cur + d
            out.append(cur)
        return out
    raise ValueError(f"not an integer-family type: {kind}")


def _transform_numpy(arr: np.ndarray, kind: int) -> np.ndarray:
    """int64 fast path of ``transform_ints`` (callers gate magnitudes)."""
    if kind == NUMERIC:
        return arr - arr.min()
    prev = np.concatenate([arr[:1], arr[:-1]])
    d = arr - prev
    d[0] = 0
    if kind == MONOTONE_INT:
        return d
    dd = d - np.concatenate([[0], d[:-1]])
    return (np.abs(dd) << 1) - (dd < 0)


def _transformed_stream(vals: list[int], kind: int, use_kernel: bool,
                        device: str) -> list | np.ndarray:
    hi = max(abs(min(vals)), abs(max(vals)))
    if use_kernel and hi < KERNEL_SAFE:
        from ..kernels.ops import delta_zigzag

        return delta_zigzag(np.asarray([vals], np.int32),
                            np.asarray([len(vals)], np.int32),
                            np.asarray([kind], np.int32),
                            device=device)[0, :len(vals)].astype(np.int64)
    if hi < _INT64_SAFE:
        return _transform_numpy(np.asarray(vals, np.int64), kind)
    # arbitrary precision: object dtype keeps python ints exact all the
    # way into encode_varints (np.asarray would promote to float64)
    return np.array(transform_ints(vals, kind), dtype=object)


# ----------------------------------------------------------- encode / decode

class _Rd:
    """Sequential reader over a descriptor byte string."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def varint(self) -> int:
        cur = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError("truncated column-type descriptor")
            b = self.data[self.pos]
            self.pos += 1
            cur |= (b & 0x7F) << shift
            if not b & 0x80:
                return cur
            shift += 7

    def blob(self) -> bytes:
        ln = self.varint()
        out = self.data[self.pos:self.pos + ln]
        if len(out) != ln:
            raise ValueError("truncated column-type descriptor")
        self.pos += ln
        return out


def _affix_flags(info: dict, flags: int) -> int:
    if info.get("pre"):
        flags |= _F_PREFIX
    if info.get("suf"):
        flags |= _F_SUFFIX
    return flags


def _write_affixes(head: bytearray, info: dict) -> None:
    for key in ("pre", "suf"):
        s = info.get(key)
        if s:
            b = s.encode("utf-8", "surrogateescape")
            write_varint(head, len(b))
            head += b


def encode_typed(name: str, values: list[str], uvals: list[str] | None = None,
                 *, use_kernel: bool = True, device: str = "cuda",
                 wide_ints_text: bool = False) -> tuple[dict[str, bytes], dict] | None:
    """Typed encoding of one column -> ({objects}, summary), or None when
    the column classifies TEXT (caller falls back to the v1 layout).

    The summary feeds ``meta["coltypes"]`` and the LZJS chunk manifest:
    ``t``/``pre``/``suf`` always, ``lo``/``hi`` bounds for the integer
    family, the distinct ``vals`` for mini-dict columns, ``hex``/``upper``
    for IP_HEX.
    """
    info = infer_column(values, uvals, wide_ints_text=wide_ints_text)
    if info is None:
        return None
    t = info["t"]
    n = len(values)
    head = bytearray()
    write_varint(head, t)
    objs: dict[str, bytes] = {}
    summary: dict = {"t": TYPE_NAMES[t], "n": n}
    if info.get("pre"):
        summary["pre"] = info["pre"]
    if info.get("suf"):
        summary["suf"] = info["suf"]

    if t in (MONOTONE_INT, TIMESTAMP, NUMERIC):
        vals = info["vals"]
        flags = _affix_flags(info, _F_ZPAD if info["width"] else 0)
        write_varint(head, flags)
        if info["width"]:
            write_varint(head, info["width"])
        _write_affixes(head, info)
        stream = _transformed_stream(vals, t, use_kernel, device)
        if t == MONOTONE_INT:
            write_varint(head, zigzag(vals[0]))
            payload = stream[1:]
        elif t == TIMESTAMP:
            write_varint(head, zigzag(vals[0]))
            write_varint(head, int(stream[1]) if n > 1 else 0)
            payload = stream[2:]
        else:
            write_varint(head, zigzag(info["lo"]))
            write_varint(head, zigzag(info["hi"]))
            payload = stream
        objs[f"{name}.cv"] = encode_varints(payload)
        summary["lo"], summary["hi"] = info["lo"], info["hi"]
        if info["width"]:
            summary["w"] = info["width"]
    elif t == LOW_CARDINALITY_DICT:
        write_varint(head, _affix_flags(info, 0))
        _write_affixes(head, info)
        inv, uniq = factorize(values)
        objs[f"{name}.cd"] = join_column(uniq)
        objs[f"{name}.cv"] = encode_varints(inv)
        summary["vals"] = uniq
    else:  # IP_HEX
        cores = info["cores"]
        if info["hex"]:
            flags = _affix_flags(info, _F_HEX | (_F_UPPER if info["upper"] else 0))
            write_varint(head, flags)
            _write_affixes(head, info)
            write_varint(head, info["width"])
            nib = np.frombuffer("".join(cores).encode("ascii"), np.uint8)
            val = np.where(nib >= ord("A"), (nib & 0xF) + 9, nib - ord("0")).astype(np.uint8)
            if len(val) % 2:
                val = np.concatenate([val, np.zeros(1, np.uint8)])
            objs[f"{name}.cv"] = ((val[0::2] << 4) | val[1::2]).tobytes()
            summary["hex"] = True
            summary["width"] = info["width"]
            summary["upper"] = info["upper"]
        else:
            write_varint(head, _affix_flags(info, 0))
            _write_affixes(head, info)
            host = np.empty(2 * n, np.uint8)
            subnets = []
            for i, c in enumerate(cores):
                a, b, cc, d = c.split(".")
                subnets.append(f"{a}.{b}")
                host[2 * i] = int(cc)
                host[2 * i + 1] = int(d)
            sinv, suniq = factorize(subnets)
            objs[f"{name}.cd"] = join_column(suniq, already_safe=True)
            objs[f"{name}.cv"] = encode_varints(sinv)
            objs[f"{name}.ch"] = host.tobytes()
            summary["hex"] = False
    objs[f"{name}.ct"] = bytes(head)
    return objs, summary


def decode_typed(name: str, objs: dict[str, bytes], n: int) -> list[str]:
    """Inverse of ``encode_typed`` for a column whose ``name.ct`` exists."""
    rd = _Rd(objs[f"{name}.ct"])
    t = rd.varint()
    if t not in TYPE_NAMES or t == TEXT:
        raise ValueError(f"unknown column type id {t} for {name!r}")
    flags = rd.varint()
    width = rd.varint() if flags & _F_ZPAD else 0
    pre = rd.blob().decode("utf-8", "surrogateescape") if flags & _F_PREFIX else ""
    suf = rd.blob().decode("utf-8", "surrogateescape") if flags & _F_SUFFIX else ""

    if t in (MONOTONE_INT, TIMESTAMP, NUMERIC):
        payload = decode_varints(objs[f"{name}.cv"])
        first = unzigzag(rd.varint())
        if t == MONOTONE_INT:
            stream, want = [0] + payload, n - 1
        elif t == TIMESTAMP:
            d1 = rd.varint()  # zigzag(v1 - v0), raw from the transform
            stream, want = ([0, d1] + payload if n > 1 else [0]), max(n - 2, 0)
        else:
            rd.varint()  # zigzag(max): bounds ride for manifests/inspect
            stream, want = payload, n
        if len(payload) != want:
            raise ValueError(
                f"typed column {name!r}: payload {len(payload)} != expected {want}")
        vals = untransform_ints(stream, t, first)
        if width:
            cores = [str(v).zfill(width) for v in vals]
        else:
            cores = [str(v) for v in vals]
    elif t == LOW_CARDINALITY_DICT:
        uniq = split_column(objs[f"{name}.cd"])
        ids = decode_varints(objs[f"{name}.cv"])
        if len(ids) != n:
            raise ValueError(f"typed column {name!r}: {len(ids)} ids != {n} rows")
        return [uniq[i] for i in ids]  # dict never carries affixes
    else:  # IP_HEX
        if flags & _F_HEX:
            w = rd.varint()
            raw = np.frombuffer(objs[f"{name}.cv"], np.uint8)
            nib = np.empty(2 * len(raw), np.uint8)
            nib[0::2] = raw >> 4
            nib[1::2] = raw & 0xF
            if len(nib) < n * w:
                raise ValueError(f"typed column {name!r}: short hex payload")
            digits = "0123456789ABCDEF" if flags & _F_UPPER else "0123456789abcdef"
            lut = np.frombuffer(digits.encode("ascii"), np.uint8)
            chars = lut[nib[:n * w]].tobytes().decode("ascii")
            cores = [chars[i * w:(i + 1) * w] for i in range(n)]
        else:
            suniq = split_column(objs[f"{name}.cd"])
            sids = decode_varints(objs[f"{name}.cv"])
            host = np.frombuffer(objs[f"{name}.ch"], np.uint8)
            if len(sids) != n or len(host) != 2 * n:
                raise ValueError(f"typed column {name!r}: bad IPv4 payload")
            cores = [f"{suniq[sids[i]]}.{host[2 * i]}.{host[2 * i + 1]}"
                     for i in range(n)]
    if pre or suf:
        return [pre + c + suf for c in cores]
    return cores


def column_type_name(objs: dict[str, bytes], name: str) -> str | None:
    """Type name of column ``name`` (``None`` = v1 TEXT layout)."""
    ct = objs.get(f"{name}.ct")
    if ct is None:
        return None
    return TYPE_NAMES.get(_Rd(ct).varint(), "?")
