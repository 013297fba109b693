"""Deterministic synthetic corpora in the styles of the paper's five
datasets (HDFS / Spark / Android / Windows / Thunderbird).

The container is offline, so the real loghub dumps are unavailable
(DESIGN.md §6.4). These generators preserve the *structural* properties
the paper's results hinge on:

- few templates dominate (Zipf-weighted logging statements);
- HDFS: long, indivisible, heavily-reused block ids (the Fig 6 L2->L3
  effect lives or dies on this);
- Windows: tiny template set + very repetitive params -> outsized CR;
- Thunderbird/Android: larger template sets, more parameter entropy;
- a small fraction of malformed/odd lines to exercise the verbatim paths.

Absolute CRs will differ from Table II; orderings/ablation shapes are the
reproduction targets.
"""

from __future__ import annotations

import dataclasses
import re
import zlib

import numpy as np

__all__ = [
    "DATASETS",
    "WorkloadSpec",
    "generate_lines",
    "generate_multitenant",
    "generate_workload",
    "generate_workload_multitenant",
    "write_dataset",
]


def _zipf_weights(n: int, s: float = 1.2) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


class _P:
    """Parameter generators. Each returns a string given the rng + pools."""

    def __init__(self, rng: np.random.Generator, reuse_pool: int = 4096):
        self.rng = rng
        # heavy-reuse pools (HDFS block ids etc. recur across lines)
        self.blk_pool = [f"blk_{rng.integers(-9e18, 9e18)}" for _ in range(reuse_pool)]
        self.ip_pool = [f"10.{rng.integers(256)}.{rng.integers(256)}.{rng.integers(256)}"
                        for _ in range(reuse_pool // 8)]
        self.host_pool = [f"node-{rng.integers(2048)}" for _ in range(reuse_pool // 8)]
        self.user_pool = [f"user{rng.integers(64)}" for _ in range(16)]

    def blk(self):
        return self.blk_pool[self.rng.integers(len(self.blk_pool))]

    def ip(self):
        return self.ip_pool[self.rng.integers(len(self.ip_pool))]

    def ipport(self):
        return f"{self.ip()}:{self.rng.integers(1024, 65536)}"

    def host(self):
        return self.host_pool[self.rng.integers(len(self.host_pool))]

    def num(self, hi=10**6):
        return str(self.rng.integers(hi))

    def small(self):
        return str(self.rng.integers(128))

    def size(self):
        return str(int(self.rng.choice([512, 1024, 4096, 65536, 67108864])))

    def path(self):
        return f"/data/part-{self.rng.integers(4096):05d}"

    def hexid(self):
        return f"0x{self.rng.integers(2**32):08x}"

    def pkg(self):
        return self.rng.choice(["com.android.systemui", "com.google.gms", "com.app.demo"])

    def dur(self):
        return f"{self.rng.random() * 100:.3f}"

    def user(self):
        return self.user_pool[self.rng.integers(len(self.user_pool))]


# Each dataset: (loghub format string, header generator, [(template, [param fns])])
# Template parameters are '{}' slots filled in order.


def _hdfs_header(rng, i, p):
    return {"Date": "081109", "Time": f"{203500 + i // 100:06d}",
            "Pid": str(rng.integers(1, 4000)),
            "Level": "INFO" if rng.random() < 0.97 else "WARN",
            "Component": rng.choice(["dfs.DataNode$PacketResponder", "dfs.FSNamesystem",
                                     "dfs.DataNode$DataXceiver", "dfs.DataBlockScanner"])}


def _spark_header(rng, i, p):
    return {"Date": "17/06/09", "Time": f"{10 + (i // 3600) % 12:02d}:{(i // 60) % 60:02d}:{i % 60:02d}",
            "Level": "INFO" if rng.random() < 0.95 else rng.choice(["WARN", "ERROR"]),
            "Component": rng.choice(["storage.BlockManager", "executor.Executor",
                                     "scheduler.TaskSetManager", "storage.memory.MemoryStore",
                                     "scheduler.DAGScheduler"])}


def _android_header(rng, i, p):
    return {"Date": "03-17", "Time": f"{10 + (i // 3600) % 12:02d}:{(i // 60) % 60:02d}:{i % 60:02d}.{rng.integers(1000):03d}",
            "Pid": str(rng.integers(100, 32000)), "Tid": str(rng.integers(100, 32000)),
            "Level": rng.choice(["D", "I", "V", "W", "E"], p=[0.35, 0.3, 0.2, 0.1, 0.05]),
            "Component": rng.choice(["PowerManagerService", "ActivityManager", "WindowManager",
                                     "AudioFlinger", "SensorService", "chatty"])}


def _windows_header(rng, i, p):
    return {"Date": "2016-09-28", "Time": f"{4 + (i // 3600) % 18:02d}:{(i // 60) % 60:02d}:{i % 60:02d}",
            "Level": "Info" if rng.random() < 0.99 else "Warning",
            "Component": "CBS"}


def _tbird_header(rng, i, p):
    return {"Label": "-", "Timestamp": str(1131500000 + i), "Date": "2005.11.09",
            "User": p.host(), "Month": "Nov", "Day": "9",
            "Time": f"{(i // 3600) % 24:02d}:{(i // 60) % 60:02d}:{i % 60:02d}",
            "Location": p.host(),
            "Component": rng.choice(["kernel", "sshd(pam_unix)", "crond(pam_unix)", "ib_sm.x"])}


DATASETS: dict[str, dict] = {
    "HDFS": {
        "format": "<Date> <Time> <Pid> <Level> <Component>: <Content>",
        "header": _hdfs_header,
        "templates": [
            ("Receiving block {} src: /{} dest: /{}", ["blk", "ipport", "ipport"]),
            ("BLOCK* NameSystem.addStoredBlock: blockMap updated: {} is added to {} size {}", ["ipport", "blk", "size"]),
            ("PacketResponder {} for block {} terminating", ["small", "blk"]),
            ("Received block {} of size {} from /{}", ["blk", "size", "ip"]),
            ("Deleting block {} file {}", ["blk", "path"]),
            ("BLOCK* NameSystem.allocateBlock: {} {}", ["path", "blk"]),
            ("Verification succeeded for {}", ["blk"]),
            ("BLOCK* NameSystem.delete: {} is added to invalidSet of {}", ["blk", "ipport"]),
            ("BLOCK* ask {} to replicate {} to datanode(s) {}", ["ipport", "blk", "ipport"]),
            ("Served block {} to /{}", ["blk", "ip"]),
            ("Got exception while serving {} to /{}:", ["blk", "ip"]),
            ("Receiving empty packet for block {}", ["blk"]),
        ],
        "zipf_s": 1.1,
        # block lifecycle sessions (Receiving -> addStoredBlock ->
        # PacketResponder [-> Received]): gives the event stream the
        # sequential structure real HDFS logs have (used by the
        # anomaly-detection example; DeepLog-style models need it)
        "sessions": (0.7, [[0, 1, 2], [0, 1, 2, 3]]),
    },
    "Spark": {
        "format": "<Date> <Time> <Level> <Component>: <Content>",
        "header": _spark_header,
        "templates": [
            ("Found block rdd_{}_{} locally", ["small", "small"]),
            ("Starting task {}.0 in stage {}.0 (TID {}, {}, executor {}, partition {}, PROCESS_LOCAL, {} bytes)",
             ["num", "small", "num", "host", "small", "num", "size"]),
            ("Finished task {}.0 in stage {}.0 (TID {}) in {} ms on {} (executor {}) ({}/{})",
             ["num", "small", "num", "num", "host", "small", "num", "num"]),
            ("Block {} stored as values in memory (estimated size {} B, free {} B)", ["hexid", "size", "size"]),
            ("Removing RDD {} from persistence list", ["small"]),
            ("Getting {} non-empty blocks out of {} blocks", ["num", "num"]),
            ("Running task {}.0 in stage {}.0 (TID {})", ["num", "small", "num"]),
            ("Ensuring free space for {} bytes", ["size"]),
            ("Started reading broadcast variable {}", ["small"]),
            ("Memory usage is {} MB, threshold {} MB", ["num", "num"]),
            ("Dropping block {} from memory", ["hexid"]),
            ("Submitting {} missing tasks from ResultStage {}", ["num", "small"]),
            ("Job {} finished: count at App.scala:{}, took {} s", ["small", "small", "dur"]),
            ("Executor updated: app-{}/{} is now RUNNING", ["num", "small"]),
        ],
        "zipf_s": 1.15,
    },
    "Android": {
        "format": "<Date> <Time> <Pid> <Tid> <Level> <Component>: <Content>",
        "header": _android_header,
        "templates": [
            ("acquire lock={}, flags=0x{}, tag=\"{}\", ws=null, uid={}, pid={}", ["hexid", "small", "pkg", "num", "num"]),
            ("release lock={}, flags=0x{}, total_time={}ms", ["hexid", "small", "num"]),
            ("Start proc {}:{}/u0a{} for service {}", ["num", "pkg", "small", "pkg"]),
            ("Killing {}:{}/u0a{} (adj {}): empty #{}", ["num", "pkg", "small", "small", "small"]),
            ("uid={} pid={} identical {} lines", ["num", "num", "small"]),
            ("Displayed {}/.MainActivity: +{}ms", ["pkg", "num"]),
            ("Slow Input: took {}ms for motion event", ["num"]),
            ("requestAudioFocus() from uid/pid {}/{}", ["num", "num"]),
            ("onSensorChanged: accuracy={} values=[{}, {}, {}]", ["small", "dur", "dur", "dur"]),
            ("setSystemUiVisibility vis={} mask={} oldVal={}", ["hexid", "hexid", "hexid"]),
            ("GC_CONCURRENT freed {}K, {}% free {}K/{}K, paused {}ms+{}ms, total {}ms",
             ["num", "small", "num", "num", "small", "small", "small"]),
            ("Window already focused, ignoring focus gain of: com.android.internal.view.IInputMethodClient$Stub$Proxy@{}", ["hexid"]),
        ],
        "zipf_s": 1.05,
    },
    "Windows": {
        "format": "<Date> <Time>, <Level> <Component> <Content>",
        "header": _windows_header,
        "templates": [
            ("Loaded Servicing Stack v6.1.7601.{} with Core: C:\\Windows\\winsxs\\amd64_microsoft-windows-servicingstack_31bf3856ad364e35_6.1.7601.{}_none_{}\\cbscore.dll", ["num", "num", "hexid"]),
            ("Warning: Unrecognized packageExtended attribute.", []),
            ("Expecting attribute name [HRESULT = 0x{} - CBS_E_MANIFEST_INVALID_ITEM]", ["hexid"]),
            ("Failed to get next element [HRESULT = 0x{} - CBS_E_MANIFEST_INVALID_ITEM]", ["hexid"]),
            ("Starting TrustedInstaller initialization.", []),
            ("Ending TrustedInstaller initialization.", []),
            ("Starting the TrustedInstaller main loop.", []),
            ("TrustedInstaller service starts successfully.", []),
            ("SQM: Initializing online with Windows opt-in: False", []),
            ("SQM: Cleaning up report files older than {} days.", ["small"]),
            ("SQM: Requesting upload of all unsent reports.", []),
            ("SQM: Failed to start upload with file pattern: C:\\Windows\\servicing\\sqm\\*_std.sqm, flags: 0x{} [HRESULT = 0x{} - E_FAIL]", ["small", "hexid"]),
        ],
        "zipf_s": 0.9,
    },
    "Thunderbird": {
        "format": "<Label> <Timestamp> <Date> <User> <Month> <Day> <Time> <Location> <Component>: <Content>",
        "header": _tbird_header,
        "templates": [
            ("session opened for user {} by (uid={})", ["user", "small"]),
            ("session closed for user {}", ["user"]),
            ("(root) CMD (run-parts /etc/cron.hourly)", []),
            ("authentication failure; logname= uid={} euid={} tty=ssh ruser= rhost={}", ["small", "small", "ip"]),
            ("Accepted publickey for {} from {} port {} ssh2", ["user", "ip", "num"]),
            ("ib_sm_sweep.c:{}; Fatal: Link/Port change detected on sweep {}", ["num", "num"]),
            ("kernel: ACPI: PCI interrupt {}[{}] -> GSI {} (level, low) -> IRQ {}", ["hexid", "small", "small", "small"]),
            ("imklog 3.{}.{}, log source = /proc/kmsg started.", ["small", "small"]),
            ("Installed: perl-{}-{}.el5.x86_64", ["dur", "small"]),
            ("running dhclient: eth{}: link up, 1000Mbps, full-duplex", ["small"]),
            ("Out of memory: Killed process {} ({}).", ["num", "pkg"]),
            ("CE sym error count exceeded, sym={}, count={}", ["small", "num"]),
            ("connect from {} ({})", ["ip", "ip"]),
            ("EXT3-fs: mounted filesystem with ordered data mode.", []),
        ],
        "zipf_s": 1.0,
    },
}


def generate_lines(name: str, n_lines: int, seed: int = 0, anomaly_rate: float = 0.0):
    """Yield ``n_lines`` log lines of dataset style ``name``.

    ``anomaly_rate`` injects rare-template bursts (used by the anomaly-
    detection example, not by compression benchmarks).
    """
    spec = DATASETS[name]
    rng = np.random.default_rng(seed)
    p = _P(rng)
    tmpls = spec["templates"]
    weights = _zipf_weights(len(tmpls), spec["zipf_s"])
    fmt = spec["format"]
    header_fn = spec["header"]
    anomaly_ids = {len(tmpls) - 1, len(tmpls) - 2}
    sess_prob, sess_seqs = spec.get("sessions", (0.0, []))
    pending: list[int] = []

    for i in range(n_lines):
        if rng.random() < 0.002:  # malformed lines -> verbatim channel
            yield rng.choice(["### corrupt entry ###", "", "\t", "raw dump: " + p.hexid()])
            continue
        if anomaly_rate and rng.random() < anomaly_rate:
            pending.clear()  # anomalies break sessions mid-flight
            t = int(rng.choice(sorted(anomaly_ids)))
        elif pending:
            t = pending.pop(0)
        elif sess_seqs and rng.random() < sess_prob:
            seq = sess_seqs[int(rng.integers(len(sess_seqs)))]
            t = seq[0]
            pending = list(seq[1:])
        else:
            t = int(rng.choice(len(tmpls), p=weights))
        template, params = tmpls[t]
        content = template.format(*[getattr(p, fn)() for fn in params])
        hdr = header_fn(rng, i, p)
        line = fmt
        for f, v in hdr.items():
            line = line.replace(f"<{f}>", str(v), 1)
        yield line.replace("<Content>", content, 1)


def _interleave(ids, gens, n_lines: int, seed: int, burstiness: float, weights):
    """Markov-bursty weighted interleaving of per-tenant line iterators.

    After emitting for tenant ``t``, the next line comes from ``t``
    again with probability ``burstiness + (1 - burstiness) * w[t]`` — 0
    gives pure weighted interleaving, values near 1 give long
    single-tenant runs (the firehose pattern backpressure tests want).
    """
    if not 0.0 <= burstiness < 1.0:
        raise ValueError(f"burstiness must be in [0, 1), got {burstiness}")
    rng = np.random.default_rng(seed)
    w = np.asarray(weights if weights is not None else [1.0] * len(ids),
                   dtype=float)
    if len(w) != len(ids) or (w <= 0).any():
        raise ValueError("weights must be positive, one per tenant")
    w = w / w.sum()
    cur = int(rng.choice(len(ids), p=w))
    for _ in range(n_lines):
        if rng.random() >= burstiness:
            cur = int(rng.choice(len(ids), p=w))
        yield ids[cur], next(gens[cur])


def generate_multitenant(tenants, n_lines: int, seed: int = 0, *,
                         burstiness: float = 0.0, weights=None):
    """Yield ``n_lines`` interleaved ``(tenant_id, line)`` pairs — the
    ingestion daemon's soak corpus (ROADMAP item 4 seed).

    ``tenants``: list of ``(tenant_id, dataset_name)``; each tenant gets
    its own deterministic per-tenant stream (``generate_lines`` with a
    seed derived from the global one), so the corpus stays a pure
    function of ``(tenants, params, seed)`` — splitting the interleaved
    output by tenant reproduces exactly what each single-tenant
    generator would emit. ``burstiness``/``weights`` as in
    ``_interleave``.
    """
    tenants = list(tenants)
    # distinct derived seeds: tenant streams must not be clones of each
    # other, and must not shift when the tenant list is reordered
    gens = [iter(generate_lines(name, n_lines, seed=seed + 104729 * (k + 1)))
            for k, (_tid, name) in enumerate(tenants)]
    yield from _interleave([tid for tid, _ in tenants], gens, n_lines, seed,
                           burstiness, weights)


# ------------------------------------------------------------------
# Parametric workload generator (ISSUE 10 / ROADMAP item 4).
#
# The five DATASETS above are *structural mimics* of fixed public logs;
# the soak harness needs corpora whose hard parts are **knobs**: how many
# logging statements exist, how skewed their use is, how many distinct
# parameter values circulate (and whether that cardinality RAMPS over
# time — ParamDict cold/hot pressure), whether statements appear/retire/
# mutate mid-stream (template DRIFT — TemplateStore growth and
# stream_min_support stress), how bursty the template sequence is, and
# how often a malformed line hits the verbatim path.
#
# Determinism contract: ``(spec, seed) -> byte-identical stream``. All
# per-line randomness is *counter-based* (splitmix64 over the line
# index), so the stream is a pure function of the frozen spec + seed,
# prefix-stable (the first k lines never depend on how many lines are
# generated in total), and the generator holds O(n_templates) state —
# multi-GB corpora never materialize anything proportional to their
# length. Parameter pools are *functional*: the j-th member of a value
# universe is computed from (seed, kind, j), never stored, so cardinality
# can ramp into the millions at zero resident cost.

_M64 = (1 << 64) - 1
_GOLD = 0x9E3779B97F4A7C15


def _mix(x: int) -> int:
    """splitmix64 finalizer — the per-line counter-based rng."""
    x &= _M64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def _u01(h: int) -> float:
    return (h >> 11) / float(1 << 53)


_WORK_WORDS = (
    "Receiving Received Deleting Starting Finished Verification Updating "
    "Registered Allocated Released Committed Replicating Scanning Opened "
    "Closed Rolling Expired Refreshing Mounting Probing Draining Sealing "
    "block replica session shard lease segment snapshot bucket region "
    "partition channel handle cursor volume index mapper reducer queue "
    "worker tenant stream container manifest checkpoint journal footer "
    "succeeded failed locally remotely upstream pending stale corrupt "
    "for from into onto under over with without to at on retry timeout"
).split()

# parameter-slot kinds: (salt, formatter over the mixed hash)
_WORK_KINDS = {
    "blk": lambda h: f"blk_{h % (10 ** 18)}",
    "ip": lambda h: f"10.{h & 255}.{(h >> 8) & 255}.{(h >> 16) & 255}",
    "ipport": lambda h: (f"10.{h & 255}.{(h >> 8) & 255}.{(h >> 16) & 255}"
                         f":{1024 + (h >> 24) % 64512}"),
    "num": lambda h: str(h % (10 ** 6)),
    "small": lambda h: str(h % 128),
    "size": lambda h: str((512, 1024, 4096, 65536, 1048576, 67108864)[h % 6]),
    "path": lambda h: f"/data/part-{h % 4096:05d}",
    "hexid": lambda h: f"0x{h & 0xFFFFFFFF:08x}",
    "dur": lambda h: f"{(h % 100_000) / 1000:.3f}",
    "host": lambda h: f"node-{h % 2048}",
}
_WORK_KIND_NAMES = tuple(_WORK_KINDS)
_MALFORMED = ("### corrupt entry ###", "", "\t", "raw dump: 0x%08x")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Frozen knob set for one synthetic workload stream.

    ``n_templates``: size of the *active* logging-statement universe
    (drift rotates membership but holds the count). ``zipf_s``: skew of
    statement use. ``pool_size``: base cardinality of every parameter
    kind's reuse pool; ``param_reuse`` is the fraction of draws taken
    from the pool's hot head (``pool_size // 64`` values), the rest are
    uniform over the *current* cardinality. ``cardinality_ramp`` grows
    that cardinality by ``ramp * pool_size`` per 10k lines — 0 keeps the
    closed-world reuse regime, >0 streams never-seen values at the
    ParamDict forever. ``burstiness``: Markov stay-probability of the
    template sequence (real logs emit statements in runs, not i.i.d.).
    ``malformed_rate``: fraction of lines that bypass structure and hit
    the verbatim channel. ``drift_rate``: per-line probability of a
    drift event; a ``mutate_fraction`` of those *mutate* an active
    statement (near-duplicate — clustering stress), the rest retire one
    statement and introduce a brand-new one (store growth stress).
    """

    format: str = "<Date> <Time> <Pid> <Level> <Component>: <Content>"
    n_templates: int = 64
    zipf_s: float = 1.1
    n_components: int = 8
    pool_size: int = 4096
    param_reuse: float = 0.6
    cardinality_ramp: float = 0.0
    burstiness: float = 0.0
    malformed_rate: float = 0.002
    drift_rate: float = 0.0
    mutate_fraction: float = 0.5

    def validate(self) -> "WorkloadSpec":
        if self.n_templates < 2:
            raise ValueError("n_templates must be >= 2")
        if self.pool_size < 1:
            raise ValueError("pool_size must be >= 1")
        for name in ("param_reuse", "malformed_rate", "drift_rate",
                     "mutate_fraction", "burstiness"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.cardinality_ramp < 0.0:
            raise ValueError("cardinality_ramp must be >= 0")
        return self


def _synth_template(base: int, birth: int) -> tuple[str, tuple[str, ...]]:
    """Deterministic logging statement #``birth``: interleaved literal
    words and ``{}`` parameter slots -> (format string, slot kinds)."""
    h = _mix(base ^ (birth + 1) * _GOLD)
    n_words = 3 + h % 5
    n_slots = (h >> 8) % 4
    parts: list[str] = []
    kinds: list[str] = []
    # literal first token: keeps first-token bucketing honest
    parts.append(_WORK_WORDS[(h >> 16) % len(_WORK_WORDS)])
    slots_left, words_left = n_slots, n_words - 1
    k = 1
    while slots_left or words_left:
        hh = _mix(h + k)
        k += 1
        if slots_left and (words_left == 0 or hh % 2):
            kind = _WORK_KIND_NAMES[(hh >> 8) % len(_WORK_KIND_NAMES)]
            kinds.append(kind)
            parts.append("{}")
            slots_left -= 1
        else:
            parts.append(_WORK_WORDS[(hh >> 8) % len(_WORK_WORDS)])
            words_left -= 1
    return " ".join(parts), tuple(kinds)


def _mutate_template(tmpl: tuple[str, tuple[str, ...]],
                     h: int) -> tuple[str, tuple[str, ...]]:
    """A near-duplicate of ``tmpl``: one literal word swapped, or a new
    parameter slot appended — the statement "evolved" in a code change."""
    text, kinds = tmpl
    parts = text.split(" ")
    word_at = [i for i, p in enumerate(parts) if p != "{}"]
    if h % 2 and word_at:
        i = word_at[_mix(h + 1) % len(word_at)]
        parts[i] = _WORK_WORDS[_mix(h + 2) % len(_WORK_WORDS)]
        return " ".join(parts), kinds
    kind = _WORK_KIND_NAMES[_mix(h + 3) % len(_WORK_KIND_NAMES)]
    word = _WORK_WORDS[_mix(h + 4) % len(_WORK_WORDS)]
    return f"{text} {word} {{}}", kinds + (kind,)


def generate_workload(spec: WorkloadSpec, n_lines: int | None, seed: int = 0):
    """Yield lines of the parametric workload — a pure, prefix-stable
    function of ``(spec, seed)``; ``n_lines=None`` streams forever.

    Memory is O(``spec.n_templates``) regardless of length: the only
    sequential state is the active template set (drift) and the previous
    template id (burstiness); every other decision is counter-based on
    the line index.
    """
    spec.validate()
    base = _mix(seed * _GOLD + 0x50A7)
    # active statement universe: slot-indexed, drift rotates members
    births = spec.n_templates
    active = [_synth_template(base, b) for b in range(births)]
    weights = _zipf_weights(spec.n_templates, spec.zipf_s)
    cum = np.cumsum(weights)
    cum[-1] = 1.0  # guard fp round-off at the tail
    components = [f"svc{k}.Worker" for k in range(max(1, spec.n_components))]
    fields = [f for f in _FMT_FIELDS(spec.format) if f != "Content"]
    hot = max(1, spec.pool_size // 64)
    kind_salt = {k: _mix(base ^ (i + 1) * 0xC2B2AE3D27D4EB4F)
                 for i, k in enumerate(_WORK_KIND_NAMES)}
    ramp_per_line = spec.cardinality_ramp * spec.pool_size / 10_000.0
    prev_t: int | None = None
    i = 0
    while n_lines is None or i < n_lines:
        h0 = _mix(base ^ (i + 1) * _GOLD)
        # -- drift: applied BEFORE the line is emitted, sequentially ----
        if spec.drift_rate and _u01(_mix(h0 + 1)) < spec.drift_rate:
            hd = _mix(h0 + 2)
            slot = hd % spec.n_templates
            if _u01(_mix(hd + 1)) < spec.mutate_fraction:
                active[slot] = _mutate_template(active[slot], _mix(hd + 2))
            else:
                active[slot] = _synth_template(base, births)  # retire + birth
            births += 1
            if prev_t == slot:
                prev_t = None  # the statement it pointed at is gone
        # -- malformed lines -> verbatim channel ------------------------
        if _u01(_mix(h0 + 3)) < spec.malformed_rate:
            m = _MALFORMED[_mix(h0 + 4) % len(_MALFORMED)]
            yield m % (_mix(h0 + 5) & 0xFFFFFFFF) if "%" in m else m
            i += 1
            continue
        # -- template choice: Markov burst or Zipf draw ------------------
        if prev_t is not None and _u01(_mix(h0 + 6)) < spec.burstiness:
            t = prev_t
        else:
            t = int(np.searchsorted(cum, _u01(_mix(h0 + 7)), side="right"))
            t = min(t, spec.n_templates - 1)
        prev_t = t
        text, kinds = active[t]
        # -- parameters: hot-head reuse over a (possibly ramping) pool --
        if kinds:
            card = spec.pool_size + int(ramp_per_line * i)
            vals = []
            for k, kind in enumerate(kinds):
                hp = _mix(h0 + 16 + 2 * k)
                j = hp % hot if _u01(_mix(h0 + 17 + 2 * k)) < spec.param_reuse \
                    else hp % card
                vals.append(_WORK_KINDS[kind](_mix(kind_salt[kind] + j)))
            content = text.format(*vals)
        else:
            content = text
        # -- header ------------------------------------------------------
        line = spec.format
        for f in fields:
            line = line.replace(f"<{f}>", _work_header(f, i, h0, components), 1)
        yield line.replace("<Content>", content, 1)
        i += 1


def _FMT_FIELDS(fmt: str) -> list[str]:
    return re.findall(r"<(\w+)>", fmt)


def _work_header(field: str, i: int, h0: int, components: list[str]) -> str:
    """Deterministic header value for ``field`` at line ``i`` — known
    names get realistic shapes (monotone Time, mostly-INFO Level, a small
    Component pool), anything else a low-cardinality token."""
    # zlib.crc32, not hash(): str hash is salted per process and would
    # break the (spec, seed) -> byte-identical contract
    h = _mix(h0 ^ zlib.crc32(field.encode()))
    if field == "Date":
        return "081109"
    if field == "Time":
        return f"{203500 + i // 100:06d}"
    if field == "Pid":
        return str(1 + h % 4000)
    if field == "Level":
        return "INFO" if _u01(h) < 0.97 else "WARN"
    if field == "Component":
        return components[h % len(components)]
    return f"v{h % 997}"


def generate_workload_multitenant(tenants, n_lines: int, seed: int = 0, *,
                                  burstiness: float = 0.0, weights=None):
    """Interleaved ``(tenant_id, line)`` pairs over parametric workloads
    — the daemon-mode soak corpus.

    ``tenants``: list of ``(tenant_id, WorkloadSpec)``. Seeds derive per
    tenant exactly like ``generate_multitenant``, so splitting the
    interleaved output by tenant reproduces what each single-tenant
    ``generate_workload`` would emit (property-tested, drift included).
    """
    tenants = list(tenants)
    gens = [iter(generate_workload(sp, None, seed=seed + 104729 * (k + 1)))
            for k, (_tid, sp) in enumerate(tenants)]
    yield from _interleave([tid for tid, _ in tenants], gens, n_lines, seed,
                           burstiness, weights)


def write_dataset(name: str, path: str, n_lines: int, seed: int = 0) -> int:
    """Write a corpus to ``path``; returns byte size."""
    total = 0
    with open(path, "w", encoding="utf-8") as f:
        first = True
        for line in generate_lines(name, n_lines, seed):
            if not first:
                f.write("\n")
                total += 1
            f.write(line)
            total += len(line.encode("utf-8"))
            first = False
    return total
