"""The log generator of the benchmark: a frozen copy of the port's
``data/loggen.py`` generator (``generate_lines`` and the five dataset
styles of the Logzip paper: HDFS, Spark, Android, Windows, Thunderbird),
so that the traffic a cell is measured on cannot move with the program.

``generate_lines(name, n, seed)`` yields the same lines for the same
arguments: few templates dominate (Zipf-weighted logging statements),
parameters come from reuse pools, and 0.2% of the lines are malformed.
"""

from __future__ import annotations

import numpy as np


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
