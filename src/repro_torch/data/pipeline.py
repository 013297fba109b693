"""Training data pipeline over logzip-compressed shards.

Storage layer = the paper's codec: corpora are written as directories of
logzip archives (one archive per shard). Readers decompress shards on
host CPUs (exactly where entropy decode belongs) and feed either

- raw text bytes (``mode="bytes"``: LM pretraining on log text), or
- EventID sequences (``mode="events"``: DeepLog-style template-stream
  modelling, straight from the archive IR — no re-parsing).

Production properties implemented here and unit-tested:

- **exact resumability**: the batcher state is (shard, line, carry) and
  round-trips through ``state_dict``/``load_state_dict`` — restarts are
  sample-exact after a failure;
- **straggler mitigation**: ``PrefetchLoader`` decodes shards with a
  small thread pool into a bounded queue; a shard that exceeds
  ``straggler_timeout`` is skipped-and-requeued so one slow host never
  stalls the step loop (the skip is logged and bounded);
- **determinism**: shard order is a seeded permutation per epoch.

The shard writers compress on ``cfg.device`` (``cfg=None`` builds
``LogzipConfig(level=3, kernel="gzip")``, on the card by default), so
their ``match_first`` calls and typed columns launch the port's kernels;
the archives are byte-identical on every device. Readers decode on the
host; ``TokenBatcher`` hands its batches over as ``torch.int32`` tensors
on its ``device``.

Two storage layouts share one reader interface:

- a directory of independent ``.lzj`` archives (``write_logzip_shards``);
- one appendable ``LZJS`` container (``write_logzip_stream``), where each
  manifest shard is ``"corpus.lzjs::chunkK"`` — ``read_shard`` seeks the
  chunk through the footer index (no full-container decode) and, in
  ``events`` mode, returns the session's *global* EventIDs (stable
  across every chunk, which per-shard archives cannot offer).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.codec import LogzipConfig, compress, decompress, read_structured
from ..kernels.ops import check_device

PAD, BOS, EOS = 0, 1, 2
BYTE_OFFSET = 3  # token id = byte value + 3
BYTE_VOCAB = 256 + BYTE_OFFSET


def encode_bytes(line: str) -> np.ndarray:
    b = line.encode("utf-8", errors="surrogateescape")
    return np.frombuffer(b, np.uint8).astype(np.int32) + BYTE_OFFSET


def decode_bytes(ids: np.ndarray) -> str:
    b = bytes((np.asarray(ids)[np.asarray(ids) >= BYTE_OFFSET] - BYTE_OFFSET).astype(np.uint8))
    return b.decode("utf-8", errors="surrogateescape")


# ------------------------------------------------------------------ shards

def write_logzip_shards(
    lines_iter,
    out_dir: str,
    shard_lines: int = 20000,
    cfg: LogzipConfig | None = None,
) -> dict:
    """Write an iterator of lines into logzip shard files + manifest."""
    cfg = cfg or LogzipConfig(level=3, kernel="gzip")
    check_device(cfg.device)
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    buf: list[str] = []
    raw_bytes = 0
    comp_bytes = 0

    def flush():
        nonlocal raw_bytes, comp_bytes
        if not buf:
            return
        blob = compress(buf, cfg)
        name = f"shard-{len(shards):05d}.lzj"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(blob)
        shards.append({"file": name, "n_lines": len(buf), "bytes": len(blob)})
        raw_bytes += sum(len(l.encode("utf-8", "surrogateescape")) + 1 for l in buf)
        comp_bytes += len(blob)
        buf.clear()

    for line in lines_iter:
        buf.append(line)
        if len(buf) >= shard_lines:
            flush()
    flush()
    manifest = {
        "shards": shards,
        "raw_bytes": raw_bytes,
        "compressed_bytes": comp_bytes,
        "level": cfg.level,
        "kernel": cfg.kernel,
        "format": cfg.format,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def write_logzip_stream(
    lines_iter,
    out_dir: str,
    shard_lines: int = 20000,
    cfg: LogzipConfig | None = None,
    name: str = "corpus.lzjs",
) -> dict:
    """Write an iterator of lines into ONE appendable LZJS container plus
    a manifest whose shards address chunks via the footer index."""
    from ..core.stream import StreamingCompressor

    cfg = cfg or LogzipConfig(level=3, kernel="gzip")
    check_device(cfg.device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    raw_bytes = 0
    with StreamingCompressor(path, cfg, chunk_lines=shard_lines) as sc:
        for line in lines_iter:
            raw_bytes += len(line.encode("utf-8", "surrogateescape")) + 1
            sc.feed_line(line)
        sc.close()
        index = sc.index
    manifest = {
        "container": name,
        "shards": [
            {"file": f"{name}::chunk{k}", "n_lines": e["n_lines"], "bytes": e["length"]}
            for k, e in enumerate(index)
        ],
        "raw_bytes": raw_bytes,
        "compressed_bytes": os.path.getsize(path),
        "level": cfg.level,
        "kernel": cfg.kernel,
        "format": cfg.format,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


_LZJS_READERS: dict[str, tuple] = {}  # path -> (reader, (mtime_ns, size))
_LZJS_LOCK = threading.Lock()


def _lzjs_reader(path: str):
    """Footer-parsed-once reader cache (thread-safe: LZJSReader locks its
    file handle per chunk read). Keyed on (mtime, size) so a rewritten or
    appended container is re-opened instead of served from a stale index."""
    from ..core.stream import LZJSReader

    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    with _LZJS_LOCK:
        entry = _LZJS_READERS.get(path)
        if entry is None or entry[1] != key:
            if entry is not None:
                entry[0].close()
            entry = (LZJSReader(path), key)
            _LZJS_READERS[path] = entry
        return entry[0]


def read_shard(path: str, mode: str = "bytes") -> list[np.ndarray]:
    if "::chunk" in path:
        base, _, suffix = path.rpartition("::chunk")
        rd = _lzjs_reader(base)
        k = int(suffix)
        if mode == "events":
            return [rd.read_events(k)]
        return [encode_bytes(l) for l in rd.decode_chunk(k)]
    with open(path, "rb") as f:
        blob = f.read()
    if mode == "events":
        ev = read_structured(blob)["events"]
        return [ev]
    return [encode_bytes(l) for l in decompress(blob)]


# ------------------------------------------------------------------ batcher

@dataclass
class _State:
    epoch: int = 0
    shard_pos: int = 0   # position in the permuted shard order
    line_pos: int = 0    # lines consumed within current shard
    carry: np.ndarray | None = None  # leftover tokens


class TokenBatcher:
    """Packs shard lines into (B, S) next-token batches; exactly resumable.

    Batches are ``torch.int32`` tensors on ``device`` ("cuda" by default,
    which raises where there is no card); the state stays on the host."""

    def __init__(self, shard_dir: str, mode: str = "bytes", eos: bool = True, seed: int = 0,
                 reader=read_shard, device="cuda"):
        self.device = check_device(device)
        with open(os.path.join(shard_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.dir = shard_dir
        self.mode = mode
        self.eos = eos
        self.seed = seed
        self.reader = reader
        self.st = _State(carry=np.zeros((0,), np.int32))
        self._shard_cache: tuple[int, list[np.ndarray]] | None = None

    # -- state ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "epoch": self.st.epoch,
            "shard_pos": self.st.shard_pos,
            "line_pos": self.st.line_pos,
            "carry": self.st.carry.tolist(),
        }

    def load_state_dict(self, d: dict) -> None:
        self.st = _State(d["epoch"], d["shard_pos"], d["line_pos"], np.array(d["carry"], np.int32))
        self._shard_cache = None

    # -- iteration ------------------------------------------------------
    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        return rng.permutation(len(self.manifest["shards"]))

    def _lines(self):
        """Infinite stream of token vectors, tracking state."""
        while True:
            order = self._order(self.st.epoch)
            while self.st.shard_pos < len(order):
                si = int(order[self.st.shard_pos])
                if self._shard_cache is None or self._shard_cache[0] != si:
                    path = os.path.join(self.dir, self.manifest["shards"][si]["file"])
                    self._shard_cache = (si, self.reader(path, self.mode))
                lines = self._shard_cache[1]
                while self.st.line_pos < len(lines):
                    v = lines[self.st.line_pos]
                    self.st.line_pos += 1
                    yield v
                self.st.shard_pos += 1
                self.st.line_pos = 0
            self.st.epoch += 1
            self.st.shard_pos = 0

    def next_batch(self, batch: int, seq: int) -> dict[str, torch.Tensor]:
        """-> {tokens (B,S), labels (B,S)} with label = next token, PAD=-1
        ignored by the loss. Documents are EOS-joined and packed."""
        need = batch * (seq + 1)
        chunks = [self.st.carry]
        have = len(self.st.carry)
        gen = self._lines()
        while have < need:
            v = next(gen)
            if self.eos:
                v = np.concatenate([v, [EOS]])
            chunks.append(v.astype(np.int32))
            have += len(v)
        flat = np.concatenate(chunks)
        used, self.st.carry = flat[:need], flat[need:]
        arr = used.reshape(batch, seq + 1)
        return {"tokens": torch.from_numpy(arr[:, :-1].copy()).to(self.device),
                "labels": torch.from_numpy(arr[:, 1:].copy()).to(self.device)}


# ---------------------------------------------------------------- prefetch

class PrefetchLoader:
    """Decode-ahead with straggler requeue.

    ``reader(path)`` runs in worker threads; results enter a bounded
    queue. If no shard completes within ``straggler_timeout`` seconds,
    every in-flight shard that has exceeded the timeout is *actually*
    re-put into ``self.pending`` (up to ``max_requeues`` attempts each),
    so a genuinely lost shard — hung reader, dead worker — is retried by
    another worker instead of stalling the iterator forever. Duplicate
    completions (the original attempt finishing after its retry) are
    dropped, and a *failure* from a superseded attempt is ignored while
    a retry for that shard is still queued or running (hang-then-raise
    readers get their retry). A shard that exhausts its retries raises
    ``RuntimeError``; an error with no retry outstanding propagates.
    """

    def __init__(self, paths: list[str], reader, depth: int = 4, workers: int = 2,
                 straggler_timeout: float = 30.0, max_requeues: int = 5):
        # NOTE: straggler_timeout should comfortably exceed a normal read —
        # a slow-but-healthy shard burns one requeue per timeout window,
        # and only `max_requeues` consecutive windows without a completion
        # escalate to RuntimeError.
        # repeated paths are collapsed (order-preserving): delivery is
        # tracked per path, so duplicates would stall the served-count
        self.paths = list(dict.fromkeys(paths))
        self.reader = reader
        self.timeout = straggler_timeout
        self.max_requeues = max_requeues
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.pending: queue.Queue = queue.Queue()
        self.stats = {"served": 0, "straggler_requeues": 0}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._inflight: dict[str, float] = {}   # path -> attempt start time
        self._requeues: dict[str, int] = {}     # path -> retry count
        self._live: dict[str, int] = {}         # path -> queued + running attempts
        for p in self.paths:
            self._live[p] = 1
            self.pending.put(p)
        self.threads = [threading.Thread(target=self._work, daemon=True) for _ in range(workers)]
        for t in self.threads:
            t.start()

    def _put(self, item) -> None:
        """Bounded q.put that keeps checking _stop so an abandoned
        iterator can't leave workers blocked on a full queue forever."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _work(self):
        while not self._stop.is_set():
            try:
                path = self.pending.get(timeout=0.1)
            except queue.Empty:
                continue  # stay alive: requeued stragglers may arrive later
            with self._lock:
                self._inflight[path] = time.monotonic()
            try:
                data = self.reader(path)
            except Exception as e:  # pragma: no cover - defensive
                with self._lock:
                    self._inflight.pop(path, None)
                    self._live[path] = self._live.get(path, 1) - 1
                self._put(("error", path, e))
                continue
            with self._lock:
                self._inflight.pop(path, None)
                self._live[path] = self._live.get(path, 1) - 1
            self._put(("ok", path, data, time.monotonic()))

    def _requeue_stale(self) -> None:
        """Re-put every timed-out in-flight shard (bounded retries)."""
        now = time.monotonic()
        with self._lock:
            stale = [p for p, t0 in self._inflight.items() if now - t0 > self.timeout]
            for p in stale:
                tries = self._requeues.get(p, 0)
                if tries >= self.max_requeues:
                    raise RuntimeError(
                        f"shard {p!r} lost: {tries} requeues all timed out "
                        f"(straggler_timeout={self.timeout}s)")
                self._requeues[p] = tries + 1
                # reset the attempt clock so the same stall isn't requeued
                # again before the retry has had a full timeout window
                self._inflight[p] = now
                self._live[p] = self._live.get(p, 0) + 1
                self.stats["straggler_requeues"] += 1
                self.pending.put(p)

    def __iter__(self):
        served = 0
        delivered: set[str] = set()
        total = len(self.paths)
        try:
            while served < total:
                try:
                    item = self.q.get(timeout=self.timeout)
                except queue.Empty:
                    self._requeue_stale()
                    continue
                if item[1] in delivered:
                    continue  # late duplicate (or late failure) of a
                    # requeued straggler whose retry already served it
                if item[0] == "error":
                    with self._lock:
                        retry_possible = self._live.get(item[1], 0) > 0
                    if retry_possible:
                        continue  # another attempt is queued or running —
                        # a hang-then-raise reader still gets its retry
                    raise item[2]
                delivered.add(item[1])
                served += 1
                self.stats["served"] = served
                yield item[1], item[2]
        finally:
            # iteration over (complete or abandoned): stop the workers so
            # a consumer that breaks out early doesn't leak polling threads
            self._stop.set()

    def close(self):
        self._stop.set()
