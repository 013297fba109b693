"""Tiered retention over tenant archives (DESIGN.md §16).

Three tiers under one root, cheapest-to-touch first:

- **hot** — ``<root>/<tenant>.lzjs``: the appendable session the ingest
  daemon writes (plus its WAL sidecar directory).
- **sealed** — ``<root>/sealed/<tenant>.<n>.lzjs``: read-only segments
  produced on tenant roll-over by compacting the hot session at max
  level (dead templates GC'd, chunks recompressed, screens rebuilt).
- **rollup** — ``<root>/rollup/<utc-date>/<tenant>.<a>-<b>.lzjs``:
  time-partitioned merges of whole sealed windows; manifests are pruned
  of their verbatim texts (the planner then treats those chunks
  conservatively — soundness is unchanged, the footer just gets small).

Every tier is a plain v3 archive: fsck/repair, the query engine and the
CI gates apply to any of them unchanged.  ``RetentionManager.roll_tenant``
is the hook :class:`repro_torch.ingest.service.IngestDaemon` invokes when a
tenant worker seals (``retention=`` constructor argument); it is also
callable directly for offline archive management.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib
from dataclasses import dataclass

from ..core import integrity
from ..core.stream import FOOTER_MAGIC, LZJSReader, V3
from ..kernels.ops import check_device
from .compact import COMPACT_CHUNK_LINES, COMPACT_KERNEL, COMPACT_LEVEL, compact


@dataclass(frozen=True)
class RetentionPolicy:
    # merge this many sealed segments into one rollup (None = keep
    # sealed segments forever)
    rollup_after: int | None = 4
    level: int = COMPACT_LEVEL
    kernel: str = COMPACT_KERNEL
    chunk_lines: int = COMPACT_CHUNK_LINES
    # drop manifest verbatim texts in rollups; planner degrades to
    # "unknown" (conservative) for those chunks
    prune_rollup_manifests: bool = True
    salvage: bool = True


def prune_manifests(path: str) -> int:
    """Rewrite ``path``'s footer with manifest ``verbatim`` texts
    dropped (set to None = unknown).  Returns the number of chunks
    pruned.  The rewrite is in-place; a crash mid-write tears the
    footer, which fsck/repair rebuilds from the commit records — the
    same torn-footer story as any interrupted seal."""
    rd = LZJSReader(path)
    try:
        footer, off, version = rd.footer, rd.footer_offset, rd.version
    finally:
        rd.close()
    n = 0
    for e in footer.get("chunks", []):
        man = e.get("manifest")
        if man and man.get("verbatim"):
            man["verbatim"] = None
            n += 1
    footer["pruned"] = True
    fb = zlib.compress(json.dumps(footer).encode("utf-8"))
    with open(path, "r+b") as f:
        f.seek(off)
        f.truncate()
        f.write(fb)
        if version >= V3:
            f.write(integrity.trailer(fb))
        f.write(len(fb).to_bytes(8, "little"))
        f.write(FOOTER_MAGIC)
        f.flush()
        os.fsync(f.fileno())
    return n


class RetentionManager:
    """Policy-driven tier migration for one archive root.

    ``clock`` returns POSIX seconds (injectable so tests get
    deterministic rollup partitions)."""

    def __init__(self, root: str, policy: RetentionPolicy | None = None,
                 *, clock=time.time):
        self.root = os.fspath(root)
        self.policy = policy or RetentionPolicy()
        self._clock = clock
        self.sealed_dir = os.path.join(self.root, "sealed")
        self.rollup_dir = os.path.join(self.root, "rollup")

    # -------------------------------------------------------- listing

    def _sealed_segments(self, tenant: str) -> list[tuple[int, str]]:
        pat = re.compile(re.escape(tenant) + r"\.(\d+)\.lzjs$")
        out = []
        if os.path.isdir(self.sealed_dir):
            for name in os.listdir(self.sealed_dir):
                m = pat.fullmatch(name)
                if m:
                    out.append((int(m.group(1)),
                                os.path.join(self.sealed_dir, name)))
        return sorted(out)

    def tiers(self, tenant: str) -> dict:
        hot = os.path.join(self.root, tenant + ".lzjs")
        rollups = []
        if os.path.isdir(self.rollup_dir):
            for day in sorted(os.listdir(self.rollup_dir)):
                d = os.path.join(self.rollup_dir, day)
                for name in sorted(os.listdir(d)):
                    if name.startswith(tenant + ".") and name.endswith(".lzjs"):
                        rollups.append(os.path.join(d, name))
        return {
            "hot": hot if os.path.exists(hot) else None,
            "sealed": [p for _, p in self._sealed_segments(tenant)],
            "rollup": rollups,
        }

    # ------------------------------------------------------ migration

    def roll_tenant(self, tenant: str, device: str = "cuda") -> dict | None:
        """Hot session -> sealed segment (then maybe a rollup).

        Invoked by the ingest daemon after a tenant worker seals its
        session, with the daemon's ``device``, where the compactions run
        their kernels (``"cuda"`` raises where there is no card).
        Refuses (returns ``{"skipped": why}``) while a WAL sidecar still
        exists — records not yet folded into the archive must never be
        unlinked with it."""
        check_device(device)
        hot = os.path.join(self.root, tenant + ".lzjs")
        if not os.path.exists(hot):
            return None
        if os.path.isdir(hot + ".wal"):
            return {"skipped": "WAL sidecar present: session not fully "
                               "committed, keeping hot tier"}
        os.makedirs(self.sealed_dir, exist_ok=True)
        segs = self._sealed_segments(tenant)
        n = segs[-1][0] + 1 if segs else 0
        out = os.path.join(self.sealed_dir, f"{tenant}.{n:05d}.lzjs")
        p = self.policy
        rep = compact([hot], out, level=p.level, kernel=p.kernel,
                      chunk_lines=p.chunk_lines, salvage=p.salvage,
                      device=device)
        os.unlink(hot)
        result = {"sealed": out, "report": rep.to_dict()}
        rolled = self.rollup(tenant, device)
        if rolled is not None:
            result["rollup"] = rolled
        return result

    def rollup(self, tenant: str, device: str = "cuda") -> dict | None:
        """Merge the oldest full window of sealed segments into one
        time-partitioned rollup archive with pruned manifests, its
        compaction on ``device``."""
        check_device(device)
        p = self.policy
        if p.rollup_after is None:
            return None
        segs = self._sealed_segments(tenant)
        if len(segs) < p.rollup_after:
            return None
        window = segs[:p.rollup_after]
        day = time.strftime("%Y%m%d", time.gmtime(self._clock()))
        part = os.path.join(self.rollup_dir, day)
        os.makedirs(part, exist_ok=True)
        out = os.path.join(
            part, f"{tenant}.{window[0][0]:05d}-{window[-1][0]:05d}.lzjs")
        rep = compact([path for _, path in window], out,
                      level=p.level, kernel=p.kernel,
                      chunk_lines=p.chunk_lines, salvage=p.salvage,
                      device=device)
        pruned = prune_manifests(out) if p.prune_rollup_manifests else 0
        for _, path in window:
            os.unlink(path)
        return {"rollup": out, "pruned_chunks": pruned,
                "report": rep.to_dict()}
