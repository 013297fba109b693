"""Archive lifecycle (DESIGN.md §16): compaction, cross-session
re-clustering and tiered retention over LZJS sessions.

- ``recluster`` — merge N sessions' template stores into one fresh
  store: GC dead templates, fold near-duplicates (DeLog-style pattern
  synthesis via the paper's φ/LCS primitives), specialize templates
  whose star columns stayed constant, with deterministic EventID remap
  tables.
- ``compact`` — the engine behind ``logzip compact``: decode N sessions
  (salvaged inputs welcome; damaged chunks skipped and REPORTED, never
  silently dropped) through a re-clustered shared store into one sealed,
  max-level v3 archive with rebuilt manifests, typed-column summaries
  and per-chunk screens.
- ``retention`` — tiered policy the ingestion daemon invokes on tenant
  roll-over: hot appendable session → sealed recompressed segment →
  time-partitioned rollup with pruned manifests.
"""

from .compact import CompactionReport, compact
from .recluster import ReclusterResult, recluster_stores
from .retention import RetentionManager, RetentionPolicy

__all__ = [
    "CompactionReport",
    "compact",
    "ReclusterResult",
    "recluster_stores",
    "RetentionManager",
    "RetentionPolicy",
]
