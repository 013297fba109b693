"""Fault-tolerant multi-tenant ingestion service (DESIGN.md §15).

``python -m repro_torch.launch.compress serve`` multiplexes concurrent tenant
streams into per-tenant LZJS sessions, with write-ahead durability
(``core.wal``): a line is acked only after it is fsync-durable, and a
crash at any point recovers every acked line exactly once.
"""

from .protocol import IngestClient, ProtocolError
from .service import IngestDaemon, TenantStore
from .supervisor import CircuitBreaker, TenantSupervisor

__all__ = [
    "CircuitBreaker",
    "IngestClient",
    "IngestDaemon",
    "ProtocolError",
    "TenantStore",
    "TenantSupervisor",
]
