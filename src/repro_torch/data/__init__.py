"""Data plane: synthetic loghub-style corpora (the port's own copy of
``repro.data.loggen``) and the logzip-shard pipeline (``data.pipeline``)."""

from .loggen import (
    DATASETS,
    WorkloadSpec,
    generate_lines,
    generate_multitenant,
    generate_workload,
    generate_workload_multitenant,
    write_dataset,
)

__all__ = [
    "DATASETS",
    "WorkloadSpec",
    "generate_lines",
    "generate_multitenant",
    "generate_workload",
    "generate_workload_multitenant",
    "write_dataset",
]
