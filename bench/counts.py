"""The work a cell needs, counted from the configuration and the traffic's
shapes by the family's plain reference (``train_phases``,
``serve_phases``): FLOPs of the products the model requires (no
recompute, no masked-out attention, no padded vocabulary) and the bytes
each phase has to move at the least (each input read once, each output
written once).

``least_seconds`` is the time the card could take at its peaks: the sum
over phases of the larger of FLOPs over the bf16 peak and bytes over the
memory bandwidth. Every kernel of a phase takes at least its own share
of it, so the work over the device's busy time cannot pass 1.
"""

from __future__ import annotations

from . import references


def train_step(c: dict, batch: int, seq: int) -> list[dict]:
    """Phases of one training step on (``batch``, ``seq``) tokens."""
    return references.of(c).train_phases(c, batch, seq)


def serve_batch(c: dict, batch: int, prompt: int, new: int) -> list[dict]:
    """Phases of one served batch: its prefill and ``new - 1`` decode steps."""
    return references.of(c).serve_phases(c, batch, prompt, new)


def flops(phases: list[dict]) -> int:
    return sum(p["flops"] for p in phases)


def least_seconds(phases: list[dict], peak: dict) -> float:
    return sum(max(p["flops"] / peak["bf16_flop_s"], p["bytes"] / peak["hbm_bytes_s"])
               for p in phases)
