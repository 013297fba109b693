"""Atomic, async checkpoints in the reference's on-disk format (the port
of ``repro.checkpoint``)."""

from .ckpt import CheckpointManager, latest_step, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint", "save_checkpoint"]
