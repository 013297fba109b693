"""Optimizer stack: AdamW, cosine schedule, global-norm clipping, int8
error-feedback gradient compression for the cross-pod hop (the port of
``repro.optim``)."""

from .adamw import AdamWHyper, adamw_init, adamw_update, clip_by_global_norm, cosine_schedule

__all__ = ["AdamWHyper", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule"]
