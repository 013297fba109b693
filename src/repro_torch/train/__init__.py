"""Training and serving step functions (the port of ``repro.train``)."""

from .steps import make_decode_step, make_prefill_step, make_train_step, make_train_step_explicit

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step",
           "make_train_step_explicit"]
