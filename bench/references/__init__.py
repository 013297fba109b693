"""Plain references, one module per model family, found by the
``reference`` key of a configuration file.

A family's module is plain PyTorch and NumPy and imports nothing of the
program, nor JAX, nor the JAX package. It owns what the yardstick knows
of the family:

- ``leaves(c)``: (name, shape, init, scale) of every parameter, from which
  ``weights.py`` makes both sides' weights;
- ``logits_at(W, c, tokens, positions, quant=None)`` and
  ``train_steps(W, c, batches, opt, quant=None, rows=1, half_batch=False)``:
  the reference itself (``quant="fp8"`` is the control);
- ``block_rows(c, seq, grad)``: how many rows it computes at once;
- ``train_phases(c, batch, seq)`` and ``serve_phases(c, batch, prompt, new)``:
  the FLOP and byte counts of ``counts.py``;
- ``tiny(c)``: the configuration cut to a size the CPU tests run in seconds.

Its mapping onto the program lives beside it, in ``bench/ports/`` under
the same name, so that the reference never imports the program.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def of(config: dict):
    """The plain reference module that ``config`` names."""
    return importlib.import_module(f"{__name__}.{config['reference']}")


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for products and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
