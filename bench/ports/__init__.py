"""The benchmark's side of the program under test, one module per model
family under the name of the family's plain reference (the ``reference``
key of a configuration file). A family's module maps the benchmark onto
the port:

- ``model_config(c, name, remat=True)``: the port's ``ModelConfig`` for
  the published ``config.json`` keys ``c``, run as the configuration
  states;
- ``build_model(W, pcfg, device)``: the port's model holding copies of
  the benchmark's weights ``W`` (``weights.py``);
- ``program_name(name)``: the port's parameter name of the benchmark's
  leaf ``name``;
- ``leaf(model, name, t=None)``: the port's leaf (or ``t``, a tensor of
  its shape) read back at the benchmark's shape.
"""

from __future__ import annotations

import importlib


def of(config: dict):
    """The mapping onto the program of the family ``config`` names."""
    return importlib.import_module(f"{__name__}.{config['reference']}")
