"""Activation sharding constraints (``repro.distributed.act_shard``).

Model code stays mesh-agnostic: it calls ``shard_act(x, dims)``, a no-op
unless the launcher installed a mesh via ``install_mesh`` / ``use_mesh``.
``dims`` names the logical role of each axis: "batch" -> (pod, data),
"model" -> model, None -> unsharded; any dim that doesn't divide falls
back to None (long_500k has batch 1).

Where the reference pins an XLA sharding (``with_sharding_constraint``),
the port moves the data: a ``DTensor`` activation is ``redistribute``-d
to the placements of that spec (an all-gather, all-to-all or
reduce-scatter where its placements differ). A plain tensor, the one-card
path, passes through unchanged.
"""

from __future__ import annotations

import contextlib

import numpy as np

from .sharding import axes_entry

_STATE: dict = {"mesh": None, "dp": (), "tp": True}


def install_mesh(mesh, dp_axes: tuple | None = None, tp: bool = True) -> None:
    """``dp_axes``/``tp`` support the pure-DP layout for small models
    (batch over every axis, no tensor parallelism)."""
    _STATE["mesh"] = mesh
    if mesh is None:
        _STATE["dp"] = ()
    elif dp_axes is not None:
        _STATE["dp"] = dp_axes
    else:
        _STATE["dp"] = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    _STATE["tp"] = tp


@contextlib.contextmanager
def use_mesh(mesh):
    prev = dict(_STATE)
    install_mesh(mesh)
    try:
        yield
    finally:
        _STATE.update(prev)


def act_spec(shape, dims: tuple):
    """The spec ``shard_act`` pins a ``shape`` to under the installed mesh
    (None when none is installed): the reference's rule."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    spec = []
    for size, d in zip(shape, dims):
        if d == "batch":
            dp = _STATE["dp"]
            n = int(np.prod([sizes[a] for a in dp])) if dp else 1
            spec.append(axes_entry(dp) if (dp and size % n == 0) else None)
        elif d == "model":
            ok = _STATE["tp"] and size % sizes["model"] == 0
            spec.append("model" if ok else None)
        else:
            spec.append(None)
    return tuple(spec)


def shard_act(x, dims: tuple):
    """Constrain ``x``: dims entries are "batch" | "model" | None."""
    if _STATE["mesh"] is None:
        return x
    from torch.distributed.tensor import DTensor

    from .sharding import to_placements

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(act_spec(x.shape, dims), x.device_mesh))
