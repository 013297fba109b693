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

``on_blocks`` runs a function that treats every batch row and head alone
(attention, RWKV's recurrence) on each rank's own blocks, so that none of
its ops sees a ``DTensor``: DTensor 2.11 refuses to fold two split dims
into one, as the reshape inside a batched product over (batch, heads)
does. ``block_offset`` gives where a rank's block of a split dim starts
(the sequence-split decode cache's write and split-K attention).
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


def placed(t, mesh, placements):
    """``t`` as a ``DTensor`` on ``mesh`` at ``placements``: a ``DTensor``
    redistributed, a plain tensor (the same whole tensor on every rank)
    counted as replicated first."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, placements)


def _roles(mesh, sizes: dict) -> dict:
    """{role: spec entry} under ``shard_act``'s rule for a role of the
    global size ``sizes[role]`` on ``mesh`` (the installed mesh's settings,
    or the defaults: batch over pod and data, heads over model)."""
    names = tuple(mesh.mesh_dim_names)
    ax = dict(zip(names, tuple(mesh.shape)))
    installed = _STATE["mesh"] is not None
    dp = _STATE["dp"] if installed else tuple(a for a in ("pod", "data") if a in names)
    tp = _STATE["tp"] if installed else "model" in names
    out = {}
    if "batch" in sizes and dp and sizes["batch"] % int(np.prod([ax[a] for a in dp])) == 0:
        out["batch"] = axes_entry(dp)
    if "model" in sizes and tp and "model" in ax and sizes["model"] % ax["model"] == 0:
        out["model"] = "model"
    return out


def on_blocks(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn(*args)`` on each rank's own blocks. ``fn`` must treat every
    index of a dim given the role "batch" or "model" alone (a batch row, a
    head), as attention and RWKV's recurrence do. ``dims[i]`` names the
    roles of ``args[i]``'s dims as ``shard_act`` takes them (None for an
    argument that is not a tensor); ``out_dims`` those of each result
    (``fn`` returns a tuple of tensors), or of the one result.

    With no ``DTensor`` among ``args`` this is ``fn(*args)``. Otherwise each
    tensor argument is placed by its roles (a plain tensor counts as
    replicated), ``fn`` runs on the local blocks as plain tensors, and its
    results come back as ``DTensor`` s placed by ``out_dims``. Autograd
    passes through: an argument replicated on a mesh dim that splits the
    work (a weight beside a split batch) gets its gradient as a partial
    sum there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from .sharding import to_placements

    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    sizes = {}
    for a, d in zip(args, dims):
        if d is not None and a is not None:
            for n, role in zip(a.shape, d):
                if role is not None:
                    sizes.setdefault(role, n)
    roles = _roles(mesh, sizes)

    def placements(d):
        return to_placements(tuple(roles.get(r) for r in d), mesh)

    split = set()
    for d in dims:
        for i, p in enumerate(placements(d) if d is not None else ()):
            if not isinstance(p, Replicate):
                split.add(i)

    def local(a, d):
        if d is None or a is None:
            return a
        pl = placements(d)
        grad = [Partial() if i in split and isinstance(q, Replicate) else q
                for i, q in enumerate(pl)]
        return placed(a, mesh, pl).to_local(grad_placements=grad)

    out = fn(*(local(a, d) for a, d in zip(args, dims)))
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(t, mesh, placements(d), run_check=False)
                     for t, d in zip(out, out_dims))
    return DTensor.from_local(out, mesh, placements(out_dims), run_check=False)


def block_offset(t, dim: int) -> tuple[int, tuple[int, ...]]:
    """(the index along ``dim`` at which this rank's block of the
    ``DTensor`` ``t`` starts, the mesh dims that split ``dim``, major
    first). The split is even, as ``sharding.to_placements`` makes it; the
    offset comes from the rank's mesh coordinates, with no communication."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    split = tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim)
    off, size = 0, t.shape[dim]
    for i in split:
        size //= mesh.size(i)
        off += mesh.get_local_rank(i) * size
    return off, split


def shard_act(x, dims: tuple):
    """Constrain ``x``: dims entries are "batch" | "model" | None."""
    if _STATE["mesh"] is None:
        return x
    from torch.distributed.tensor import DTensor

    from .sharding import to_placements

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(act_spec(x.shape, dims), x.device_mesh))
