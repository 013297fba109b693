"""Production mesh construction (``repro.launch.mesh``), as
``torch.distributed`` ``DeviceMesh``-es over the default process group.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the
leading "pod" axis carries the batch, params replicate across it.

Functions, not module-level constants: importing this module touches no
process group. The caller initialises one first: NCCL over the cards
(``init_process_group("nccl", init_method="tcp://localhost:<port>",
rank=, world_size=)``), gloo over CPU processes, or the fake backend of
the dry run (``launch.dryrun``), which needs no devices at all. A mesh's
device type is ``device``: "cuda" (the default) raises where there is no
card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.ops import check_device


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    dev = check_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if _world() < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {_world()} — initialise a "
            f"process group of {n} ranks first (dryrun.py sets up a fake one).")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, axes=("data", "model"), device="cuda"):
    """(world // model_parallel, model_parallel) over every rank of the
    initialised process group (tests / examples / the launcher)."""
    dev = check_device(device)
    n = _world()
    if n == 0:
        raise RuntimeError("make_local_mesh needs an initialised torch.distributed process "
                           "group")
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel groups of "
                         f"{model_parallel}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(n).reshape(n // model_parallel, model_parallel),
                      mesh_dim_names=tuple(axes))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch (pod+data when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
