"""Checkpoint/restart substrate (``repro.checkpoint.ckpt``), in the
reference's on-disk format, so that each package reads what the other
writes:

- **atomic**: a checkpoint is written to ``step-NNNNNNNN.tmp/`` and
  renamed to ``step-NNNNNNNN/`` after its manifest is fsync'd, so a crash
  mid-write never corrupts the latest valid checkpoint;
- **format**: ``arrays.npz`` holds each leaf's raw bytes as a ``uint8``
  array ``a<i>``, leaves in sorted path order; ``manifest.json`` holds
  ``step``, ``extra`` and each leaf's path (``/``-joined keys, a list's
  index as a key), ``key``, ``shape`` and numpy dtype name. bf16 leaves
  are written as their bf16 bytes with dtype ``"bfloat16"`` (numpy has no
  such dtype: the reader views ``uint16`` bytes as ``torch.bfloat16``,
  with no ``ml_dtypes``);
- **async**: ``CheckpointManager.save_async`` copies every leaf to the
  host before it returns (the port updates parameters in place, so a
  lazy snapshot would save a later step) and writes on a thread;
- **exact**: ``extra`` (the data pipeline's state) rides in the manifest;
- **GC**: keep the latest ``keep`` checkpoints;
- **sharded**: a ``DTensor`` leaf is written as its whole tensor (every
  rank gathers it, a collective, and rank 0 of the process group writes);
  ``load_checkpoint(shardings=)`` places each leaf onto any mesh's
  placements (elastic restart), as the reference's ``shardings=``
  re-shards onto any mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ops import check_device


@dataclass
class Sharding:
    """Where ``load_checkpoint`` puts a leaf: a ``DeviceMesh`` and the
    ``DTensor`` placements on it (the counterpart of a ``NamedSharding``;
    ``distributed.to_placements`` makes them from a spec)."""

    device_mesh: object
    placements: list


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _host(leaf) -> torch.Tensor:
    """A leaf (tensor, numpy array or number) as a contiguous CPU tensor of
    its own: a CPU tensor is copied too, so the caller may go on mutating
    the original. A ``DTensor`` is gathered whole first (a collective)."""
    if isinstance(leaf, torch.Tensor):
        if type(leaf).__name__ == "DTensor":
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(leaf))


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of the process
    group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _raw(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the leaf's bytes as uint8, its numpy dtype name)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().reshape(-1).view(np.uint8), "bfloat16"
    a = t.numpy()
    return a.reshape(-1).view(np.uint8), str(a.dtype)


def _leaf(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.uint16).reshape(shape).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))


def save_checkpoint(ckpt_dir: str, step: int, tree: dict, extra: dict | None = None) -> str:
    """Blocking atomic save. ``tree`` maps names -> nested dicts / lists of
    tensors (``DTensor``-s too: every rank of their mesh calls this),
    numpy arrays or numbers. Only rank 0 of a process group writes."""
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    flat = {path: leaf if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
            and type(leaf).__name__ != "DTensor" else _host(leaf)
            for path, leaf in _flatten(tree).items()}
    if not _writer():
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step-{step:08d}.tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    arrays = {}
    for i, (path, t) in enumerate(flat.items()):
        key = f"a{i}"
        arrays[key], dtype = _raw(t.detach().contiguous())
        manifest["leaves"][path] = {"key": key, "shape": list(t.shape), "dtype": dtype}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("-")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step-") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None, device="cuda", shardings=None):
    """Load (tree of tensors on ``device``, extra, step), the latest step
    unless ``step``; (None, None, None) where there is none. ``device`` is
    "cuda" by default, which raises where there is no card. ``shardings``,
    a tree of ``Sharding`` leaves over the checkpoint's paths (a subtree
    suffices), places each of its leaves as a ``DTensor`` on its mesh:
    every rank keeps its own block of the whole tensor, whatever mesh
    wrote it."""
    dev = check_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None, None
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for path, info in manifest["leaves"].items():
            flat[path] = _leaf(data[info["key"]], info["dtype"], info["shape"]).to(dev)
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor

        for path, sh in _flatten(shardings).items():
            flat[path] = distribute_tensor(flat[path], sh.device_mesh, sh.placements,
                                           src_data_rank=None)
    return _unflatten(flat), manifest["extra"], step


class CheckpointManager:
    """Async manager: snapshot-on-call, write-on-thread, GC old steps."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = latest_step(ckpt_dir)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: dict, extra: dict | None = None):
        self.wait()  # at most one outstanding write
        # every leaf copied to the host *now*, so training can mutate freely
        host_tree = _unflatten({p: _host(a) for p, a in _flatten(tree).items()})
        if not _writer():  # it took part in the gathers; rank 0 writes
            self.last_saved = step
            return

        def work():
            save_checkpoint(self.dir, step, host_tree, extra)
            self.last_saved = step
            self._gc()

        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.split("-")[1])
            for d in os.listdir(self.dir)
            if d.startswith("step-") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:08d}"), ignore_errors=True)

    def restore(self, device="cuda"):
        return load_checkpoint(self.dir, device=device)
