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
- **GC**: keep the latest ``keep`` checkpoints.

The reference's elastic restore (``load_checkpoint(shardings=)``, a
re-shard onto any mesh) has no meaning on one card: ``load_checkpoint``
takes the ``device`` to put the leaves on instead.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..kernels.ops import check_device


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
    the original."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(leaf))


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
    tensors, numpy arrays or numbers."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step-{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    arrays = {}
    for i, (path, leaf) in enumerate(_flatten(tree).items()):
        t = leaf if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu" else _host(leaf)
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


def load_checkpoint(ckpt_dir: str, step: int | None = None, device="cuda"):
    """Load (tree of tensors on ``device``, extra, step), the latest step
    unless ``step``; (None, None, None) where there is none. ``device``
    ("cuda" by default, which raises where there is no card) stands in for
    the reference's ``shardings``: one card has nothing to re-shard."""
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
