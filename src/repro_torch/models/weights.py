"""Carry a parameter tree of ``repro.models.init_params`` into the port's
``Transformer`` and back.

The tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` of the reference's tree). Its ``blocks`` are stacked on a
leading axis when ``cfg.scan_layers`` is set, and a list of per-block
trees otherwise. A bf16 array arrives with numpy's ``bfloat16`` extension
dtype, which ``torch.from_numpy`` refuses: it goes through ``float32``
(lossless) and is cast back to bf16. ``to_reference`` gives bf16
parameters back as ``float32`` arrays, for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Transformer


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _leaf(tree, path: list[str], name: str):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"the reference tree has no {name!r}")
        node = node[key]
    return node


def _paths(model: Transformer):
    """(parameter, path in the reference tree, block index or None)."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            yield p, name, ["blocks"] + parts[2:], int(parts[1])
        else:
            yield p, name, parts, None


@torch.no_grad()
def from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """A ``Transformer`` holding ``tree``'s values, each cast to the
    parameter's dtype (the reference's: fp32 norms, ``cfg.dtype`` the
    rest). Raises ``KeyError`` for a missing or extra parameter and
    ``ValueError`` for a shape that differs, a stacked leaf's leading axis
    or a ``blocks`` list's length included."""
    model = Transformer(cfg, device)
    n_blocks = len(model.blocks)
    blocks = tree.get("blocks")
    if not cfg.scan_layers and isinstance(blocks, list) and len(blocks) != n_blocks:
        raise ValueError(f"the reference tree has {len(blocks)} blocks, the model {n_blocks}")
    used = set()
    for p, name, path, i in _paths(model):
        if i is None:
            a = _leaf(tree, path, name)
        elif cfg.scan_layers:
            a = np.asarray(_leaf(tree, path, name))
            if a.shape[:1] != (n_blocks,):
                raise ValueError(f"{name}: the reference stacks {a.shape[:1]} blocks, the "
                                 f"model has {n_blocks}")
            a = a[i]
        else:
            a = _leaf(blocks[i], path[1:], name)
        used.add("/".join(path))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: the reference's shape {tuple(a.shape)} is not "
                             f"{tuple(p.shape)}")
        p.copy_(_tensor(a).to(dtype=p.dtype))
    given = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, list):  # unstacked blocks
            for v in node:
                walk(v, path)
        else:
            given.add("/".join(path))

    walk(tree, [])
    if given != used:
        raise KeyError(f"the reference tree has parameters the model lacks: "
                       f"{sorted(given - used)}")
    return model


def to_reference(model: Transformer) -> dict:
    """The reference's tree of ``model``'s values (bf16 as float32)."""
    cfg = model.cfg
    tree: dict = {}
    stacked: dict[str, list] = {}
    n_blocks = len(model.blocks)
    per_block: list[dict] = [{} for _ in range(n_blocks)]
    for p, _, path, i in _paths(model):
        if i is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _array(p)
        elif cfg.scan_layers:
            stacked.setdefault("/".join(path), [None] * n_blocks)[i] = _array(p)
        else:
            node = per_block[i]
            for key in path[1:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _array(p)
    if cfg.scan_layers:
        for key, arrays in stacked.items():
            path = key.split("/")
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.stack(arrays)
    else:
        tree["blocks"] = per_block
    return tree
