"""Carry a parameter tree of ``repro.models.init_params`` into the port's
``Transformer`` and back.

The tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` of the reference's tree). Its ``blocks`` are stacked on a
leading axis when ``cfg.scan_layers`` is set, and a list of per-block
trees otherwise; Whisper's ``encoder`` and ``xattn`` are stacked
whatever ``cfg.scan_layers`` is (the reference ``vmap``s them). A bf16
array arrives with numpy's ``bfloat16`` extension dtype, which
``torch.from_numpy`` refuses: it goes through ``float32`` (lossless) and
is cast back to bf16. ``to_reference`` gives bf16
parameters back as ``float32`` arrays, for the same reason.

``stack`` and ``unstack`` map any ``{parameter name: tensor}`` (the
parameters, their gradients, AdamW's moments) to the reference's tree
and back, in the tensors' own dtypes: the checkpoint's leaves and the
reference-tree gradients of the tests.
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


# the module lists of the model, each a stacked subtree of the reference's
_STACKS = ("blocks", "encoder", "xattn")


def _stacked(cfg: ModelConfig, group: str) -> bool:
    return group != "blocks" or cfg.scan_layers


def _paths(model: Transformer):
    """(parameter, name, path in the reference tree, module list or None,
    index in it)."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in _STACKS:
            yield p, name, [parts[0]] + parts[2:], parts[0], int(parts[1])
        else:
            yield p, name, parts, None, None


def _set(tree: dict, path: list[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def reference_ndims(model: Transformer) -> dict[str, int]:
    """Parameter name -> the number of dimensions of its leaf in the
    reference tree: one more than the parameter's where the reference
    stacks the blocks (``scan_layers``), the encoder or the
    cross-attentions on a leading axis. AdamW decays a leaf by this
    number (``optim.adamw``), so a block's norm scale, (d,) here and
    (L, d) there, is decayed as the reference decays it."""
    cfg = model.cfg
    return {name: p.ndim + (group is not None and _stacked(cfg, group))
            for p, name, _, group, _ in _paths(model)}


def reference_paths(model: Transformer) -> dict[str, tuple[list[str], int]]:
    """Parameter name -> (its path in the reference tree, the length of
    the leading axis the reference stacks it on, 0 where it is not
    stacked): ``blocks.3.sub0.attn.wq`` -> (["blocks", "sub0", "attn",
    "wq"], n_blocks). The sharding rules read a leaf's name and parent
    from the path, and ZeRO-1 the stacked shape."""
    cfg = model.cfg
    return {name: (path, len(getattr(model, group))
                   if group is not None and _stacked(cfg, group) else 0)
            for _, name, path, group, _ in _paths(model)}


def stack(model: Transformer, tensors: dict) -> dict:
    """``{parameter name: tensor}`` (the parameters, their gradients or
    AdamW moments) -> the reference's tree of them: each stacked group's
    tensors ``torch.stack``-ed on a leading axis, unstacked blocks as a
    list of per-block trees."""
    cfg = model.cfg
    tree: dict = {}
    stacked: dict[str, list] = {}
    per_block: list[dict] = [{} for _ in model.blocks]
    for _, name, path, group, i in _paths(model):
        t = tensors[name]
        if group is None:
            _set(tree, path, t)
        elif _stacked(cfg, group):
            stacked.setdefault("/".join(path), [None] * len(getattr(model, group)))[i] = t
        else:
            _set(per_block[i], path[1:], t)
    for key, ts in stacked.items():
        _set(tree, key.split("/"), torch.stack(ts))
    if not cfg.scan_layers:
        tree["blocks"] = per_block
    return tree


def unstack(model: Transformer, tree: dict) -> dict:
    """The reference's tree (numpy arrays or tensors) -> ``{parameter
    name: its array}``, a stacked leaf sliced at the block's index.
    Raises ``KeyError`` for a missing or extra leaf and ``ValueError``
    for a shape that differs from the parameter's, a stacked leaf's
    leading axis or a ``blocks`` list's length included."""
    cfg = model.cfg
    blocks = tree.get("blocks")
    if not cfg.scan_layers and isinstance(blocks, list) and len(blocks) != len(model.blocks):
        raise ValueError(f"the reference tree has {len(blocks)} blocks, the model "
                         f"{len(model.blocks)}")
    out, used = {}, set()
    for p, name, path, group, i in _paths(model):
        if group is None:
            a = _leaf(tree, path, name)
        elif _stacked(cfg, group):
            a = _leaf(tree, path, name)
            n = len(getattr(model, group))
            if tuple(a.shape[:1]) != (n,):
                raise ValueError(f"{name}: the reference stacks {tuple(a.shape[:1])} {group}, "
                                 f"the model has {n}")
            a = a[i]
        else:
            a = _leaf(blocks[i], path[1:], name)
        used.add("/".join(path))
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: the reference's shape {tuple(a.shape)} is not "
                             f"{tuple(p.shape)}")
        out[name] = a
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
    return out


@torch.no_grad()
def from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """A ``Transformer`` holding ``tree``'s values, each cast to the
    parameter's dtype (the reference's: fp32 norms, ``cfg.dtype`` the
    rest). Raises as ``unstack`` does."""
    model = Transformer(cfg, device)
    params = dict(model.named_parameters())
    for name, a in unstack(model, tree).items():
        params[name].copy_(_tensor(a).to(dtype=params[name].dtype))
    return model


def to_reference(model: Transformer) -> dict:
    """The reference's tree of ``model``'s values (bf16 as float32)."""
    with torch.no_grad():
        return _map(_array, stack(model, dict(model.named_parameters())))
