"""Sharding rules: logical param/batch/cache axes -> partition specs and
DTensor placements (``repro.distributed.sharding``).

- TP over "model": attention q/o heads, FFN hidden dim, MoE experts
  (when E % tp == 0, otherwise expert-internal TP), vocab for the
  (un)embedding, RWKV heads, Mamba d_inner.
- FSDP over "data": the other big param dim.
- DP over ("pod", "data"): the batch. Params are NOT sharded over "pod".
- SP for decode: KV caches shard their *sequence* dim over "model", and
  batch over data when divisible.

A spec is a plain tuple with the entries of a ``PartitionSpec``, one a
tensor dim: ``None``, a mesh axis name, or a tuple of names (one tensor
dim over several mesh axes, major first). A mesh is a ``DeviceMesh`` or
an ``AbstractMesh`` (axis names and sizes, no process group), so the
rules run with no devices. Specs are keyed by the port's parameter names
(``blocks.<i>.sub<j>.attn.wq``); a per-block leaf has no leading stack
dim, so its spec is the reference's without the leading ``None``.
``to_placements`` turns a spec into the placements of a ``DTensor`` on a
``DeviceMesh``; ``place``, ``shard_model``, ``shard_batch`` and
``shard_cache`` put tensors there.

Every leaf must match a rule: an unmatched one raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices or process group:
    ``AbstractMesh((16, 16), ("data", "model"))``. It has the attributes
    of a ``DeviceMesh`` that the rules read (``shape``,
    ``mesh_dim_names``, ``ndim``)."""

    def __init__(self, sizes, names):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
        self.shape = tuple(int(s) for s in sizes)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _shape(x) -> tuple:
    """A tensor's shape, or a shape given as one."""
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _pad(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def axes_entry(axes: tuple):
    """A spec entry for a dim over ``axes``: the name itself for one axis
    (as ``PartitionSpec`` normalises a 1-tuple), the tuple for several."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _entry_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([_axis_size(mesh, a) for a in axes]))


@dataclass
class ShardingRules:
    """Resolved per-(config, mesh) decisions."""

    tp: int
    fsdp: int
    dp_axes: tuple
    shard_q_heads: bool
    shard_kv_heads: bool
    shard_experts: bool

    @classmethod
    def make(cls, cfg, mesh):
        tp = _axis_size(mesh, "model")
        fsdp = _axis_size(mesh, "data")
        return cls(
            tp=tp,
            fsdp=fsdp,
            dp_axes=tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names),
            shard_q_heads=_div(cfg.n_heads, tp),
            shard_kv_heads=_div(cfg.n_kv_heads, tp),
            shard_experts=cfg.n_experts > 0 and _div(cfg.n_experts, tp),
        )


def _rule(keys: list, shape, cfg, r: ShardingRules):
    """Spec for one param leaf (``shape`` excludes the scan-stack dim;
    ``keys`` is the reference tree's path, keys[-1] the leaf name), or
    None where no rule matches."""
    d = "data"
    m = "model"
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""

    if leaf in ("embed",):
        return (m, d)
    if leaf == "unembed":
        return (d, m)
    if leaf.startswith("ln") or leaf in ("enc_ln_f",):
        return (None,)
    # attention
    if leaf == "wq":
        return (d, m) if r.shard_q_heads else (d, None)
    if leaf in ("wk", "wv"):
        return (d, m) if r.shard_kv_heads else (d, None)
    if leaf == "wo":
        return (m, d) if r.shard_q_heads else (None, d)
    if leaf == "bq":
        return (m,) if r.shard_q_heads else (None,)
    if leaf in ("bk", "bv"):
        return (m,) if r.shard_kv_heads else (None,)
    if leaf in ("q_norm", "k_norm"):
        return (None,)
    # FFN (dense or per-expert, disambiguated by parent)
    if leaf in ("w1", "w3"):
        if parent == "moe":  # (E, d, f)
            return (m, d, None) if r.shard_experts else (None, d, m)
        return (d, m)
    if leaf == "w2":
        if parent == "moe":  # (E, f, d)
            return (m, None, d) if r.shard_experts else (None, m, d)
        return (m, d)
    if leaf == "b1":
        return (m,)
    if leaf == "b2":
        return (None,)
    if leaf == "wg":
        return (d, None)
    # mamba
    if leaf == "in_proj":
        return (d, m)
    if leaf == "conv_w":
        return (None, m)
    if leaf in ("conv_b", "dt_bias", "D"):
        return (m,)
    if leaf == "x_proj":
        return (m, None)
    if leaf == "dt_proj":
        return (None, m)
    if leaf == "A_log":
        return (m, None)
    if leaf == "out_proj":
        return (m, d)
    # rwkv6
    if leaf in ("w_r", "w_k", "w_v", "w_g"):
        return (d, m)
    if leaf == "w_o":
        return (m, d)
    if leaf.startswith("mu"):
        return (None,)
    if leaf == "w_decay0":
        return (None,)
    if leaf == "w_decay1":
        return (d, None)
    if leaf == "w_decay2":
        return (None, m)
    if leaf in ("u_bonus", "ln_scale"):
        return (m, None)
    if leaf in ("wk_cmix",):
        return (d, m)
    return None


def param_pspecs(model, cfg, mesh, mode: str = "2d") -> dict[str, tuple]:
    """{parameter name: spec} of ``model`` (a ``Transformer``, on any
    device, ``"meta"`` included).

    mode "2d": TP over model + FSDP over data (default).
    mode "dp": pure data parallelism, params REPLICATED (small models;
    the batch shards over every mesh axis instead).
    Raises ``ValueError`` for a leaf no rule covers or a sharded dim that
    does not divide its axes."""
    from ..models.weights import reference_paths

    params = dict(model.named_parameters())
    if mode == "dp":
        return {k: (None,) * p.ndim for k, p in params.items()}
    r = ShardingRules.make(cfg, mesh)
    paths = reference_paths(model)
    out = {}
    for name, p in params.items():
        keys, _ = paths[name]
        shape = tuple(p.shape)
        # rwkv channel-mix shares w-names with FFN; disambiguate by parent
        if len(keys) >= 2 and keys[-2] == "cmix":
            spec = {"wk": ("data", "model"), "wv": ("model", "data")}.get(keys[-1], (None,))
        else:
            spec = _rule(keys, shape, cfg, r)
        if spec is None:
            raise ValueError(f"no sharding rule for param {name} {shape}")
        spec = _pad(spec, len(shape))
        for dim, ax in zip(shape, spec):
            if ax is not None and dim % _entry_size(mesh, ax):
                raise ValueError(f"{name}: dim {dim} not divisible by {ax}="
                                 f"{_entry_size(mesh, ax)}")
        out[name] = spec
    return out


def zero1_opt_pspecs(model, mesh) -> dict[str, tuple]:
    """ZeRO-1 moment sharding for dp mode: shard the first dim divisible
    by the FULL device count over all mesh axes (optimizer memory 1/N,
    params stay replicated).

    The reference searches the *stacked* shape, whose leading dim is the
    layer count; the port's per-block moments have no such dim. Where the
    reference would shard the layer dim (the layer count divides N), the
    port shards the first per-block dim that divides N instead, or none
    (ROADMAP C.6); elsewhere its spec is the reference's without the
    stack dim."""
    from ..models.weights import reference_paths

    axes = tuple(mesh.mesh_dim_names)
    n = int(np.prod(tuple(mesh.shape)))
    paths = reference_paths(model)

    def first(shape) -> int | None:
        return next((i for i, d in enumerate(shape) if d > 0 and d % n == 0), None)

    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        stack = paths[name][1]
        i = first(((stack,) if stack else ()) + shape)
        if i is not None and stack:
            i = i - 1 if i > 0 else first(shape)
        spec = [None] * len(shape)
        if i is not None:
            spec[i] = axes_entry(axes)
        out[name] = tuple(spec)
    return out


def batch_pspecs(batch: dict, mesh, divisible: bool = True, dp_axes: tuple | None = None):
    """Batch dict -> {key: spec}: leading batch dim over (pod, data) when
    it divides, else replicated (long_500k has batch 1). ``batch`` holds
    tensors or shapes."""
    names = mesh.mesh_dim_names
    dp = dp_axes if dp_axes is not None else tuple(a for a in ("pod", "data") if a in names)
    dp_size = int(np.prod([_axis_size(mesh, a) for a in dp])) if dp else 1

    def visit(shape):
        if dp and shape[0] % dp_size == 0:
            return (axes_entry(dp),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return {k: visit(_shape(v)) for k, v in batch.items()}


def cache_pspecs(cache, cfg, mesh):
    """Decode cache specs (the tree of ``models.init_cache``: ``pos``, a
    list of per-block ``{"sub<j>": state}``, whisper's ``xattn`` list):
    batch over (pod, data) if divisible; KV cache sequence dim over
    "model" (split-K decode); SSM feature dims over "model". The port's
    per-block states have no stack dim, so the batch is dim 0."""
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_size = int(np.prod([_axis_size(mesh, a) for a in dp])) if dp else 1
    tp = _axis_size(mesh, "model")

    def leaf(name, shape):
        bspec = axes_entry(dp) if (dp and shape[0] % dp_size == 0) else None
        spec = [None] * len(shape)
        if name == "pos":
            return (bspec,)
        if name in ("k", "v", "conv", "h", "s", "xt", "xc"):
            spec[0] = bspec
        if name in ("k", "v", "s"):
            # (B, M, KV, hd): shard sequence M over model; (B, H, hd, hd): heads
            spec[1] = "model" if shape[1] % tp == 0 else None
        elif name == "conv":
            spec[-1] = "model" if shape[-1] % tp == 0 else None
        elif name == "h":
            spec[-2] = "model" if shape[-2] % tp == 0 else None
        return tuple(spec)

    def visit(node, name):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, name) for v in node]
        return leaf(name, _shape(node))

    return visit(cache, "")


def to_placements(spec: tuple, device_mesh) -> list:
    """A spec -> the ``DTensor`` placements on ``device_mesh``, one a mesh
    dim: ``Shard(i)`` on each mesh axis that tensor dim i is split over,
    ``Replicate()`` on the rest and on every axis of size 1 (a split into
    one part is the whole; DTensor then has no sharded dim to refuse a
    reshape over). A dim over several axes (``("pod", "data")``) is split
    major axis first, which is ``DTensor``'s order when the axes come in
    the mesh's order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    sizes = tuple(device_mesh.shape)
    out = [Replicate()] * len(names)
    taken = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            if i in taken:
                raise ValueError(f"mesh axis {names[i]!r} shards two dims in {spec}")
            taken.add(i)
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return out


def place(tensor, spec: tuple, device_mesh):
    """``tensor`` (the same full tensor on every rank, or a meta tensor)
    as a ``DTensor`` placed by ``spec``: each rank keeps its own block, no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor, device_mesh, to_placements(spec, device_mesh),
                             src_data_rank=None)


def shard_model(model, device_mesh, specs: dict):
    """Replace every parameter of ``model`` in place by a ``DTensor``
    parameter placed by ``specs`` ({name: spec}, ``param_pspecs``) ->
    ``model``. Every rank must hold the same values (the same seed)."""
    import torch

    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            for k, p in list(mod._parameters.items()):
                if p is None:
                    continue
                name = f"{mod_name}.{k}" if mod_name else k
                mod._parameters[k] = torch.nn.Parameter(
                    place(p.detach(), specs[name], device_mesh), requires_grad=p.requires_grad)
    return model


def shard_opt_state(opt_state: dict, device_mesh, specs: dict) -> dict:
    """AdamW's state (``optim.adamw_init``) with its moments placed by
    ``specs`` (the parameters' in "2d" mode, ``zero1_opt_pspecs`` in
    "dp" mode); the step counter stays a plain (replicated) scalar."""
    return {"mu": {k: place(t, specs[k], device_mesh) for k, t in opt_state["mu"].items()},
            "nu": {k: place(t, specs[k], device_mesh) for k, t in opt_state["nu"].items()},
            "step": opt_state["step"]}


def shard_batch(batch: dict, device_mesh, specs: dict) -> dict:
    """A batch (the same on every rank) placed by ``specs``
    (``batch_pspecs``)."""
    import torch

    return {k: place(torch.as_tensor(v), specs[k], device_mesh) for k, v in batch.items()}


def shard_cache(cache, device_mesh, specs):
    """A decode cache (the tree of ``models.init_cache`` or of a prefill)
    placed by ``specs`` (``cache_pspecs``): a plain leaf (the same whole
    tensor on every rank, or a meta tensor) split with no traffic, a
    ``DTensor`` leaf (a placed model's prefill) redistributed."""
    def visit(node, spec):
        if isinstance(node, dict):
            return {k: visit(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, sp) for v, sp in zip(node, spec)]
        if type(node).__name__ == "DTensor":
            return node.redistribute(device_mesh, to_placements(spec, device_mesh))
        return place(node, spec, device_mesh)

    return visit(cache, specs)
