"""Structural cost model of one traced step (``repro.launch.hlo_cost``).

Eager PyTorch has no HLO: the program is the stream of aten ops it
dispatches. ``CostModel``, a ``TorchDispatchMode``, records that stream
as it runs (on the card, the CPU or ``"meta"`` tensors, which need no
storage) and counts, per device, what the reference counts per device
over the HLO of a compiled step. Under ``DTensor`` it sees each rank's
local ops and the collectives DTensor issues (it passes the ``DTensor``
level through), so the counts are one rank's, as the reference's are one
device's. Python loops are unrolled in the stream, so no trip count is
needed, and the backward's ops arrive from the autograd engine like any
other.

- FLOPs: exact for products, 2 * prod(result) * prod(contracted dims)
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``,
  ``convolution`` and its backward); elementwise ops are not counted.
- HBM bytes: operands plus results at every op boundary, since in eager
  mode each boundary is a trip through device memory. View and alias
  ops cost 0 (as ``bitcast``); index, gather and embedding reads bill 2x
  their result; scatter, ``index_put_``, ``index_add_`` and ``copy_``
  into a slice bill 2x the bytes they move, not the buffer they land in.
- Convert bytes: the ``_to_copy`` casts between dtypes. On the card these
  are real traffic, so no adjusted memory term is derived from them.
- Collective bytes: ring-model per-device wire traffic of the
  ``_c10d_functional`` ops (DTensor's) and the ``c10d`` ops
  (``torch.distributed`` calls), with their group's size:
    all-reduce 2(g-1)/g * size, all-gather/all-to-all (g-1)/g * size,
    reduce-scatter (g-1) * size (its result; operand = size * g).
- All-gather inputs: the shape of every all-gather's input, with its
  count (what the dry run reads to tell a gather of a cache block).
- Live bytes: the storage that the traced ops allocated and that is still
  referenced, peak and at the end (what the dry run reports as temporary
  memory).
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "addbmm"}
# reads of a window or of rows: billed 2x the result
_GATHERS = {"index", "index_select", "gather", "embedding", "take", "_unsafe_index"}
# writes of rows into a buffer: billed 2x the bytes moved
_SCATTERS = {"index_put_", "index_put", "_index_put_impl_", "scatter_", "scatter",
             "scatter_add_", "scatter_add", "scatter_reduce_", "index_add_", "index_add",
             "index_copy_", "index_copy", "copy_", "masked_scatter_"}
# no data moves: metadata, aliases, allocation without a write
_FREE = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "set_", "resize_",
         "wait_tensor", "_wrap_tensor_autograd"}
# collective op name -> the reference's collective kind: the functional
# ops return their result; the c10d ops write their first tensor argument
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce", "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _name(func) -> str:
    """``aten.mm.default`` -> ``mm``."""
    return func._schema.name.split("::")[-1]


def _product_flops(name: str, args, out: torch.Tensor) -> float:
    n_res = out.numel()
    if name in ("mm", "bmm", "mv", "dot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm", "addmv", "addbmm"):
        k = args[1].shape[-1]
    else:
        return 0.0
    if name == "addbmm":  # sums over the batch of products too
        k *= args[1].shape[0]
    return 2.0 * n_res * k


def _conv_flops(name: str, args, outs) -> float:
    """2 * prod(output) * (in_channels / groups * prod(kernel)) a pass; the
    backward counts it once for each gradient it computes."""
    if name == "convolution":
        out, w = outs[0], args[1]
        return 2.0 * out.numel() * (w.shape[1] * w[0, 0].numel())
    # convolution_backward(grad_out, input, weight, ..., output_mask)
    grad_out, w, mask = args[0], args[2], args[-1]
    per = 2.0 * grad_out.numel() * (w.shape[1] * w[0, 0].numel())
    return per * (int(bool(mask[0])) + int(bool(mask[1])))


def _group_size(name: str, args, n_devices: int) -> int:
    """The size of a collective's group: from its group name (functional
    collectives) or its ``ProcessGroup`` argument (``c10d`` ops)."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import _resolve_process_group

                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    return n_devices


def _wire(kind: str, size: float, g: int) -> float:
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return size * (g - 1)  # operand = size * g
    return size * (g - 1) / max(g, 1)  # all-gather, all-to-all


class CostModel(TorchDispatchMode):
    """Counts one rank's costs of every aten op run under it::

        with CostModel(n_devices=8) as cm:
            step(model, opt, batch)
        costs = cm.result()

    ``n_devices`` is the group size of a collective whose group cannot be
    read. ``result()`` has the reference's ``analyze`` keys and
    ``peak_live_bytes`` / ``live_bytes``: the storage the traced ops
    allocated, at its peak and still held at the end."""

    def __init__(self, n_devices: int = 1):
        super().__init__()
        self.n_devices = n_devices
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.convert_bytes = 0.0
        self.collective_bytes = defaultdict(float)
        self.collective_count = defaultdict(int)
        self.gather_inputs = defaultdict(int)  # input shape -> all-gathers
        self.dot_count = 0
        self.op_count = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._storages: dict[int, list] = {}  # storage id -> [bytes, tensor refs]

    # ------------------------------------------------------------ liveness
    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._storages[key]
            self.live_bytes -= entry[0]

    def _track(self, func, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._storages:
                if func.is_view or func._schema.is_mutable:
                    continue  # the storage of an input: not the trace's
                self._storages[key] = [st.nbytes(), 0]
                self.live_bytes += st.nbytes()
            self._storages[key][1] += 1
            weakref.finalize(t, self._release, key)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    # ---------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented  # DTensor runs its local ops under this mode
        out = func(*args, **kwargs)
        # DTensor derives an op's global output shape by running it on fake
        # tensors: not the rank's work, so not counted
        if not any(t.__name__ == "FakeTensor" for t in types) and not any(
                type(t).__name__ == "FakeTensor" for t in _tensors(out)):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = _name(func)
        ns = func._schema.name.split("::")[0]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.op_count += 1
        self._track(func, outs)
        if name in _PRODUCTS and outs:
            self.flops += _product_flops(name, args, outs[0])
            self.dot_count += 1
        elif name in ("convolution", "convolution_backward"):
            self.flops += _conv_flops(name, args, outs)
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            g = _group_size(name, args, self.n_devices)
            size = _nbytes(outs[0]) if ns == "_c10d_functional" else _nbytes(ins[0])
            self.collective_bytes[kind] += _wire(kind, size, g)
            self.collective_count[kind] += 1
            if kind == "all-gather":  # c10d's first tensor is the output
                src = ins[0] if ns == "_c10d_functional" else ins[-1]
                self.gather_inputs[tuple(src.shape)] += 1
        if func.is_view or name in _FREE or name.startswith("sym_"):
            return
        res = sum(_nbytes(t) for t in outs)
        if name in _GATHERS:
            b = 2 * res
        elif name in _SCATTERS:
            # the rows moved: every tensor operand but the destination
            moved = sum(_nbytes(t) for t in ins[1:]) if len(ins) > 1 else res
            b = 2 * moved
        else:
            b = res + sum(_nbytes(t) for t in ins)
        self.hbm_bytes += b
        if name == "_to_copy" and ins and outs and ins[0].dtype != outs[0].dtype:
            self.convert_bytes += b

    def result(self) -> dict:
        coll = dict(self.collective_bytes)
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "convert_bytes": self.convert_bytes,
            "collective_bytes": coll,
            "collective_count": dict(self.collective_count),
            "collective_bytes_total": sum(coll.values()),
            "dot_count": self.dot_count,
            "op_count": self.op_count,
            "all_gather_inputs": [[list(k), n] for k, n in sorted(self.gather_inputs.items())],
            "peak_live_bytes": self.peak_live_bytes,
            "live_bytes": self.live_bytes,
        }


def analyze(fn, *args, n_devices: int = 1, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under ``CostModel`` -> its
    per-device costs (the reference's ``analyze`` keys, and more)."""
    with CostModel(n_devices) as cm:
        fn(*args, **kwargs)
    return cm.result()


# --------------------------------------------------------- roofline terms

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak, HBM3
# bandwidth, NVLink 4 (900 GB/s both directions: 450 GB/s each way)
H100 = {
    "peak_flops": 989e12,   # bf16 FLOP/s a card, dense
    "hbm_bw": 3.35e12,      # B/s
    "link_bw": 450e9,       # B/s a direction (NVLink)
}


def roofline_terms(costs: dict, chips_unused: int = 1) -> dict:
    """Per-device seconds for each roofline term (costs are per-device),
    on the H100's figures."""
    t_compute = costs["flops"] / H100["peak_flops"]
    t_memory = costs["hbm_bytes"] / H100["hbm_bw"]
    t_coll = costs["collective_bytes_total"] / H100["link_bw"]
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_time_lower_bound_s": max(t_compute, t_memory, t_coll),
    }
