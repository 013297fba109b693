"""Step functions (``repro.train.steps``).

``make_train_step`` is the step: the loss and its gradients by
autograd, fp32 accumulation over ``microbatches`` (each microbatch's
graph freed before the next, so activation memory scales 1/m),
global-norm clipping and AdamW, the parameters updated in place. On one
card its tensors are plain. Sharded, the counterpart of the reference's
``jax.jit(step, in_shardings=...)``, it takes ``DTensor`` parameters
placed by ``distributed.param_pspecs`` (``shard_model``), AdamW moments
placed by the same specs in "2d" mode or ``zero1_opt_pspecs`` in "dp"
mode (``shard_opt_state``) and a batch placed by ``batch_pspecs``
(``shard_batch``): DTensor inserts the FSDP gathers, the tensor-parallel
reductions and the gradient reductions, the plain tensors the step makes
(rope tables, masks, the step counter) count as replicated, and the
metrics come back as plain tensors.

``make_train_step_explicit`` is the variant with hand-placed collectives
over ``torch.distributed`` process groups: gradients mean-reduced in fp32
over "data", then the int8 error-feedback all-reduce over "pod"
(``optim.compress``).

``train_state`` / ``load_train_state`` carry a model and its AdamW state
to the reference's checkpoint tree and back (``checkpoint.ckpt``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..models import loss_fn
from ..models.weights import stack, unstack
from ..optim.adamw import AdamWHyper, adamw_update, clip_by_global_norm


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _full(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s whole value as a plain tensor (a collective: every
    rank calls it), a plain tensor detached."""
    return t.full_tensor() if _is_dtensor(t) else t.detach()


def _split_micro(batch: dict, m: int) -> list[dict]:
    """The batch's rows in ``m`` consecutive microbatches; a sharded batch
    is gathered, cut and placed again by ``batch_pspecs`` on the
    microbatch's shape (the reference reshapes the global batch)."""
    def sp(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"a batch of {b} does not split into {m} microbatches")
        return x.reshape(m, b // m, *x.shape[1:])

    sharded = [k for k, v in batch.items() if _is_dtensor(v)]
    if not sharded:
        split = {k: sp(torch.as_tensor(v)) for k, v in batch.items()}
        return [{k: v[i] for k, v in split.items()} for i in range(m)]
    from ..distributed.sharding import batch_pspecs, place

    mesh = batch[sharded[0]].device_mesh
    split = {k: sp(_full(v)) for k, v in batch.items()}
    out = []
    for i in range(m):
        mb = {k: v[i] for k, v in split.items()}
        specs = batch_pspecs(mb, mesh)
        out.append({k: place(v, specs[k], mesh) if k in sharded else v
                    for k, v in mb.items()})
    return out


def _grads(model, batch: dict):
    """(loss, {name: gradient in the parameter's dtype}); a parameter the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    params = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def make_train_step(cfg, hyper: AdamWHyper | None = None, microbatches: int = 1, lr_fn=None):
    """-> ``step(model, opt_state, batch) -> (model, opt_state, {"loss",
    "grad_norm"})``; ``lr_fn(opt_state["step"])`` sets the learning rate
    when given. ``cfg`` is the model's (kept for the reference's
    signature)."""
    hyper = hyper or AdamWHyper()

    def train_step(model, opt_state, batch):
        sharded = _is_dtensor(model.embed)
        with _replicating(sharded):
            if microbatches == 1:
                loss, grads = _grads(model, batch)
            else:
                grads, loss = None, 0.0
                for mb in _split_micro(batch, microbatches):
                    lm, g = _grads(model, mb)
                    if grads is None:
                        grads = {k: v.float() for k, v in g.items()}
                    else:
                        for k, v in g.items():
                            grads[k] += v.float()
                    loss = loss + lm
                grads = {k: g / microbatches for k, g in grads.items()}
                loss = loss / microbatches
            if sharded:
                grads = _as_moments(grads, opt_state)
            grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
            lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
            opt_state = adamw_update(grads, opt_state, model, hyper, lr=lr)
        if sharded:
            loss, gnorm = _full(loss), _full(gnorm)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _as_moments(grads: dict, opt_state: dict) -> dict:
    """Sharded gradients placed as their moments: a data-parallel
    gradient, a pending sum on every rank, is reduce-scattered onto the
    ZeRO-1 shards once (not all-reduced for the norm and reduced again
    for the update), and clipping then sums squares over shards."""
    out = {}
    for k, g in grads.items():
        want = opt_state["mu"][k].placements
        out[k] = g if tuple(g.placements) == tuple(want) else g.redistribute(g.device_mesh, want)
    return out


def _replicating(sharded: bool):
    """DTensor's implicit replication for a sharded step (the plain
    tensors it makes join the DTensors as replicated), else nothing."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _pmean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group``, reduced in fp32, in ``t``'s dtype
    (an fp32 ``t``, a gradient or loss of this step, is summed in place)."""
    t32 = t.float()
    dist.all_reduce(t32, op=dist.ReduceOp.SUM, group=group)
    return (t32 / dist.get_world_size(group)).to(t.dtype)


def make_train_step_explicit(cfg, mesh: dict | None = None, hyper: AdamWHyper | None = None,
                             compress_pod: bool = True):
    """-> ``step(model, opt_state, err, batch) -> (model, opt_state, err,
    {"loss", "grad_norm"})`` with hand-placed collectives.

    ``mesh`` maps the reference's axis names to ``torch.distributed``
    process groups: "data" (gradients and loss mean-reduced in fp32,
    returned in the gradient's dtype) and "pod" (the int8 error-feedback
    all-reduce of ``optim.compress`` with ``compress_pod``, else a mean;
    ``err`` holds its residuals, ``init_error_state``). Each process
    brings its own shard of the batch and holds the whole model, as the
    reference's ``shard_map`` body does. With ``mesh`` None or empty (one
    card: a mesh of one device) there is nothing to reduce, and the step
    is ``make_train_step`` with one microbatch and no ``lr_fn``, ``err``
    passed through."""
    from ..optim.compress import allreduce_int8

    hyper = hyper or AdamWHyper()
    mesh = mesh or {}

    def step(model, opt_state, err, batch):
        loss, grads = _grads(model, batch)
        if "data" in mesh:
            grads = {k: _pmean(g, mesh["data"]) for k, g in grads.items()}
            loss = _pmean(loss, mesh["data"])
        if "pod" in mesh:
            if compress_pod:
                grads, err = allreduce_int8(grads, err, mesh["pod"])
            else:
                grads = {k: _pmean(g, mesh["pod"]) for k, g in grads.items()}
            loss = _pmean(loss, mesh["pod"])
        grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
        opt_state = adamw_update(grads, opt_state, model, hyper)
        return model, opt_state, err, {"loss": loss, "grad_norm": gnorm}

    return step


def make_prefill_step(cfg, max_len: int | None = None):
    """-> ``prefill_step(model, batch) -> (logits, cache)``, the cache sized
    to the prompt (with the VLM's patches) unless ``max_len``."""
    from ..models import prefill

    def prefill_step(model, batch):
        s = batch["tokens"].shape[1] + (cfg.n_patches or 0)
        return prefill(model, batch, max_len or s)

    return prefill_step


def make_decode_step(cfg):
    """-> ``serve_step(model, cache, tokens) -> (logits, cache)``."""
    from ..models import decode_step

    def serve_step(model, cache, tokens):
        return decode_step(model, cache, tokens)

    return serve_step


# ------------------------------------------------------- checkpoint trees

def train_state(model, opt_state: dict) -> dict:
    """The checkpoint tree of the reference's launcher: ``{"params": the
    reference's parameter tree, "opt": {"mu", "nu": trees of the same
    paths, "step"}}``, the parameters in their own dtypes (bf16 stays
    bf16), the blocks stacked as the reference stacks them. Sharded
    state is gathered to whole tensors first (a collective: every rank
    calls it)."""
    with torch.no_grad():
        return {"params": stack(model, {k: _full(p) for k, p in model.named_parameters()}),
                "opt": {"mu": stack(model, {k: _full(t) for k, t in opt_state["mu"].items()}),
                        "nu": stack(model, {k: _full(t) for k, t in opt_state["nu"].items()}),
                        "step": _full(opt_state["step"])}}


@torch.no_grad()
def load_train_state(model, tree: dict, moment_specs: dict | None = None) -> dict:
    """Copy ``tree["params"]`` (``train_state``'s layout) into ``model``'s
    parameters in place -> the AdamW state of ``tree["opt"]`` on the
    model's device. A sharded model (``DTensor`` parameters) takes each
    rank's block of the whole tensors; its moments are placed by
    ``moment_specs`` ({name: spec}: ``zero1_opt_pspecs`` in dp mode), by
    their parameter's placements where it is None. Raises as
    ``weights.unstack`` does, and ``ValueError`` for a leaf whose dtype is
    not the parameter's or fp32 for a moment."""
    from ..distributed.sharding import place

    dev = model.device
    params = dict(model.named_parameters())

    def local(k, t, spec=None):
        p = params[k]
        if not _is_dtensor(p):
            return t.to(dev)
        from torch.distributed.tensor import distribute_tensor

        if spec is not None:
            return place(t.to(dev), spec, p.device_mesh)
        return distribute_tensor(t.to(dev), p.device_mesh, p.placements, src_data_rank=None)

    for k, t in unstack(model, tree["params"]).items():
        if t.dtype != params[k].dtype:
            raise ValueError(f"{k}: the checkpoint holds {t.dtype}, the model {params[k].dtype}")
        if _is_dtensor(params[k]):
            params[k].to_local().copy_(local(k, t).to_local())
        else:
            params[k].copy_(t)
    opt = {"step": torch.as_tensor(tree["opt"]["step"]).to(device=dev, dtype=torch.int32)}
    for name in ("mu", "nu"):
        moments = unstack(model, tree["opt"][name])
        for k, t in moments.items():
            if t.dtype != torch.float32:
                raise ValueError(f"opt/{name}/{k}: the checkpoint holds {t.dtype}, not float32")
        opt[name] = {k: local(k, t, None if moment_specs is None else moment_specs[k])
                     for k, t in moments.items()}
    return opt
