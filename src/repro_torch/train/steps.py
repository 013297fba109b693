"""Step functions (``repro.train.steps``).

``make_train_step`` is the step of one device: the loss and its
gradients by autograd, fp32 accumulation over ``microbatches`` (each
microbatch's graph freed before the next, so activation memory scales
1/m), global-norm clipping and AdamW, the parameters updated in place.
The reference's GSPMD placement (FSDP gathers, the data-parallel
all-reduce) has no counterpart on one card.

``make_train_step_explicit`` is the variant with hand-placed collectives
over ``torch.distributed`` process groups: gradients mean-reduced in fp32
over "data", then the int8 error-feedback all-reduce over "pod"
(``optim.compress``).

``train_state`` / ``load_train_state`` carry a model and its AdamW state
to the reference's checkpoint tree and back (``checkpoint.ckpt``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import loss_fn
from ..models.weights import stack, unstack
from ..optim.adamw import AdamWHyper, adamw_update, clip_by_global_norm


def _split_micro(batch: dict, m: int) -> list[dict]:
    def sp(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"a batch of {b} does not split into {m} microbatches")
        return x.reshape(m, b // m, *x.shape[1:])

    split = {k: sp(torch.as_tensor(v)) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(m)]


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
        grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
        lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
        opt_state = adamw_update(grads, opt_state, model, hyper, lr=lr)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


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
    bf16), the blocks stacked as the reference stacks them."""
    with torch.no_grad():
        return {"params": stack(model, {k: p.detach() for k, p in model.named_parameters()}),
                "opt": {"mu": stack(model, opt_state["mu"]),
                        "nu": stack(model, opt_state["nu"]), "step": opt_state["step"]}}


@torch.no_grad()
def load_train_state(model, tree: dict) -> dict:
    """Copy ``tree["params"]`` (``train_state``'s layout) into ``model``'s
    parameters in place -> the AdamW state of ``tree["opt"]`` on the
    model's device. Raises as ``weights.unstack`` does, and ``ValueError``
    for a leaf whose dtype is not the parameter's or fp32 for a moment."""
    dev = model.device
    params = dict(model.named_parameters())
    for k, t in unstack(model, tree["params"]).items():
        if t.dtype != params[k].dtype:
            raise ValueError(f"{k}: the checkpoint holds {t.dtype}, the model {params[k].dtype}")
        params[k].copy_(t)
    opt = {"step": torch.as_tensor(tree["opt"]["step"]).to(device=dev, dtype=torch.int32)}
    for name in ("mu", "nu"):
        moments = unstack(model, tree["opt"][name])
        for k, t in moments.items():
            if t.dtype != torch.float32:
                raise ValueError(f"opt/{name}/{k}: the checkpoint holds {t.dtype}, not float32")
        opt[name] = {k: t.to(dev) for k, t in moments.items()}
    return opt
