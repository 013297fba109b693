"""AdamW with fp32 moments (``repro.optim.adamw``).

Plain functions over tensors keyed by parameter name, the reference
tree's path (``models.weights``): the moments are ``{name: fp32
tensor}`` and the step an int32 scalar, on the model's device. The
update math is the reference's, in fp32, with one cast to the
parameter's dtype; parameters are updated in place, so each
``nn.Parameter`` keeps its identity (``torch.optim.AdamW`` is not used:
it keeps bf16 moments for bf16 parameters and orders the arithmetic
differently).

Weight decay goes to the leaves with two or more dimensions *in the
reference tree*, where the blocks are stacked on a leading axis
(``scan_layers``): a block's norm scale is (d,) here and (L, d) there,
and is decayed, as the reference decays it (``weights.reference_ndims``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.weights import reference_ndims


@dataclass(frozen=True)
class AdamWHyper:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(model) -> dict:
    """Zero fp32 moments for every parameter of ``model`` and step 0."""
    params = dict(model.named_parameters())
    dev = model.device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for k, p in params.items()}

    return {"mu": zeros(), "nu": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled by min(1, max_norm / norm), each rounded back to its
    dtype, the global norm in fp32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, model, hyper: AdamWHyper, lr=None) -> dict:
    """One AdamW step on ``model``'s parameters, in place -> the new
    optimizer state. ``lr`` (a float or an fp32 scalar tensor) overrides
    ``hyper.lr``."""
    lr = hyper.lr if lr is None else lr
    step = opt_state["step"] + 1
    b1, b2 = hyper.b1, hyper.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    ndims = reference_ndims(model)
    mus, nus = {}, {}
    for k, p in model.named_parameters():
        g32 = grads[k].float()
        mu = b1 * opt_state["mu"][k] + (1 - b1) * g32
        nu = b2 * opt_state["nu"][k] + (1 - b2) * torch.square(g32)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + hyper.eps)
        if ndims[k] >= 2:  # decay matrices only (no decay on norms / biases)
            delta = delta + hyper.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        mus[k], nus[k] = mu, nu
    return {"mu": mus, "nu": nus, "step": step}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> the learning rate (an fp32 tensor on the step's device):
    linear warmup over ``warmup`` steps, then a cosine to 0 at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
