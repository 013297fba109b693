"""int8 error-feedback gradient compression for the cross-pod hop
(``repro.optim.compress``).

Quantizing the summand to int8 with a per-tensor scale cuts the traffic of
a slow all-reduce 4x against bf16. Error feedback (Seide et al., 1-bit
SGD; Karimireddy et al. 2019) keeps the quantization noise from
accumulating: the residual e is added back before the next quantization.

The reference reduces over a named mesh axis inside ``shard_map``; here
the axis is a ``torch.distributed`` process group, one process a member.
Per rank and per tensor:

    x32 = g / n + e                      (n: the group's size)
    scale = all_reduce_max(max |x32|) / 127    (one grid for every rank)
    q = clip(round(x32 / scale), -127, 127)    (int8; round half to even)
    out = all_reduce_sum(int32(q)) * scale     (the mean of the g, fp32)
    e' = x32 - q * scale                 (the residual, fed back next time)

Used by ``train.steps.make_train_step_explicit`` on its "pod" group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor, err: torch.Tensor):
    """-> (q int8, scale fp32, new_err). ``err`` is the running residual."""
    x32 = x.float() + err
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, x32 - deq


def allreduce_int8(grads: dict, err_state: dict, group=None):
    """Error-feedback int8 all-reduce of ``{name: gradient}`` over
    ``group`` (the default group when None) -> (the mean-reduced
    gradients in fp32, the new residuals). The int8 summands are added in
    int32 (no overflow below 2^24 ranks); the scale is the group's max."""
    n = dist.get_world_size(group)
    out, new_err = {}, {}
    for k, g in grads.items():
        x32 = g.float() / n + err_state[k]
        amax = torch.clamp(x32.abs().max(), min=1e-12)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax / 127.0
        q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        new_err[k] = x32 - q.float() * scale  # residual feedback
        out[k] = total.float() * scale
    return out, new_err


def init_error_state(grads_like: dict) -> dict:
    """Zero fp32 residuals shaped as ``grads_like``'s tensors, on their
    devices."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}
