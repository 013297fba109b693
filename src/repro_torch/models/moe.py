"""Mixture-of-Experts FFN with the reference's two dispatches
(``repro.models.moe``).

- ``einsum`` (default): GShard/Switch-style one-hot dispatch/combine in
  GShard's 2D (groups x group_size) layout: capacity is LOCAL to a group
  of ``group`` tokens.
- ``sort``: tokens argsorted (stably) by expert, packed to (E, C)
  buffers by rank, FFN'd and gathered back; one global capacity.

Both drop the slots past capacity (a slot's rank counts token-major,
then k) and renormalize the top-k gates, as the reference does; a
decode step of a few tokens has a capacity of 1 on most configs, so it
drops slots there too. Every expert runs on its (E, C) buffer whatever
the routing. The products are ``torch.matmul``. The reference's
``shard_act`` calls around the einsum dispatch's expert FFN stand at its
sites (no-ops unless a mesh is installed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.act_shard import act_spec, shard_act


def _router(x: torch.Tensor, wg: torch.Tensor, top_k: int):
    """-> gates (N, k) fp32 renormalized, experts (N, k) int64, aux loss.

    ``jax.lax.top_k`` puts the lower index first on a tie and
    ``torch.topk`` promises no order; the router is fp32 softmax over a
    product of continuous weights, so two equal probabilities in one row
    do not arise on these inputs."""
    probs = torch.softmax(x.float() @ wg.float(), dim=-1)          # (N, E)
    gates, experts = torch.topk(probs, top_k, dim=-1)               # (N, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = wg.shape[1]
    density = F.one_hot(experts[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(density * probs.mean(dim=0))
    return gates, experts, aux


def _expert_ffn(xin: torch.Tensor, params, act: str) -> torch.Tensor:
    """xin: (E, C, d) -> (E, C, d) through per-expert FFN weights."""
    if act == "swiglu":
        h = F.silu(xin @ params["w1"]) * (xin @ params["w3"])
    else:
        h = F.gelu(xin @ params["w1"], approximate="tanh")  # jax.nn.gelu's default
    return h @ params["w2"]


def moe_ffn(x: torch.Tensor, params, *, top_k: int, capacity_factor: float, act: str,
            impl: str = "einsum", group: int = 512):
    """x: (B, S, d) -> (B, S, d), aux_loss scalar (fp32). params: wg (d, E)
    fp32, w1/w3 (E, d, f), w2 (E, f, d)."""
    b, s, d = x.shape
    e = params["wg"].shape[1]
    n = b * s
    xf = x.reshape(n, d)
    gates, experts, aux = _router(xf, params["wg"], top_k)

    if impl == "einsum":
        g = min(group, n)
        while n % g:  # group size must divide (prod shapes are 2^k)
            g -= 1
        ng = n // g
        cap = max(1, int(g * top_k * capacity_factor / e))
        xg = xf.reshape(ng, g, d)
        experts_g = experts.reshape(ng, g, top_k)
        gates_g = gates.reshape(ng, g, top_k).to(x.dtype)
        # rank of each (token, k) slot within its (group, expert) queue
        onehot = F.one_hot(experts_g, e)                              # (G, g, k, E)
        flat = onehot.reshape(ng, g * top_k, e)
        rank = (torch.cumsum(flat, dim=1) - flat).reshape(ng, g, top_k, e)
        rank = (rank * onehot).sum(-1)                                # (G, g, k)
        keep = (rank < cap).to(x.dtype)
        # jax.nn.one_hot gives a zero row at rank >= cap, F.one_hot raises:
        # clamp, and the keep mask zeroes those rows
        slot = F.one_hot(torch.clamp(rank, max=cap - 1), cap).to(x.dtype) * keep[..., None]
        disp = torch.zeros((ng, g, e, cap), dtype=x.dtype, device=x.device)
        comb = torch.zeros_like(disp)
        for kk in range(top_k):  # avoid the 5D (g, k, E, C) outer product
            m = (F.one_hot(experts_g[:, :, kk], e).to(x.dtype)[..., None]
                 * slot[:, :, kk, None, :])
            disp = disp + m
            comb = comb + m * gates_g[:, :, kk, None, None]
        # the two contractions as products over one folded (E, C) dim, E
        # first: torch.einsum folds (C, E), which DTensor 2.11 refuses where
        # the experts are split over "model"
        xin = (disp.reshape(ng, g, e * cap).transpose(1, 2) @ xg).reshape(ng, e, cap, d)
        # expert dim over "model", capacity slots over "batch" (data)
        xin = shard_act(xin.transpose(0, 1).reshape(e, ng * cap, d), ("model", "batch", None))
        hout = shard_act(_expert_ffn(xin, params, act), ("model", "batch", None))
        # the slots stay split only by whole groups (the combine's rows)
        groups = act_spec((ng,), ("batch",))
        hout = shard_act(hout, ("model", "batch" if groups and groups[0] else None, None))
        hout = hout.reshape(e, ng, cap, d).transpose(0, 1)            # (G, E, C, d)
        out = (comb.reshape(ng, g, e * cap) @ hout.reshape(ng, e * cap, d)).reshape(n, d)
    else:  # sort-based gather/scatter dispatch
        cap = max(1, int(n * top_k * capacity_factor / e))
        flat_e = experts.reshape(-1)                                  # (N*k,)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))  # (E,)
        rank_sorted = torch.arange(n * top_k, device=x.device) - starts[sorted_e]
        tok_sorted = order // top_k
        # a dropped slot writes the last row, which is thrown away
        slot = torch.where(rank_sorted < cap, sorted_e * cap + rank_sorted, e * cap)
        buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[slot] = xf[tok_sorted]
        hout = _expert_ffn(buf[:-1].reshape(e, cap, d), params, act).reshape(e * cap, d)
        hout = torch.cat([hout, torch.zeros((1, d), dtype=x.dtype, device=x.device)])
        y_sorted = hout[slot]                                         # (N*k, d)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n * top_k, device=x.device)
        y = y_sorted[inv].reshape(n, top_k, d)
        out = (y * gates[..., None].to(x.dtype)).sum(dim=1)

    return out.reshape(b, s, d), aux
