"""Mamba (S6) selective-state-space layer (``repro.models.mamba``).

A chunked scan as in the reference: a loop over chunks of
``cfg.ssm_chunk`` steps carries the (B, d_inner, d_state) fp32 state,
and inside a chunk a parallel prefix scan (log2(chunk) doubling steps)
composes the per-step affine maps h = a*h + b. The reference builds the
(B, L, d_inner, d_state) decay and input tensors for the whole sequence;
here they are built a chunk at a time, so the largest fp32 transient is
(B, chunk, d_inner, d_state) whatever the prompt's length.

Decode is the O(1) recurrence on (conv_state, ssm_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.act_shard import on_blocks, shard_act


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. u: (B, L, di), w: (dc, di).
    Each channel alone: on ``DTensor`` s it runs on each rank's (batch,
    channel) blocks (DTensor 2.11 cannot plan the pad of a split tensor)."""
    return on_blocks(_causal_conv_local, (u, w, b),
                     (("batch", None, "model"), (None, "model"), ("model",)),
                     ("batch", None, "model"))


def _causal_conv_local(u, w, b):
    dc = w.shape[0]
    out = u * w[-1]
    for j in range(1, dc):
        shifted = F.pad(u, (0, 0, j, 0))[:, : u.shape[1]]
        out = out + shifted * w[dc - 1 - j]
    return out + b


def _ssm_inputs(u: torch.Tensor, p, cfg):
    """Common projections. u: (B, L, di) post-conv post-silu ->
    dt (B, L, di) fp32, B (B, L, ds), C (B, L, ds)."""
    ds, dr = cfg.ssm_state, cfg.dt_rank
    # summed over "model" (d_inner's split) before it is cut in three: DTensor
    # 2.11 cannot carry the partial sum through the split and dt_proj
    dbc = shard_act(u @ p["x_proj"], ("batch",) + (None,) * (u.ndim - 1))
    dt_r, bmat, cmat = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"]).float() + p["dt_bias"].float())
    return dt, bmat, cmat


def _decay_inject(dt, u, bmat, a_log):
    """(B, L, di, ds) fp32 decay exp(dt A) and input dt u B."""
    decay = torch.exp(dt[..., None] * -torch.exp(a_log))
    inject = (dt * u.float())[..., None] * bmat.float()[..., None, :]
    return decay, inject


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps (a_t, b_t) along dim 1:
    (A_t, B_t) with h_t = A_t * h_0 + B_t. Hillis-Steele doubling."""
    n = a.shape[1]
    step = 1
    while step < n:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return a, b


def mamba_seq(x: torch.Tensor, p, cfg, h0=None):
    """Full-sequence forward. x: (B, L, d) -> (y (B, L, d),
    (conv_tail (B, dc-1, di), h_last)); the tuple is the decode state."""
    b, l, _ = x.shape
    di, ds = cfg.d_inner, cfg.ssm_state
    u_pre, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    u_pre = shard_act(u_pre, ("batch", None, "model"))
    z = shard_act(z, ("batch", None, "model"))
    u = F.silu(_causal_conv(u_pre, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _ssm_inputs(u, p, cfg)

    cl = min(cfg.ssm_chunk, l)
    assert l % cl == 0, (l, cl)
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for c0 in range(0, l, cl):
        part = slice(c0, c0 + cl)
        decay, inject = _decay_inject(dt[:, part], u[:, part], bmat[:, part], p["A_log"])
        decay = shard_act(decay, ("batch", None, "model", None))
        inject = shard_act(inject, ("batch", None, "model", None))
        a_pref, b_pref = _prefix_scan(decay, inject)
        hs = a_pref * h[:, None] + b_pref                            # (B, cl, di, ds)
        ys.append((hs * cmat[:, part].float()[:, :, None, :]).sum(-1))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + p["D"] * u.float()
    y = y.to(x.dtype) * F.silu(z)
    conv_tail = u_pre[:, -(cfg.ssm_conv - 1):]
    return y @ p["out_proj"], (conv_tail, h)


def mamba_decode(x: torch.Tensor, p, cfg, state):
    """One token. x: (B, 1, d); state = (conv_state (B, dc-1, di), h (B, di, ds))."""
    conv_st, h = state
    u, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)                 # (B, 1, di)
    u = shard_act(u, ("batch", None, "model"))  # as the state: channels over model
    z = shard_act(z, ("batch", None, "model"))
    window = torch.cat([conv_st, u], dim=1)                          # (B, dc, di)
    u_conv = (window * p["conv_w"]).sum(dim=1, keepdim=True) + p["conv_b"]
    u_act = F.silu(u_conv)
    dt, bmat, cmat = _ssm_inputs(u_act, p, cfg)
    decay, inject = _decay_inject(dt, u_act, bmat, p["A_log"])
    h_new = decay[:, 0] * h + inject[:, 0]                           # (B, di, ds)
    y = (h_new[:, None] * cmat.float()[:, :, None, :]).sum(-1)
    y = y + p["D"] * u_act.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], (window[:, 1:], h_new)


def init_state(batch: int, cfg, dtype: torch.dtype, device) -> tuple:
    return (
        torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    )
