"""RWKV-6 (Finch) time-mix layer with data-dependent per-channel decay
(``repro.models.rwkv6``).

The chunked GLA-style algorithm of the reference. Within a chunk the
recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

is expanded into an intra-chunk (c x c) attention-like product plus an
inter-chunk state carry. The *cumulative* log-decay within a chunk is
clamped at ``CLAMP`` so the r*exp(+L) / k*exp(-L) factorization stays
inside fp32 range; decode clamps each step's log-decay instead. Both are
the reference's code, kept as they are: an exact recurrence would differ
from it wherever a chunk's decay passes the clamp. (The reference's
docstring says -20; its code, and so this port, uses -30.) Sequential
depth is L/chunk; decode is O(1) on the (B, H, hd, hd) state.

Channel-mix (the RWKV FFN) is a token-shifted squared-ReLU MLP; both
mixes use token-shift lerps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.act_shard import on_blocks, shard_act

CLAMP = -30.0


def _shift(x: torch.Tensor, prev=None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros or ``prev`` carry at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _projections(x, xprev, p, cfg):
    b, l, _ = x.shape
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim

    def mix(mu):
        return x * mu + xprev * (1 - mu)

    r = shard_act((mix(p["mu_r"]) @ p["w_r"]).reshape(b, l, h, hd), ("batch", None, "model", None))
    k = shard_act((mix(p["mu_k"]) @ p["w_k"]).reshape(b, l, h, hd), ("batch", None, "model", None))
    v = shard_act((mix(p["mu_v"]) @ p["w_v"]).reshape(b, l, h, hd), ("batch", None, "model", None))
    g = shard_act(F.silu(mix(p["mu_g"]) @ p["w_g"]), ("batch", None, "model"))
    dec = p["w_decay0"] + (torch.tanh(mix(p["mu_w"]) @ p["w_decay1"]) @ p["w_decay2"]).float()
    logw = -torch.exp(dec)                  # log decay in (-inf, 0)
    return r, k, v, g, shard_act(logw.reshape(b, l, h, hd), ("batch", None, "model", None))


def _group_norm(o: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS normalization of the wkv output (B, L, H, hd)."""
    var = torch.mean(o * o, dim=-1, keepdim=True)
    return o * torch.rsqrt(var + eps) * scale


_HEADS = ("batch", None, "model", None)   # (B, L, H, hd)
_STATE_DIMS = ("batch", "model", None, None)   # (B, H, hd, hd)


def _chunk(s, rr, kk, vv, ww, u):
    """One chunk: state (B, H, hd, hd) and (B, cl, H, hd) fp32 inputs ->
    (new state, output (B, cl, H, hd)), on each rank's (batch, head)
    blocks; the results are placed as the reference constrains them."""
    return on_blocks(_chunk_local, (s, rr, kk, vv, ww, u),
                     (_STATE_DIMS, _HEADS, _HEADS, _HEADS, _HEADS, ("model", None)),
                     (_STATE_DIMS, _HEADS))


def _chunk_local(s, rr, kk, vv, ww, u):
    """``_chunk`` on plain tensors."""
    cl = rr.shape[1]
    lcum = torch.clamp(torch.cumsum(ww, dim=1), min=CLAMP)         # L_t (<= 0)
    lprev = torch.cat([torch.zeros_like(lcum[:, :1]), lcum[:, :-1]], dim=1)
    r_tld = rr * torch.exp(lprev)                                   # r_t * e^{L_{t-1}}
    k_tld = kk * torch.exp(-lcum)                                   # k_s * e^{-L_s}
    # intra-chunk scores A[t, s] = sum_c r~[t, c] k~[s, c], strict causal
    scores = torch.einsum("bthc,bshc->bhts", r_tld, k_tld)
    tpos = torch.arange(cl, device=rr.device)
    scores = scores * (tpos[:, None] > tpos[None, :])
    diag = torch.einsum("bthc,hc,bthc->bth", rr, u, kk)            # bonus term
    o = torch.einsum("bhts,bshc->bthc", scores, vv)
    o = o + diag[..., None] * vv
    o = o + torch.einsum("bthc,bhcd->bthd", r_tld, s)               # inter-chunk
    # state update: S' = e^{L_c} (.) S + sum_s e^{L_c - L_s} k_s v_s^T
    lend = lcum[:, -1]                                              # (B, H, hd)
    s_new = torch.exp(lend)[..., None] * s + torch.einsum(
        "bshc,bshd->bhcd", k_tld * torch.exp(lend)[:, None], vv)
    return s_new, o


def rwkv_seq(x: torch.Tensor, p, cfg, state=None):
    """Time-mix over a full sequence. x: (B, L, d) -> (y, (x_last, S_last))."""
    b, l, d = x.shape
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
         if state is None else state[1])
    xprev = _shift(x, None if state is None else state[0])
    r, k, v, g, logw = _projections(x, xprev, p, cfg)

    cl = min(cfg.ssm_chunk, l)
    assert l % cl == 0
    outs = []
    for c0 in range(0, l, cl):
        part = slice(c0, c0 + cl)
        s, o = _chunk(s, *(t[:, part].float() for t in (r, k, v, logw)), p["u_bonus"])
        outs.append(o)
    o = torch.cat(outs, dim=1)
    o = _group_norm(o, p["ln_scale"]).reshape(b, l, d).to(x.dtype)
    y = (o * g) @ p["w_o"]
    return y, (x[:, -1], s)


def rwkv_decode(x: torch.Tensor, p, cfg, state):
    """One token. x: (B, 1, d); state = (x_prev (B, d), S (B, H, hd, hd))."""
    b, _, d = x.shape
    x_prev, s = state
    r, k, v, g, logw = _projections(x, x_prev[:, None], p, cfg)
    rr, kk, vv = (t[:, 0].float() for t in (r, k, v))               # (B, H, hd)
    w = torch.exp(torch.clamp(logw[:, 0].float(), min=CLAMP))
    heads = ("batch", "model", None)
    o, s_new = on_blocks(_step, (s, rr, kk, vv, w, p["u_bonus"]),
                         (_STATE_DIMS, heads, heads, heads, heads, ("model", None)),
                         (heads, _STATE_DIMS))
    o = _group_norm(o[:, None], p["ln_scale"]).reshape(b, 1, d).to(x.dtype)
    y = (o * g) @ p["w_o"]
    return y, (x[:, 0], s_new)


def _step(s, rr, kk, vv, w, u):
    """One step of the recurrence on plain tensors: state (B, H, hd, hd),
    (B, H, hd) fp32 inputs -> (output (B, H, hd), new state)."""
    kv = torch.einsum("bhc,bhd->bhcd", kk, vv)
    o = torch.einsum("bhc,bhcd->bhd", rr, s + u[None, :, :, None] * kv)
    return o, w[..., None] * s + kv


def init_state(batch: int, cfg, dtype: torch.dtype, device) -> tuple:
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return (
        torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
    )


# ----------------------------------------------------------- channel mix

def cmix_seq(x: torch.Tensor, p, prev=None):
    xprev = _shift(x, prev)
    xm = x * p["mu"] + xprev * (1 - p["mu"])
    h = torch.square(F.relu(xm @ p["wk"]))
    return h @ p["wv"], x[:, -1]
