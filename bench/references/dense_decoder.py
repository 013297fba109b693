"""Plain reference of a dense decoder LM (the Qwen2 and Qwen3 layouts of
Hugging Face ``transformers``): float32 throughout, TF32 off, products as
``@``, attention as a whole masked softmax per row block, no cache, no
kernel, nothing of the program under test.

- RMSNorm, computed in fp32: ``x * rsqrt(mean(x^2) + eps) * scale``.
- Attention: q, k, v projections (+ biases in Qwen2), per-head RMSNorm
  of q and k (Qwen3), rotary embedding by halves (``rotate_half``) with
  ``theta ** (-2i / head_dim)`` (angles in float64), causal softmax scaled
  by ``head_dim ** -0.5``, key/value head ``h // (H / KV)`` for query head
  ``h``, output projection.
- SwiGLU FFN: ``(silu(x @ w1) * (x @ w3)) @ w2``.
- Logits over the published vocabulary: ``x @ unembed``, or ``x @ embed.T``
  where the embeddings are tied.
- Training: next-token cross-entropy plus ``z_loss * lse^2``, both
  averaged over all tokens of the batch, gradients summed over row
  blocks, global-norm clipping, AdamW with bias correction.

``quant="fp8"`` is the control: every product's two operands rounded to
float8 e4m3 with one scale a tensor (amax to 448) in the forward, the
gradient passed straight through.

The family's leaves (``leaves``) and the work its cells count
(``train_phases``, ``serve_phases``) are here too, as the package's
docstring lists.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# bytes of fp32 intermediates the reference may hold for a block of rows
BLOCK_BYTES = 8 << 30


def dims(c: dict) -> dict:
    """The sizes and switches of a dense decoder from its published
    ``config.json`` keys."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    mt = c["model_type"]
    if mt not in ("qwen2", "qwen3"):
        raise ValueError(f"no dense decoder mapping for model_type {mt!r}")
    return {
        "layers": c["num_hidden_layers"], "d": d, "heads": h,
        "kv_heads": c["num_key_value_heads"], "head_dim": c.get("head_dim") or d // h,
        "ffn": c["intermediate_size"], "vocab": c["vocab_size"],
        "eps": c["rms_norm_eps"], "theta": float(c["rope_theta"]),
        "tied": bool(c["tie_word_embeddings"]),
        # Qwen2 always has q/k/v biases; Qwen3 states ``attention_bias``
        # and always has per-head q/k norms
        "qkv_bias": bool(c.get("attention_bias", mt == "qwen2")),
        "qk_norm": mt == "qwen3",
    }


def leaves(c: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every leaf, at the published shapes
    (``vocab_size`` rows), products laid out as ``x @ W``: init is
    "normal" (N(0, fan_in ** -0.5) for a matrix, divided by sqrt(2 L) for
    the output projections ``wo`` and ``w2``, N(0, 0.02) for the
    embedding), "ones" (norm scales) or "zeros" (biases)."""
    m = dims(c)
    d, f, v, hd = m["d"], m["ffn"], m["vocab"], m["head_dim"]
    qd, kd = m["heads"] * hd, m["kv_heads"] * hd
    deep = math.sqrt(2 * m["layers"])
    out = [("embed", (v, d), "normal", 0.02)]
    for i in range(m["layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), "ones", 1.0), (p + "wq", (d, qd), "normal", d ** -0.5),
                (p + "wk", (d, kd), "normal", d ** -0.5), (p + "wv", (d, kd), "normal", d ** -0.5)]
        if m["qkv_bias"]:
            out += [(p + "bq", (qd,), "zeros", 0.0), (p + "bk", (kd,), "zeros", 0.0),
                    (p + "bv", (kd,), "zeros", 0.0)]
        if m["qk_norm"]:
            out += [(p + "q_norm", (hd,), "ones", 1.0), (p + "k_norm", (hd,), "ones", 1.0)]
        out += [(p + "wo", (qd, d), "normal", qd ** -0.5 / deep), (p + "ln2", (d,), "ones", 1.0),
                (p + "w1", (d, f), "normal", d ** -0.5), (p + "w3", (d, f), "normal", d ** -0.5),
                (p + "w2", (f, d), "normal", f ** -0.5 / deep)]
    out.append(("ln_f", (d,), "ones", 1.0))
    if not m["tied"]:
        out.append(("unembed", (d, v), "normal", d ** -0.5))
    return out


def tiny(c: dict) -> dict:
    """``c`` two layers deep and 64 wide, computed in fp32, for the CPU tests."""
    out = dict(c, num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=128, vocab_size=512,
               torch_dtype="float32")
    if "head_dim" in out:
        out["head_dim"] = 16
    return out


def block_rows(c: dict, seq: int, grad: bool) -> int:
    """Rows of ``seq`` tokens the reference computes at once within
    ``BLOCK_BYTES``: a layer's score tiles and activations, every layer's
    held for the backward where ``grad``, and the logits."""
    m = dims(c)
    layer = 4 * (3 * m["heads"] * seq * seq + 16 * seq * max(m["d"], m["ffn"]))
    row = (m["layers"] if grad else 1) * layer + (3 * 4 * seq * m["vocab"] if grad else 0)
    return max(1, BLOCK_BYTES // row)


def _n_params(c: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in leaves(c))


def _layer_products(c: dict) -> int:
    """Parameters of one token's products in all layers (q, k, v, o and
    the three FFN matrices)."""
    m = dims(c)
    d, qd, kd = m["d"], m["heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"]
    return m["layers"] * (2 * d * qd + 2 * d * kd + 3 * d * m["ffn"])


def _causal_attention_flops(c: dict, rows: int, seq: int) -> int:
    """Forward FLOPs of causal attention over ``rows`` sequences of
    ``seq``: q.k and p.v over the S (S + 1) / 2 pairs a head attends."""
    m = dims(c)
    pairs = seq * (seq + 1) // 2
    return 4 * rows * m["heads"] * m["head_dim"] * pairs * m["layers"]


def train_phases(c: dict, batch: int, seq: int, bytes_per_param: int = 2) -> list[dict]:
    """Phases of one training step: the forward and backward (3x the
    forward's FLOPs; the parameters and tokens read, the gradients
    written) and AdamW (parameters, gradients and two fp32 moments read,
    parameters and moments written)."""
    p, t = _n_params(c), batch * seq
    unembed = dims(c)["d"] * dims(c)["vocab"]
    fwd = 2 * (_layer_products(c) + unembed) * t + _causal_attention_flops(c, batch, seq)
    return [{"phase": "forward_backward", "flops": 3 * fwd,
             "bytes": 2 * bytes_per_param * p + 8 * t},
            {"phase": "adamw", "flops": 0,
             "bytes": 3 * bytes_per_param * p + 16 * p}]


def serve_phases(c: dict, batch: int, prompt: int, new: int,
                 bytes_per_param: int = 2) -> list[dict]:
    """Phases of one served batch: the prefill of ``batch`` prompts of
    ``prompt`` tokens (logits at the last position only; the K/V cache
    written) and ``new - 1`` decode steps, each reading the weights and
    the valid part of the cache."""
    m = dims(c)
    unembed = m["d"] * m["vocab"]
    kv_token = 2 * m["layers"] * m["kv_heads"] * m["head_dim"] * bytes_per_param
    weights = bytes_per_param * _n_params(c)
    if not m["tied"]:  # decode gathers ``batch`` rows of the embedding table
        weights_decode = weights - bytes_per_param * (m["vocab"] - batch) * m["d"]
    else:
        weights_decode = weights
    out = [{"phase": "prefill",
            "flops": 2 * _layer_products(c) * batch * prompt
            + _causal_attention_flops(c, batch, prompt) + 2 * unembed * batch,
            "bytes": weights + kv_token * batch * prompt + 4 * batch * prompt}]
    for k in range(1, new):
        ctx = prompt + k  # the cache's valid slots, the new token's included
        out.append({"phase": f"decode{k}",
                    "flops": 2 * (_layer_products(c) + unembed) * batch
                    + 4 * batch * m["heads"] * m["head_dim"] * ctx * m["layers"],
                    "bytes": weights_decode + kv_token * batch * ctx})
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def _mm(a, b, quant):
    if quant == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x (B, H, S, hd) rotated by halves at positions 0..S-1."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = theta ** (-np.arange(0, hd, 2, dtype=np.float64) / hd)
    ang = np.arange(s, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.from_numpy(np.cos(ang)).to(x.device, torch.float32)
    sin = torch.from_numpy(np.sin(ang)).to(x.device, torch.float32)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def hidden(W: dict, c: dict, tokens: torch.Tensor, quant=None) -> torch.Tensor:
    """tokens (B, S) -> the final normed hidden state (B, S, d), fp32."""
    m = dims(c)
    b, s = tokens.shape
    h, kv, hd = m["heads"], m["kv_heads"], m["head_dim"]
    x = W["embed"][tokens.long()]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(m["layers"]):
        p = f"layers.{i}."
        a = _rms(x, W[p + "ln1"], m["eps"])
        q, k, v = _mm(a, W[p + "wq"], quant), _mm(a, W[p + "wk"], quant), _mm(a, W[p + "wv"], quant)
        if m["qkv_bias"]:
            q, k, v = q + W[p + "bq"], k + W[p + "bk"], v + W[p + "bv"]
        q = q.view(b, s, h, hd).transpose(1, 2)
        k = k.view(b, s, kv, hd).transpose(1, 2)
        v = v.view(b, s, kv, hd).transpose(1, 2)
        if m["qk_norm"]:
            q, k = _rms(q, W[p + "q_norm"], m["eps"]), _rms(k, W[p + "k_norm"], m["eps"])
        q, k = _rope(q, m["theta"]), _rope(k, m["theta"])
        k = k.repeat_interleave(h // kv, dim=1)
        v = v.repeat_interleave(h // kv, dim=1)
        scores = _mm(q, k.transpose(-1, -2), quant) * hd ** -0.5
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = _mm(probs, v, quant).transpose(1, 2).reshape(b, s, h * hd)
        x = x + _mm(o, W[p + "wo"], quant)
        a = _rms(x, W[p + "ln2"], m["eps"])
        x = x + _mm(F.silu(_mm(a, W[p + "w1"], quant)) * _mm(a, W[p + "w3"], quant),
                    W[p + "w2"], quant)
    return _rms(x, W["ln_f"], m["eps"])


def unembedding(W: dict, c: dict) -> torch.Tensor:
    return W["embed"].T if dims(c)["tied"] else W["unembed"]


def logits_at(W: dict, c: dict, tokens: torch.Tensor, positions, quant=None) -> torch.Tensor:
    """Logits (B, len(positions), vocab) of ``tokens`` (B, S) at ``positions``."""
    with torch.no_grad():
        x = hidden(W, c, tokens, quant)[:, positions]
        return _mm(x, unembedding(W, c), quant)


def _loss_sum(W, c, tokens, labels, z_loss, quant):
    lg = _mm(hidden(W, c, tokens, quant), unembedding(W, c), quant)
    lse = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, labels.long()[..., None])[..., 0]
    return ((lse - ll) + z_loss * lse * lse).sum()


def train_steps(W0: dict, c: dict, batches, opt: dict, quant=None, rows: int = 1,
                half_batch: bool = False, keep_grads: bool = False) -> dict:
    """``len(batches)`` AdamW steps from ``W0`` (fp32 leaves) on
    {"tokens", "labels"} batches (B, S) -> {"losses": [the loss of each
    step], "grad_norms": {leaf: norm of the first clipped gradient},
    "global_norm": the first gradient's global norm before clipping,
    "change_norms": {leaf: norm of the change of the leaf over all the
    steps}}, and (``keep_grads``) "grads": {leaf: the first clipped
    gradient, on the host}. The loss of a step is the mean over its tokens, its
    gradients summed over blocks of ``rows`` rows; ``half_batch`` is a
    fault: the loss over the first half of the rows only. ``opt`` holds
    lr, b1, b2, eps, weight_decay, grad_clip and z_loss; weight decay goes
    to every leaf with two dimensions or more once the layers are stacked
    on a leading axis (every per-layer leaf, the embedding tables), not
    to the final norm."""
    W = {k: v.detach().clone().float().requires_grad_(True) for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) for k, v in W.items()}
    nu = {k: torch.zeros_like(v) for k, v in W.items()}
    decayed = {k for k, v in W.items() if k.startswith("layers.") or v.ndim >= 2}
    out = {"losses": [], "grad_norms": None}
    for t, batch in enumerate(batches, start=1):
        tokens, labels = batch["tokens"], batch["labels"]
        n = tokens.shape[0] // 2 if half_batch else tokens.shape[0]
        count = n * tokens.shape[1]
        total = 0.0
        for r in range(0, n, rows):
            loss = _loss_sum(W, c, tokens[r:min(r + rows, n)], labels[r:min(r + rows, n)],
                             opt["z_loss"], quant) / count
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total)
        with torch.no_grad():
            grads = {k: v.grad for k, v in W.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = min(1.0, opt["grad_clip"] / max(float(norm), 1e-9))
            grads = {k: g * scale for k, g in grads.items()}
            if out["grad_norms"] is None:
                out["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                                     for k, g in grads.items()}
                out["global_norm"] = float(norm)
                if keep_grads:
                    out["grads"] = {k: g.cpu() for k, g in grads.items()}
            c1 = 1 - opt["b1"] ** t
            c2 = 1 - opt["b2"] ** t
            for k, p in W.items():
                mu[k].mul_(opt["b1"]).add_(grads[k], alpha=1 - opt["b1"])
                nu[k].mul_(opt["b2"]).add_(grads[k] * grads[k], alpha=1 - opt["b2"])
                delta = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + opt["eps"])
                if k in decayed:
                    delta = delta + opt["weight_decay"] * p
                p.sub_(opt["lr"] * delta)
                p.grad = None
    with torch.no_grad():
        out["change_norms"] = {k: float(torch.linalg.vector_norm(W[k] - W0[k].float()))
                               for k in W}
    return out

