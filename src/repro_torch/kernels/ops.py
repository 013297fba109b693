"""numpy in/out wrappers over the port's kernels, as the pipeline calls them.

Each function takes the ``device`` the work runs on. On ``"cuda"`` the
inputs go to the card and the hand-written CUDA kernel runs; a failure
to build or launch it raises. On ``"cpu"`` the kernel's plain torch
version runs. There is no fallback from one to the other, and asking for
``"cuda"`` where there is no card raises (``check_device``).

``launch_counts`` says how often each kernel was launched, the evidence
that a run went through the kernels. ``input_hook``, when a measuring
script sets it, sees the tensors of every call of a kernel wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from . import colcodec as _cc
from . import wildcard_match as _wm
from .wildcard_match import STAR_ID


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device
    and no card is present, or when it is neither CUDA nor CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was asked for but no CUDA device is available "
                "(pass device='cpu' to run the kernels' plain torch versions)")
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {str(device)!r}")
    return dev


# None, or a callable that each call of a kernel wrapper passes (kernel
# name, the tuple of tensors given to the wrapper) before the call
input_hook = None


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {"wildcard_match": _wm.launches(), "colcodec_transform": _cc.launches()}


def reset_launch_counts() -> None:
    _wm.reset_launches()
    _cc.reset_launches()


def _to(dev: torch.device, arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(dev)


# --------------------------------------------------------------- matching

def wildcard_match(logs, lens, templates, t_lens, *, device="cuda") -> np.ndarray:
    """-> (N, K) bool match matrix of ``templates`` over ``logs``."""
    dev = check_device(device)
    logs = np.asarray(logs, np.int32)
    lens_np = np.asarray(lens, np.int32)
    args = (_to(dev, logs), _to(dev, lens_np), _to(dev, templates), _to(dev, t_lens))
    if input_hook is not None:
        input_hook("wildcard_match", args)
    out = _wm.wildcard_match(*args).cpu().numpy()
    # the host truncation rule: a line longer than the grid never matches
    return out & (lens_np <= logs.shape[1])[:, None]


def pack_templates(templates: list[np.ndarray], t_max: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pad a ragged template list into (K, Tt) + (K,) length arrays.

    A template longer than ``t_max`` cannot be represented in Tt slots;
    silently truncating its tokens while recording the full length would
    make the kernel match a *prefix* the host matcher never would. Such
    templates get the ``t_len = -1`` sentinel instead: the kernel (and its
    plain version) treat them as matching nothing, which is consistent
    with the host whenever ``t_max >= logs.shape[1]`` (a template with
    more units than the log budget can never match).
    """
    if not templates:
        return np.zeros((0, 1), np.int32), np.zeros((0,), np.int32)
    tt = t_max or max(len(t) for t in templates)
    k = len(templates)
    mat = np.zeros((k, tt), np.int32)
    lens = np.zeros((k,), np.int32)
    for i, t in enumerate(templates):
        if len(t) > tt:
            mat[i] = t[:tt]
            lens[i] = -1  # over-length sentinel: matches nothing
        else:
            lens[i] = len(t)
            mat[i, : len(t)] = t
    return mat, lens


def wildcard_match_host(ids: np.ndarray, lens: np.ndarray, templates: list[np.ndarray],
                        *, device="cuda") -> np.ndarray:
    """numpy in/out convenience used by ``match_first_bucketed``."""
    tmpl, tlens = pack_templates(templates)
    if tmpl.shape[0] == 0:
        return np.zeros((ids.shape[0], 0), bool)
    return wildcard_match(ids, lens, tmpl, tlens, device=device)


def match_first_bucketed(ids: np.ndarray, lens: np.ndarray, templates: list[np.ndarray],
                         *, device="cuda") -> np.ndarray:
    """Lowest-id matching template per line via the kernel, with
    first-token bucketing (the trie's root-level pruning): templates are
    grouped by their first literal token and each bucket's launch only
    sees the lines that start with that token. Star-first templates run
    against all lines. -> (N,) int32 assignment, -1 = none.
    """
    n = ids.shape[0]
    n_tpl = len(templates)
    best = np.full((n,), n_tpl, np.int64)  # sentinel: no match
    if n == 0 or n_tpl == 0:
        return np.full((n,), -1, np.int32)

    buckets: dict[int, list[int]] = {}
    star_bucket: list[int] = []
    for k, tpl in enumerate(templates):
        if len(tpl) == 0:
            continue  # empty templates match nothing (host semantics)
        if int(tpl[0]) == STAR_ID:
            star_bucket.append(k)
        else:
            buckets.setdefault(int(tpl[0]), []).append(k)

    def run(line_sel: np.ndarray, tidx: list[int]) -> None:
        sub = wildcard_match_host(ids[line_sel], lens[line_sel], [templates[k] for k in tidx],
                                  device=device)
        any_m = sub.any(axis=1)
        if not any_m.any():
            return
        # tidx is ascending, argmax picks the first True -> lowest id in bucket
        cand = np.asarray(tidx, np.int64)[sub.argmax(axis=1)]
        rows = line_sel[any_m]
        best[rows] = np.minimum(best[rows], cand[any_m])

    first_tok = ids[:, 0] if ids.shape[1] else np.zeros((n,), np.int32)
    for f, tidx in buckets.items():
        sel = np.nonzero(first_tok == f)[0]
        if len(sel):
            run(sel, tidx)
    if star_bucket:
        run(np.arange(n), star_bucket)
    return np.where(best < n_tpl, best, -1).astype(np.int32)


# ------------------------------------------------------ typed column codecs

def delta_zigzag(vals: np.ndarray, lens: np.ndarray, mode: np.ndarray,
                 *, device="cuda") -> np.ndarray:
    """Batched typed-column transform: (R, C) int32 columns + per-row
    length and mode (1 = delta, 2 = zigzag delta-of-delta, 3 =
    frame-of-reference) -> (R, C) uint32 payload values, exactly
    ``coltypes.transform_ints`` per row for magnitudes below
    ``coltypes.KERNEL_SAFE``.

    The frame-of-reference row minimum is computed here, over the valid
    prefix, and handed to the kernel as data.
    """
    dev = check_device(device)
    vals = np.asarray(vals, np.int32)
    lens_np = np.asarray(lens, np.int32)
    mode_np = np.asarray(mode, np.int32)
    r, width = vals.shape
    if r == 0:
        return np.zeros((0, width), np.uint32)
    pos_ok = np.arange(width)[None, :] < lens_np[:, None]
    ref = np.where(pos_ok, vals, np.iinfo(np.int32).max).min(axis=1)
    ref = np.where((mode_np == 3) & (lens_np > 0), ref, 0).astype(np.int32)
    args = (_to(dev, vals), _to(dev, lens_np), _to(dev, mode_np), _to(dev, ref))
    if input_hook is not None:
        input_hook("colcodec_transform", args)
    return _cc.colcodec_transform(*args).cpu().numpy()
