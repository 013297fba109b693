"""numpy in/out wrappers over the port's kernels, as the pipeline, the
query engine and the kernel benchmark call them.

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

from ..core.textops import first_occurrence_unique, runs_of
from . import colcodec as _cc
from . import match_extract as _me
from . import scan as _sn
from . import simcount as _sc
from . import tokenize as _tk
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
# name, the tuple of tensors given to the wrapper, and of its sizes where
# they are not the tensors' shapes) before the call
input_hook = None


# kernel -> (its launch count, the count's reset)
_KERNELS = {name: (mod.launches, mod.reset_launches) for name, mod in (
    ("wildcard_match", _wm), ("colcodec_transform", _cc), ("tokenize_hash", _tk),
    ("simcount", _sc), ("match_extract", _me), ("distinct_counts", _sn))}
_KERNELS["wildcard_match_first"] = (_wm.first_launches, _wm.reset_first_launches)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: count() for name, (count, _) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for _, reset in _KERNELS.values():
        reset()


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
    """numpy in/out convenience: the (N, K) match matrix of a template list."""
    tmpl, tlens = pack_templates(templates)
    if tmpl.shape[0] == 0:
        return np.zeros((ids.shape[0], 0), bool)
    return wildcard_match(ids, lens, tmpl, tlens, device=device)


def bucket_tables(ids: np.ndarray, tmpl: np.ndarray, tlens: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """First-token buckets of packed templates (the trie's root level) ->
    (line_bucket (N,), bucket_ptr (B+1,), bucket_tpl, star_tpl), int32.

    Non-empty templates whose first token is a literal form the buckets,
    one per distinct first token in ascending order, each holding its
    template ids ascending (CSR over ``bucket_ptr``); star-first ones go
    to ``star_tpl``, ascending; empty ones (``tlens == 0``) match nothing
    and go nowhere. A line's bucket is the one keyed by its first token
    (0 for a grid of width 0), -1 where none is.
    """
    n, k = ids.shape[0], tmpl.shape[0]
    first = tmpl[:, 0] if tmpl.shape[1] else np.zeros((k,), np.int32)
    live = tlens != 0
    star = live & (first == STAR_ID)
    lit = np.flatnonzero(live & ~star)
    order = np.argsort(first[lit], kind="stable")  # ascending ids within a key
    bucket_tpl = lit[order]
    keys, starts = np.unique(first[bucket_tpl], return_index=True)
    bucket_ptr = np.append(starts, len(bucket_tpl))
    line_first = ids[:, 0] if ids.shape[1] else np.zeros((n,), np.int32)
    pos = np.searchsorted(keys, line_first)
    found = pos < len(keys)
    found[found] = keys[pos[found]] == line_first[found]
    line_bucket = np.where(found, pos, -1)
    return tuple(np.asarray(a, np.int32) for a in (line_bucket, bucket_ptr, bucket_tpl,
                                                   np.flatnonzero(star)))


def match_first_bucketed(ids: np.ndarray, lens: np.ndarray, templates: list[np.ndarray],
                         *, device="cuda") -> np.ndarray:
    """Lowest-id matching template per line, with first-token bucketing
    (the trie's root-level pruning): a line's candidates are the
    templates whose first literal token is the line's first token, and
    the star-first templates. One ``wildcard_match_first`` launch over
    every line and template of the call; (N,) int32 comes back, -1 =
    none. Lines longer than the grid (``len > T``) match nothing.
    """
    n = ids.shape[0]
    if n == 0 or not templates:
        return np.full((n,), -1, np.int32)
    dev = check_device(device)
    ids = np.asarray(ids, np.int32)
    tmpl, tlens = pack_templates(templates)
    tables = bucket_tables(ids, tmpl, tlens)
    args = tuple(_to(dev, a) for a in (ids, lens, tmpl, tlens, *tables))
    if input_hook is not None:
        input_hook("wildcard_match_first", args)
    return _wm.wildcard_match_first(*args).cpu().numpy()


def simcount(logs, templates, *, device="cuda") -> np.ndarray:
    """(N, T) x (K, Tt) int32 -> (N, K) int32 common-token counts φ."""
    dev = check_device(device)
    args = (_to(dev, logs), _to(dev, templates))
    if input_hook is not None:
        input_hook("simcount", args)
    return _sc.simcount(*args).cpu().numpy()


def match_extract(ids: np.ndarray, lens: np.ndarray, templates: list[np.ndarray],
                  *, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Fused kernel path: one launch -> (assign (N,) int32 lowest-id
    matching template or -1, spans (N, n_slots, 2) int32 ``[start, end)``
    per star of the assigned template, 0 in every other slot and on every
    row with ``assign == -1``). ``n_slots`` is the most stars of any
    template, at least 1. Lines longer than the grid (``len > T``) are
    masked here, where the true width is known: they never match.
    """
    dev = check_device(device)
    ids = np.asarray(ids, np.int32)
    lens_np = np.asarray(lens, np.int32)
    n, t = ids.shape
    tmpl, tlens = pack_templates(templates)
    n_slots = max([1] + [int((np.asarray(tp) == STAR_ID).sum()) for tp in templates])
    if tmpl.shape[0] == 0 or n == 0:
        return np.full(n, -1, np.int32), np.zeros((n, n_slots, 2), np.int32)
    args = (_to(dev, ids), _to(dev, lens_np), _to(dev, tmpl), _to(dev, tlens))
    if input_hook is not None:
        input_hook("match_extract", args)
    assign, spans = _me.match_extract(*args, n_slots)
    assign, spans = assign.cpu().numpy(), spans.cpu().numpy()
    over = lens_np > t  # truncated lines never match (host rule)
    assign[over] = -1
    spans[over] = 0
    return assign, spans


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


# ------------------------------------------------- compressed-domain scan

def distinct_counts(inv, n_bins: int, weights=None, *, device="cuda") -> np.ndarray:
    """Weighted histogram of a distinct-row inverse index: ``out[b] =
    sum(weights[i] for inv[i] == b)`` -> (n_bins,) int32, accumulated with
    int32 wraparound. ``weights=None`` counts occurrences; rows with
    ``inv`` outside ``[0, n_bins)`` add nothing."""
    dev = check_device(device)
    inv_np = np.asarray(inv, np.int64)
    n = inv_np.shape[0]
    if n == 0 or n_bins == 0:
        return np.zeros(n_bins, np.int32)
    w_np = np.ones(n, np.int32) if weights is None else np.asarray(weights, np.int32)
    # out-of-range rows become -1 before the int32 cast, which would wrap
    # an index of 2**32 + b onto bin b
    inv_np = np.where((inv_np >= 0) & (inv_np < n_bins), inv_np, -1)
    args = (_to(dev, inv_np), _to(dev, w_np), n_bins)
    if input_hook is not None:
        input_hook("distinct_counts", args)
    return _sn.distinct_counts(*args).cpu().numpy()


# --------------------------------------------------------- byte tokenizer

DEFAULT_DELIMITERS = " \t,;:="


def pack_lines(lines: list[str]) -> tuple[np.ndarray, np.ndarray, list[bytes]]:
    """utf-8 encode + pad lines into an (N, B) uint8 block -> (blocks,
    byte lengths, encoded lines). B is the longest line plus one: every
    row ends in at least one pad byte, so token runs never merge across
    rows when host code scans the flattened mask."""
    enc = [line.encode("utf-8", "surrogateescape") for line in lines]
    n = len(enc)
    blens = np.fromiter((len(e) for e in enc), np.int32, n)
    width = int(blens.max(initial=1)) + 1
    blocks = np.zeros((n, width), np.uint8)
    for i, e in enumerate(enc):
        blocks[i, : len(e)] = np.frombuffer(e, np.uint8)
    return blocks, blens, enc


def _tokenize_hash(blocks: np.ndarray, blens: np.ndarray, delimiters: str,
                   dev: torch.device, pws: tuple) -> tuple[np.ndarray, ...]:
    """(mask, starts, pref1, pref2) of ``blocks`` as numpy arrays."""
    args = (torch.from_numpy(blocks).to(dev), _to(dev, blens),
            torch.from_numpy(pws[0][0]).to(dev), torch.from_numpy(pws[1][0]).to(dev))
    if input_hook is not None:
        input_hook("tokenize_hash", args)
    outs = _tk.tokenize_hash(*args, tuple(ord(c) for c in delimiters))
    return tuple(o.cpu().numpy() for o in outs)


def device_tokenize(lines: list[str], delimiters: str = DEFAULT_DELIMITERS,
                    *, device="cuda") -> list[tuple[list[str], list[str]]]:
    """Kernel-backed ``tokenize`` over a batch -> [(tokens, delims), ...].

    Runs the byte tokenizer kernel for the boundary masks, then slices
    token/delimiter strings on the host. ``reassemble`` of each result is
    byte-identical to the input line, and tokens agree with
    ``core.tokenizer.tokenize`` for ASCII delimiter sets.
    """
    dev = check_device(device)
    if not lines:
        return []
    blocks, blens, enc = pack_lines(lines)
    pws = _tk.hash_powers(blocks.shape[1])
    mask = _tokenize_hash(blocks, blens, delimiters, dev, pws)[0].astype(bool)
    out = []
    for i, e in enumerate(enc):
        ts, te = runs_of(mask[i, : len(e)])
        toks = [e[s:t2].decode("utf-8", "surrogateescape") for s, t2 in zip(ts, te)]
        bounds = np.concatenate([[0], np.stack([ts, te], 1).ravel(), [len(e)]]) \
            if len(ts) else np.array([0, len(e)])
        dl = [e[bounds[2 * j]:bounds[2 * j + 1]].decode("utf-8", "surrogateescape")
              for j in range(len(ts) + 1)]
        out.append((toks, dl))
    return out


def device_encode_batch(contents: list[str], vocab, max_len: int,
                        delimiters: str = DEFAULT_DELIMITERS,
                        *, tight: bool = True, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Kernel-backed twin of ``Vocab.encode_batch``: tokenize + hash on
    the device, intern only unseen 64-bit (2 x uint32) hashes on the host.

    -> (ids (N, W) int32, lens (N,) int32), equal to the host path on a
    vocab in the same state.
    """
    dev = check_device(device)
    n = len(contents)
    if n == 0:
        return np.zeros((0, 1), np.int32), np.zeros(0, np.int32)
    blocks, blens, enc = pack_lines(contents)
    pws = _tk.hash_powers(blocks.shape[1])
    mask, starts, pref1, pref2 = _tokenize_hash(blocks, blens, delimiters, dev, pws)
    mask = mask.astype(bool)

    rows, scol = np.nonzero(starts)                # token starts, row-major
    # token ends from the flattened mask (rows never merge: pack_lines
    # guarantees a trailing pad byte per row)
    ecol = runs_of(mask.ravel())[1] - rows * mask.shape[1]
    lens = np.bincount(rows, minlength=n).astype(np.int32)
    width = max(1, min(max_len, int(lens.max(initial=1)))) if tight else max_len
    col = np.arange(len(rows)) - np.concatenate([[0], np.cumsum(lens)])[rows]
    keep = col < width
    rows, scol, ecol, col = rows[keep], scol[keep], ecol[keep], col[keep]

    def lane(pref, pw_inv):
        lo = np.where(scol > 0, pref[rows, np.maximum(scol - 1, 0)], np.uint32(0))
        return (pref[rows, ecol - 1] - lo) * pw_inv[scol]
    h = lane(pref1, pws[0][1]).astype(np.uint64) << np.uint64(32)
    h |= lane(pref2, pws[1][1]).astype(np.uint64)
    tok_of, fo = first_occurrence_unique(h)
    table = [enc[rows[i]][scol[i]:ecol[i]].decode("utf-8", "surrogateescape")
             for i in fo.tolist()]
    vid = np.fromiter((vocab.id(t) for t in table), np.int32, len(table)) \
        if table else np.zeros(0, np.int32)
    ids = np.zeros((n, width), np.int32)
    ids[rows, col] = vid[tok_of]
    return ids, lens
