"""Batched wildcard-template matching (paper §III-D), accelerator-adapted.

The paper walks a prefix tree per log line. On an accelerator we want a dense,
branch-free formulation: for one template ``t_1..t_m`` and a line
``x_1..x_n`` define the reachability DP

    M[i, 0] = (i == 0)
    M[i, j] = M[i-1, j-1] and (x_i == t_j)            if t_j literal
    M[i, j] = OR_{i' < i} M[i', j-1]                  if t_j == '*'
              (= shift1(cummax(M[:, j-1])))           ('*' absorbs >= 1)

and the line matches iff ``M[n, m]``. Each template column is one
vectorized update over a whole *block of lines*, so the work is
(lines x template positions) vector ops — this is exactly what
the reference's Pallas kernel tiled onto VMEM, and what
``repro_torch.kernels.wildcard_match`` carries as bit-mask columns on
the GPU. The numpy path here is the host path (``use_kernel=False``) and
an oracle for the CUDA kernel.

Matching only needs the *final* DP column, so ``match_one_template``
carries a rolling (N, T+1) column instead of materializing the full
(N, T+1, m+1) tensor; the full tensor is only built for the span
backtrack in ``extract_spans``.

Parameter spans are recovered by a vectorized backtrack (later stars take
the shortest span; any valid alignment is lossless — the tie-break only
fixes determinism).

``match_first`` assigns each line the lowest-id matching template —
the production-canonical assignment. First-token bucketing (the trie's
root-level pruning) cuts the candidate template set per line, and exact
duplicate (ids, len) rows are collapsed before the DP runs — matching is
deterministic per row, so the result is identical, but real logs are
dominated by repeats and only pay for distinct lines.
"""

from __future__ import annotations

import numpy as np

from .tokenizer import STAR_ID

CHUNK = 4096  # lines per DP chunk (bounds the M tensor)
DEDUP_MIN_LINES = 512  # below this the np.unique sort costs more than it saves


def _dp_columns(ids: np.ndarray, lens: np.ndarray, template: np.ndarray) -> np.ndarray:
    """All DP columns for one template over a chunk of lines.

    ids: (N, T) int32, lens: (N,), template: (m,) id seq (no PAD).
    Returns M: (N, T+1, m+1) bool. Only used by the span backtrack —
    matching uses the rolling-column variant below.
    """
    n, t = ids.shape
    m = len(template)
    M = np.zeros((n, t + 1, m + 1), dtype=bool)
    M[:, 0, 0] = True
    pos = np.arange(1, t + 1)
    valid = pos[None, :] <= lens[:, None]  # (N, T) position i exists
    for j in range(1, m + 1):
        tj = int(template[j - 1])
        prev = M[:, :, j - 1]
        if tj == STAR_ID:
            # OR over strict prefix: shift-by-1 of running-OR
            run = np.logical_or.accumulate(prev, axis=1)
            M[:, 1:, j] = run[:, :-1]
        else:
            M[:, 1:, j] = prev[:, :-1] & (ids == tj)
        M[:, 1:, j] &= valid
    return M


def _final_col(ids: np.ndarray, lens: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Final DP column (N, T+1) after consuming the whole template.

    Rolling-column version of ``_dp_columns`` — O(N*T) live memory
    instead of O(N*T*m)."""
    n, t = ids.shape
    col = np.zeros((n, t + 1), dtype=bool)
    col[:, 0] = True
    valid = np.arange(1, t + 1)[None, :] <= lens[:, None]
    for tj in template:
        tj = int(tj)
        new = np.zeros_like(col)
        if tj == STAR_ID:
            run = np.logical_or.accumulate(col, axis=1)
            new[:, 1:] = run[:, :-1]
        else:
            new[:, 1:] = col[:, :-1] & (ids == tj)
        new[:, 1:] &= valid
        col = new
    return col


def match_one_template_dp(ids: np.ndarray, lens: np.ndarray, template: np.ndarray) -> np.ndarray:
    """(N,) bool via the rolling-column DP — the oracle for the fused
    anchor path below (and the shape the CUDA kernel reproduces)."""
    out = np.zeros((ids.shape[0],), bool)
    t = ids.shape[1]
    lens_c = np.minimum(lens, t)
    for s in range(0, ids.shape[0], CHUNK):
        sl = slice(s, min(s + CHUNK, ids.shape[0]))
        col = _final_col(ids[sl], lens_c[sl], template)
        out[sl] = col[np.arange(sl.stop - sl.start), lens_c[sl]]
    # over-length lines never match (their tail was truncated)
    out &= lens <= t
    return out


# ------------------------------------------------- fused anchor matching
#
# A template is literal runs anchored around stars:
#
#     P *1 L1 *2 L2 ... *k S      (prefix P, mids L1..Lk-1, suffix S)
#
# Matching and span extraction reduce to run placement (DESIGN.md §10):
# the DP's reachability set after "P *1 L1 ... Lj" has a closed form —
# an occurrence of Lj ending at e is reachable iff e >= minreach_j,
# where minreach_j is the LEFTMOST valid end (each star absorbs >= 1).
# A forward pass computes the minreach chain (match test), a backward
# pass takes the RIGHTMOST valid occurrence below the running cursor —
# exactly the DP backtrack's "largest i' <= i-1" tie-break, so spans are
# bit-identical to ``extract_spans_dp``. Cost: O(N * T * sum |runs|)
# vectorized compares instead of the O(N * T * m) DP with its (N, T, m)
# backtrack tensor, fusing match + span extraction into one pass.


def template_units(template: np.ndarray) -> tuple[np.ndarray, list[np.ndarray], np.ndarray, int]:
    """Decompose into (prefix, mids, suffix, n_stars); literal runs are
    id arrays (mids possibly empty for consecutive stars)."""
    arr = np.asarray(template)
    stars = np.flatnonzero(arr == STAR_ID)
    if len(stars) == 0:
        return arr, [], arr[:0], 0
    prefix = arr[: stars[0]]
    suffix = arr[stars[-1] + 1:]
    mids = [arr[stars[i] + 1: stars[i + 1]] for i in range(len(stars) - 1)]
    return prefix, mids, suffix, len(stars)


def _occ_ends(ids: np.ndarray, lit: np.ndarray) -> np.ndarray:
    """(N, T+1) bool: does an occurrence of literal run ``lit`` END at
    position e (tokens [e-|lit|, e) equal lit). Empty runs occur at
    every position. PAD can never equal a literal, so occurrences are
    automatically confined to the line's real tokens."""
    n, t = ids.shape
    L = len(lit)
    occ = np.zeros((n, t + 1), bool)
    if L == 0:
        occ[:] = True
        return occ
    if L > t:
        return occ
    acc = ids[:, :t - L + 1] == int(lit[0])
    for k in range(1, L):
        acc = acc & (ids[:, k:t - L + 1 + k] == int(lit[k]))
    occ[:, L:] = acc
    return occ


def match_extract_one(
    ids: np.ndarray,
    lens: np.ndarray,
    template: np.ndarray,
    *,
    want_spans: bool = False,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Fused match + parameter-span extraction for one template.

    -> (ok (N,) bool, spans (N, n_stars, 2) int32 or None). Spans rows
    are only meaningful where ``ok``; bit-identical to
    ``match_one_template_dp`` / ``extract_spans_dp``.
    """
    n, t = ids.shape
    prefix, mids, suffix, k = template_units(np.asarray(template))
    m = len(template)
    spans = np.zeros((n, k, 2), np.int32) if want_spans else None
    p, q = len(prefix), len(suffix)
    min_len = (m - k) + k  # literals + one token per star
    if n == 0 or min_len > t or (k == 0 and m > t):
        return np.zeros(n, bool), spans

    lens64 = lens.astype(np.int64)
    ok = lens64 <= t
    if k == 0:
        ok &= lens64 == m
        if m:
            ok &= (ids[:, :m] == np.asarray(template)[None, :]).all(axis=1)
        return ok, spans

    ok &= lens64 >= min_len
    if p:
        ok &= (ids[:, :p] == prefix[None, :]).all(axis=1)
    if q:
        # suffix at positions [len-q, len) — clip gathers for short lines
        # (those rows are already False via the min_len check)
        base = np.maximum(lens64 - q, 0)[:, None] + np.arange(q)[None, :]
        ok &= (np.take_along_axis(ids, np.minimum(base, t - 1), axis=1)
               == suffix[None, :]).all(axis=1)

    pos = np.arange(t + 1)
    # forward: leftmost valid end of each mid run (the reachability frontier)
    minr = np.full(n, p, np.int64)
    occs = []
    for lit in mids:
        occ = _occ_ends(ids, lit)
        occs.append(occ)
        gate = occ & (pos[None, :] >= (minr + 1 + len(lit))[:, None])
        has = gate.any(axis=1)
        ok &= has
        minr = np.where(has, gate.argmax(axis=1), t)  # first True
    ok &= minr <= lens64 - q - 1

    if want_spans and ok.any():
        i = lens64 - q  # cursor: end of the current star's span
        for j in range(k - 1, -1, -1):
            if j == 0:
                e = np.full(n, p, np.int64)
            else:
                occ = occs[j - 1]
                gate = occ & (pos[None, :] <= (i - 1)[:, None])
                e = t - np.argmax(gate[:, ::-1], axis=1)  # last True
            spans[:, j, 0] = e
            spans[:, j, 1] = i
            i = e - (len(mids[j - 1]) if j else 0)
    return ok, spans


def match_one_template(ids: np.ndarray, lens: np.ndarray, template: np.ndarray) -> np.ndarray:
    """(N,) bool: does each line match this template (fused anchor path)."""
    return match_extract_one(ids, lens, template)[0]


def match_first(
    ids: np.ndarray,
    lens: np.ndarray,
    templates: list[np.ndarray],
    use_kernel: bool = True,
    dedup: bool = True,
    device: str = "cuda",
) -> np.ndarray:
    """Assign each line the lowest-id matching template (-1 = none).

    Templates are bucketed by first token (literal or '*') like the trie
    root, so each line only runs the DP against plausible candidates.
    With ``dedup`` (default) duplicate (ids, len) rows are matched once
    and the assignment is broadcast back — bit-identical results, and the
    DP only pays for distinct lines. ``use_kernel`` runs the DP in the
    ``wildcard_match`` CUDA kernel on ``device`` (its plain torch version
    on a CPU device); False runs the numpy anchor matcher.
    """
    n = ids.shape[0]
    assign = np.full((n,), -1, np.int32)
    if not templates or n == 0:
        return assign

    if dedup and n >= DEDUP_MIN_LINES:
        # memcmp-sort on a void view of the packed rows — much cheaper
        # than np.unique(axis=0)'s per-column lexsort; only the grouping
        # matters (matching is deterministic per row), not the order
        key = np.ascontiguousarray(np.column_stack([lens.astype(np.int32), ids]))
        rows = key.view(np.dtype((np.void, key.shape[1] * key.itemsize))).ravel()
        _, first, inv = np.unique(rows, return_index=True, return_inverse=True)
        if len(first) < n:
            sub = match_first(
                ids[first], lens[first], templates,
                use_kernel=use_kernel, dedup=False, device=device,
            )
            return sub[inv].astype(np.int32)

    if use_kernel:
        from ..kernels import ops as kops

        return kops.match_first_bucketed(ids, lens, templates, device=device)

    first_tok = ids[:, 0]
    for k, tpl in enumerate(templates):
        if len(tpl) == 0:
            continue
        todo = assign < 0
        if int(tpl[0]) != STAR_ID:
            todo &= first_tok == int(tpl[0])
        if not todo.any():
            continue
        idx = np.nonzero(todo)[0]
        ok = match_one_template(ids[idx], lens[idx], tpl)
        assign[idx[ok]] = k
    return assign


def extract_spans(ids: np.ndarray, lens: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Parameter spans for lines *known to match* ``template``.

    Returns spans (N, n_stars, 2) int32 — token ranges [s, e) absorbed
    by each '*' in template order, via the fused anchor pass
    (bit-identical to the DP backtrack in ``extract_spans_dp``).
    """
    return match_extract_one(ids, lens, template, want_spans=True)[1]


def extract_spans_dp(ids: np.ndarray, lens: np.ndarray, template: np.ndarray) -> np.ndarray:
    """DP-backtrack oracle for ``extract_spans`` (full M tensor)."""
    n, t = ids.shape
    m = len(template)
    stars = [j for j in range(m) if int(template[j]) == STAR_ID]
    spans = np.zeros((n, len(stars), 2), dtype=np.int32)
    if n == 0 or not stars:
        return spans
    for s0 in range(0, n, CHUNK):
        sl = slice(s0, min(s0 + CHUNK, n))
        M = _dp_columns(ids[sl], lens[sl], template)
        i = lens[sl].astype(np.int64).copy()  # current log position per line
        star_i = len(stars) - 1
        pos = np.arange(t + 1)
        for j in range(m, 0, -1):
            if int(template[j - 1]) != STAR_ID:
                i -= 1
                continue
            # largest i' <= i-1 with M[i', j-1] true
            mask = M[:, :, j - 1] & (pos[None, :] <= (i - 1)[:, None])
            ip = t - np.argmax(mask[:, ::-1], axis=1)
            spans[sl, star_i, 0] = ip
            spans[sl, star_i, 1] = i
            i = ip
            star_i -= 1
    return spans
