"""Hierarchical clustering for ISE (paper §III-C).

Coarse division: group sampled lines by (verbosity level, component,
top-1..top-N corpus-frequent tokens of the line). Implemented as one
composite-key ``np.unique`` over an (N, 2+N_top) key matrix — equivalent
to the paper's successive divisions but single-pass and parallel.

Fine-grained clustering: the paper's streaming pass — each line joins the
existing cluster with max φ (common-token count) if φ > θ = |m|/2, whose
template is then LCS-merged; otherwise it opens a new cluster. Runs only
on the ~1% sample, per coarse group (groups are independent → the paper's
"embarrassingly parallel" claim; on a pod each group is a shard).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .lcs import common_token_count, lcs_merge
from .tokenizer import PAD_ID, STAR_ID


@dataclass
class ClusterConfig:
    n_top_tokens: int = 3      # paper: N is "normally set to 3"
    theta_ratio: float = 0.5   # theta = ratio * |m|
    max_clusters_per_group: int = 256


def top_frequent_tokens(ids: np.ndarray, lens: np.ndarray, n_top: int, vocab_size: int) -> np.ndarray:
    """Per line: ids of its top-k most corpus-frequent tokens (k columns).

    Frequencies are counted over the *sampled* lines (paper counts on the
    sample). Duplicate tokens within a line count once; ties break by
    token id for determinism. Missing slots are PAD.
    """
    n, t = ids.shape
    freq = np.bincount(ids.ravel(), minlength=vocab_size).astype(np.int64)
    freq[PAD_ID] = 0
    # rarity floor: a token that occurs in <1% of sampled lines is a
    # parameter, not structure (the paper's own premise in §III-C.3) —
    # without this, short lines key their coarse group on parameter
    # values and the division over-fragments.
    freq[freq < max(2, n // 100)] = 0
    # dedupe within each row: sort by id, mask repeats
    order = np.sort(ids, axis=1)
    dup = np.zeros_like(order, dtype=bool)
    dup[:, 1:] = order[:, 1:] == order[:, :-1]
    uniq = np.where(dup | (order == PAD_ID), PAD_ID, order)
    # rank key: primary freq desc, secondary id asc -> single sortable int
    f = freq[uniq]
    f[uniq == PAD_ID] = -1
    key = f * (vocab_size + 1) + (vocab_size - uniq)  # id asc as tiebreak
    top_idx = np.argsort(-key, axis=1, kind="stable")[:, :n_top]
    out = np.take_along_axis(uniq, top_idx, axis=1)
    out[np.take_along_axis(f, top_idx, axis=1) <= 0] = PAD_ID  # rare -> no key
    return out.astype(np.int64)


def coarse_groups(
    ids: np.ndarray,
    lens: np.ndarray,
    levels: np.ndarray | None,
    comps: np.ndarray | None,
    cfg: ClusterConfig,
    vocab_size: int,
) -> np.ndarray:
    """-> group id per line (N,), grouping by (level, component, top-k)."""
    n = ids.shape[0]
    cols = [
        levels.astype(np.int64) if levels is not None else np.zeros(n, np.int64),
        comps.astype(np.int64) if comps is not None else np.zeros(n, np.int64),
        top_frequent_tokens(ids, lens, cfg.n_top_tokens, vocab_size),
    ]
    keys = np.column_stack(cols)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    return inverse.astype(np.int64)


def fine_cluster_group(ids: np.ndarray, lens: np.ndarray, cfg: ClusterConfig) -> list[np.ndarray]:
    """Streaming fine-grained clustering of one coarse group's lines.

    Returns the cluster templates (token-id arrays with STAR_ID wildcards).
    """
    templates: list[np.ndarray] = []
    t_max = ids.shape[1]
    tmpl_mat = np.zeros((0, t_max), np.int32)  # padded template matrix for phi
    for r in range(ids.shape[0]):
        row = ids[r, : min(int(lens[r]), t_max)]
        if len(row) == 0:
            continue
        theta = cfg.theta_ratio * len(row)
        if templates:
            phi = common_token_count(row, tmpl_mat)
            best = int(np.argmax(phi))
            if float(phi[best]) > theta:
                merged = lcs_merge(templates[best], row)
                # keep the merge only if some literal structure survives
                if (merged != STAR_ID).any():
                    templates[best] = merged
                    padded = np.zeros((t_max,), np.int32)
                    padded[: min(len(merged), t_max)] = merged[:t_max]
                    tmpl_mat[best] = padded
                continue
        if len(templates) < cfg.max_clusters_per_group:
            templates.append(row.astype(np.int32).copy())
            padded = np.zeros((1, t_max), np.int32)
            padded[0, : len(row)] = row
            tmpl_mat = np.concatenate([tmpl_mat, padded], axis=0)
    return templates


def cluster_sample(
    ids: np.ndarray,
    lens: np.ndarray,
    levels: np.ndarray | None,
    comps: np.ndarray | None,
    cfg: ClusterConfig,
    vocab_size: int,
) -> list[np.ndarray]:
    """Full hierarchical pass over a sample -> deduped template list."""
    groups = coarse_groups(ids, lens, levels, comps, cfg, vocab_size)
    templates: list[np.ndarray] = []
    seen: set[tuple] = set()
    for g in np.unique(groups):
        sel = groups == g
        for tpl in fine_cluster_group(ids[sel], lens[sel], cfg):
            key = tuple(int(x) for x in tpl)
            if key not in seen:
                seen.add(key)
                templates.append(tpl)
    return templates
