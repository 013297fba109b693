"""LCS template merging (paper §III-C).

When a log joins a cluster, the cluster template is updated to
``LCS(message, template)`` with ``*`` marking positions where the two
sequences disagree (gaps collapse into a single ``*``).

``lcs_merge`` is the host (numpy) implementation used inside streaming
clustering (runs only on the ~1% sample, as in the paper). ``lcs_length``
is the true LCS length in torch, the oracle the tests hold the φ
surrogate (``common_token_count``, the ``simcount`` kernel) against.
"""

from __future__ import annotations

import numpy as np
import torch

from .tokenizer import PAD_ID, STAR_ID


def lcs_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge two token-id sequences into a wildcard template.

    a, b: 1-D int arrays (no PAD). STAR_ID entries (from an existing
    template) never equal real tokens, so they fall into gaps and re-emerge
    as '*' — matching the paper's behaviour of keeping disagreements
    wildcarded.
    """
    n, m = len(a), len(b)
    # DP table of LCS lengths. STAR never matches anything (incl. STAR):
    # a '*' means "unknown varying part", not a token.
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(1, n + 1):
        ai = a[i - 1]
        if ai == STAR_ID:
            dp[i] = np.maximum(dp[i - 1], dp[i])
            dp[i] = np.maximum.accumulate(dp[i])
            continue
        match = (b == ai).astype(np.int32)
        # vectorized row update: dp[i][j] = max(dp[i-1][j], dp[i][j-1],
        #                                       dp[i-1][j-1] + match)
        row_prev = dp[i - 1]
        row = dp[i]
        best = 0
        for j in range(1, m + 1):
            cand = row_prev[j - 1] + match[j - 1] if match[j - 1] else 0
            best = max(row_prev[j], best, cand)
            row[j] = best
    # backtrack
    out: list[int] = []
    i, j = n, m
    gap = False
    while i > 0 and j > 0:
        if (
            a[i - 1] == b[j - 1]
            and a[i - 1] != STAR_ID
            and dp[i][j] == dp[i - 1][j - 1] + 1
        ):
            if gap:
                out.append(STAR_ID)
                gap = False
            out.append(int(a[i - 1]))
            i -= 1
            j -= 1
        elif dp[i - 1][j] >= dp[i][j - 1]:
            i -= 1
            gap = True
        else:
            j -= 1
            gap = True
    if gap or i > 0 or j > 0:
        out.append(STAR_ID)
    return np.array(out[::-1], dtype=np.int32)


def common_token_count(m_tokens: np.ndarray, templates: np.ndarray, t_lens: np.ndarray | None = None) -> np.ndarray:
    """φ(m, t_k) = number of tokens of m present in template k (paper's
    fast LCS surrogate). PAD/STAR never count.

    m_tokens: (T,) int32; templates: (K, T) int32 -> (K,) int32.
    """
    m_valid = m_tokens[(m_tokens != PAD_ID) & (m_tokens != STAR_ID)]
    if len(m_valid) == 0 or templates.size == 0:
        return np.zeros((templates.shape[0] if templates.ndim else 0,), np.int32)
    # (K, T, Tm) equality — sizes are tiny (sample clustering only)
    eq = templates[:, :, None] == m_valid[None, None, :]
    eq &= (templates != PAD_ID)[:, :, None] & (templates != STAR_ID)[:, :, None]
    return eq.any(axis=1).sum(axis=1).astype(np.int32)



def lcs_length(a, b) -> torch.Tensor:
    """True LCS length between two PAD-padded id vectors -> int32 scalar.

    PAD and STAR entries of either vector match nothing. Row by row over
    ``a``: ``dp[i][j] = max(dp[i-1][j], dp[i][j-1], dp[i-1][j-1] + match)``,
    which is a running maximum along ``j`` of ``max(dp[i-1][j],
    dp[i-1][j-1] + match)``; a PAD or STAR row copies the previous one.
    """
    a = torch.as_tensor(a).to(torch.int32).reshape(-1)
    b = torch.as_tensor(b).to(torch.int32).reshape(-1)
    m = b.shape[0]
    if m == 0:
        return torch.zeros((), dtype=torch.int32)
    b_ok = (b != PAD_ID) & (b != STAR_ID)
    row = torch.zeros(m, dtype=torch.int32)
    for ai in a.tolist():
        if ai in (PAD_ID, STAR_ID):
            continue
        diag = torch.cat([torch.zeros(1, dtype=torch.int32), row[:-1]])
        cand = torch.where((b == ai) & b_ok, diag + 1, 0)
        row = torch.cummax(torch.maximum(row, cand), dim=0).values
    return row[-1]
