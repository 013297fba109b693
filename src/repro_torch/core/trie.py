"""Prefix-tree template matcher (paper §III-D) — host reference.

Templates are token-id sequences where STAR_ID ('*') absorbs >= 1 log
tokens. All templates share one tree; matching a log is a single DFS walk
that prefers literal children over '*' (the paper's greedy rule) but
backtracks on failure, so a log matches iff SOME template matches it.
This makes the trie semantics identical to the batched DP matcher in
``core.match`` (asserted by tests), while keeping the paper's
one-pass prefix-sharing structure.

END nodes store the template id; on success we also return the parameter
spans (the log-token ranges each '*' absorbed).
"""

from __future__ import annotations

import numpy as np

from .tokenizer import PAD_ID, STAR_ID


class _Node:
    __slots__ = ("children", "star", "end_id")

    def __init__(self):
        self.children: dict[int, _Node] = {}
        self.star: _Node | None = None
        self.end_id: int = -1


class PrefixTree:
    """Trie over wildcard templates with DFS (literal-first) matching."""

    def __init__(self):
        self.root = _Node()
        self.n_templates = 0

    def insert(self, template: np.ndarray | list[int], template_id: int) -> None:
        node = self.root
        for tok in template:
            tok = int(tok)
            if tok == PAD_ID:
                break
            if tok == STAR_ID:
                if node.star is None:
                    node.star = _Node()
                node = node.star
            else:
                nxt = node.children.get(tok)
                if nxt is None:
                    nxt = _Node()
                    node.children[tok] = nxt
                node = nxt
        if node.end_id < 0:  # first inserted template wins duplicates
            node.end_id = template_id
        self.n_templates += 1

    def match(self, tokens: np.ndarray | list[int]) -> tuple[int, list[tuple[int, int]]] | None:
        """Match a PAD-stripped token-id sequence.

        Returns (template_id, [(start, end) per '*'], ) with end exclusive,
        or None. Iterative DFS; literal edges are tried before '*', and a
        '*' absorbs as few tokens as possible first (leftmost-shortest
        spans — same tie-break as the DP backtrack).
        """
        toks = [int(t) for t in tokens if int(t) != PAD_ID]
        n = len(toks)
        # stack entries: (node, i, spans, pending_star_start)
        # pending_star_start >= 0 means we are inside a '*' that started
        # there and has absorbed tokens toks[start:i].
        stack: list[tuple[_Node, int, tuple, int]] = [(self.root, 0, (), -1)]
        while stack:
            node, i, spans, star_start = stack.pop()
            if star_start >= 0:
                # inside a star that has absorbed toks[star_start:i] (>=1)
                if i < n:
                    # option A (pushed first = tried last): absorb one more
                    stack.append((node, i + 1, spans, star_start))
                # option B (tried first): close the span here and continue
                stack.append((node, i, spans + ((star_start, i),), -1))
                continue
            if i == n:
                if node.end_id >= 0:
                    return node.end_id, list(spans)
                # a trailing '*' cannot absorb zero tokens — dead end
                continue
            if node.star is not None:
                # star must absorb >= 1 token; try after literals
                stack.append((node.star, i + 1, spans, i))
            child = node.children.get(toks[i])
            if child is not None:
                stack.append((child, i + 1, spans, -1))
        return None

    def match_batch(self, ids: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, list]:
        """Match many lines. -> (template_ids (N,) int32 with -1 = no match,
        spans list per line)."""
        n = ids.shape[0]
        out = np.full((n,), -1, np.int32)
        spans_out: list = [None] * n
        for r in range(n):
            res = self.match(ids[r, : lens[r]])
            if res is not None:
                out[r] = res[0]
                spans_out[r] = res[1]
        return out, spans_out
