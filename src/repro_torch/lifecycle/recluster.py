"""Cross-session template re-clustering.

Compaction merges N sessions whose template stores grew independently.
Beyond concatenating stores, this module re-runs the paper's iterative
clustering ONE LEVEL UP — over templates instead of raw lines — so that
near-duplicate templates minted on either side of a session boundary
fold into a single pattern, templates no line references any more are
garbage-collected, and over-general templates whose star column carried
a single constant value across every chunk are specialized back into
literals (the "split on distribution shift" direction).

Everything is deterministic: inputs are processed in argument order,
templates in descending total-usage order with first-sighting
tie-breaks, so the same inputs always yield the same merged store and
the same remap tables.

The output of :func:`recluster_stores` is the remap protocol used by
``lifecycle.compact``:

- ``store``     — fresh merged :class:`TemplateStore`; its indices are
  the EventIDs of the compacted archive (they become the archive's
  header ``seed_templates``, so every merged id is live from chunk 0).
- ``remaps[i]`` — ``{old_gid -> new_gid}`` for input ``i``.  Dead
  templates (zero usage) are absent: they have no new id.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.lcs import common_token_count, lcs_merge
from ..core.templates import TemplateStore
from ..core.tokenizer import PAD_ID, STAR_ID

# Template-level folding is stricter than line-level clustering
# (theta_ratio 0.5 in core.cluster): a template is already an
# aggregate, so folding two of them loses structure for every line
# behind both.  Stars count toward |row| but never toward phi, which
# additionally biases star-heavy templates against folding.
FOLD_THETA_RATIO = 0.6

Template = tuple  # tuple[str | None, ...]


@dataclass
class ReclusterResult:
    store: TemplateStore
    remaps: list[dict[int, int]]
    report: dict = field(default_factory=dict)


def _token_ids(templates: list[Template]) -> dict[str, int]:
    """Pseudo-vocabulary over template tokens (ids >= 2; 0/1 reserved
    for PAD/STAR so the LCS kernels' sentinels stay meaningful)."""
    vocab: dict[str, int] = {}
    for t in templates:
        for tok in t:
            if tok is not None and tok not in vocab:
                vocab[tok] = len(vocab) + 2
    return vocab


def _encode(t: Template, vocab: dict[str, int]) -> np.ndarray:
    return np.asarray(
        [STAR_ID if tok is None else vocab[tok] for tok in t], dtype=np.int32
    )


def _decode(row: np.ndarray, rvocab: dict[int, str]) -> Template:
    return tuple(
        None if tid == STAR_ID else rvocab[int(tid)]
        for tid in row.tolist()
        if tid != PAD_ID
    )


def specialize_template(t: Template, constants: dict[int, str]) -> Template:
    """Replace the k-th star of ``t`` with a literal for each entry of
    ``constants`` (star index -> value).  Indices past the star count
    are ignored."""
    if not constants:
        return t
    out: list[str | None] = []
    star = 0
    for tok in t:
        if tok is None:
            out.append(constants.get(star, None) if star in constants else None)
            star += 1
        else:
            out.append(tok)
    return tuple(out)


def fold_templates(
    templates: list[Template],
    usage: list[int],
    *,
    theta_ratio: float = FOLD_THETA_RATIO,
) -> tuple[list[Template], list[int]]:
    """Streaming merge of near-duplicate templates.

    ``templates`` must already be deterministically ordered (callers
    sort by descending usage) — heavier templates become cluster
    anchors and absorb lighter near-duplicates, mirroring
    ``cluster.fine_cluster_group`` at the template level.

    Returns ``(folded, assign)`` where ``assign[j]`` is the index into
    ``folded`` for input template ``j``.
    """
    if not templates:
        return [], []
    vocab = _token_ids(templates)
    rvocab = {v: k for k, v in vocab.items()}
    max_len = max(len(t) for t in templates)
    # cluster state: padded matrix for the phi kernel + live rows
    tmpl_mat = np.zeros((0, max_len), dtype=np.int32)
    rows: list[np.ndarray] = []
    assign: list[int] = []
    for t in templates:
        row = _encode(t, vocab)
        if rows:
            counts = common_token_count(
                np.pad(row, (0, max_len - len(row))), tmpl_mat
            )
            best = int(np.argmax(counts))
            theta = theta_ratio * len(row)
            if float(counts[best]) > theta:
                merged = lcs_merge(rows[best], row)
                if (merged != STAR_ID).any() and len(merged) <= max_len:
                    rows[best] = merged
                    tmpl_mat[best, :] = 0
                    tmpl_mat[best, : len(merged)] = merged
                    assign.append(best)
                    continue
        assign.append(len(rows))
        rows.append(row)
        tmpl_mat = np.vstack(
            [tmpl_mat, np.pad(row, (0, max_len - len(row)))[None, :]]
        )
    folded = [_decode(r, rvocab) for r in rows]
    return folded, assign


def recluster_stores(
    templates_per_input: list[list[Template | None]],
    usage_per_input: list[dict[int, int]],
    *,
    fold: bool = True,
    theta_ratio: float = FOLD_THETA_RATIO,
    specialize: dict[Template, dict[int, str]] | None = None,
) -> ReclusterResult:
    """Merge per-input template lists into one fresh store.

    ``templates_per_input[i]`` is input *i*'s global template list
    (``None`` entries — salvage padding for unrecoverable deltas — are
    treated as dead).  ``usage_per_input[i]`` maps old gid -> line
    count; gids absent or mapped to 0 are dead and GC'd.
    ``specialize`` maps a template tuple to ``{star index -> constant}``
    evidence gathered from typed-column summaries; it is applied before
    folding so a specialized template can anchor its own cluster.
    """
    specialize = specialize or {}
    # 1. GC + specialization: collect live tuples with summed usage and
    #    deterministic first-sighting order.
    total_usage: dict[Template, int] = {}
    first_seen: dict[Template, tuple[int, int]] = {}
    tuple_of: list[dict[int, Template]] = []
    n_dead = 0
    n_specialized = 0
    for i, templates in enumerate(templates_per_input):
        usage = usage_per_input[i]
        t_of: dict[int, Template] = {}
        for gid, t in enumerate(templates):
            n = usage.get(gid, 0)
            if t is None or n <= 0:
                n_dead += 1
                continue
            tt = tuple(t)
            constants = specialize.get(tt)
            if constants:
                spec = specialize_template(tt, constants)
                if spec != tt:
                    n_specialized += 1
                    tt = spec
            t_of[gid] = tt
            total_usage[tt] = total_usage.get(tt, 0) + n
            first_seen.setdefault(tt, (i, gid))
        tuple_of.append(t_of)

    ordered = sorted(
        total_usage, key=lambda t: (-total_usage[t], first_seen[t])
    )

    # 2. Fold near-duplicates across session boundaries.
    if fold and ordered:
        folded, assign = fold_templates(
            ordered, [total_usage[t] for t in ordered], theta_ratio=theta_ratio
        )
        cluster_of = {t: folded[assign[j]] for j, t in enumerate(ordered)}
        n_folded = len(ordered) - len(set(assign))
    else:
        cluster_of = {t: t for t in ordered}
        n_folded = 0

    # 3. Assign final ids in anchor order (folding can make distinct
    #    clusters converge on the same tuple; the store dedups them).
    store = TemplateStore()
    remaps: list[dict[int, int]] = []
    for t_of in tuple_of:
        remaps.append({gid: store.add(cluster_of[tt]) for gid, tt in t_of.items()})

    report = {
        "inputs": len(templates_per_input),
        "templates_in": sum(len(t) for t in templates_per_input),
        "templates_out": len(store),
        "dead": n_dead,
        "folded": n_folded,
        "specialized": n_specialized,
    }
    return ReclusterResult(store=store, remaps=remaps, report=report)
