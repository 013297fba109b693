"""Plain oracles for the ported kernels, under the names of the JAX
package's ``repro.kernels.ref``.

Each torch oracle is the plain version that lives beside its kernel;
this module only gives it the reference's name, so tests hold
``repro.kernels.ref.X`` against ``repro_torch.kernels.ref.X``.
``match_extract_ref`` is, as in the reference, the host anchor matcher
(``core.match.match_extract_one``), an implementation of the same DP
tie-break independent of the kernel's. Every kernel of the JAX package
has its oracle here.
"""

from __future__ import annotations

import numpy as np

from ..core.match import match_extract_one
from .colcodec import colcodec_transform_plain as colcodec_transform_ref
from .scan import distinct_counts_plain as distinct_counts_ref
from .simcount import simcount_plain as simcount_ref
from .tokenize import tokenize_hash_plain as tokenize_hash_ref
from .wildcard_match import PAD_ID, STAR_ID
from .wildcard_match import wildcard_match_plain as wildcard_match_ref

__all__ = ["PAD_ID", "STAR_ID", "colcodec_transform_ref", "distinct_counts_ref",
           "match_extract_ref", "simcount_ref", "tokenize_hash_ref", "wildcard_match_ref"]


def match_extract_ref(logs, lens, templates, t_lens, n_slots: int):
    """Oracle for ``kernels.match_extract.match_extract``: lowest-id
    matching template + per-star spans, via the host fused anchor matcher
    -> (assign (N,) int32, spans (N, n_slots, 2) int32), numpy in/out."""
    logs = np.asarray(logs)
    lens_np = np.asarray(lens)
    templates = np.asarray(templates)
    t_lens = np.asarray(t_lens)
    n = logs.shape[0]
    assign = np.full(n, -1, np.int32)
    spans = np.zeros((n, n_slots, 2), np.int32)
    for k in range(templates.shape[0]):
        if int(t_lens[k]) < 0:
            continue  # over-length / padding sentinel: matches nothing
        tpl = templates[k, : int(t_lens[k])]
        todo = assign < 0
        if not todo.any():
            break
        ok, sp = match_extract_one(logs[todo], lens_np[todo], tpl, want_spans=True)
        rows = np.flatnonzero(todo)[ok]
        assign[rows] = k
        if sp is not None and sp.shape[1]:
            spans[rows, : sp.shape[1]] = sp[ok]
    return assign, spans
