"""Iterative Structure Extraction (paper §III): sampling -> clustering ->
matching, iterated over the unmatched remainder until the match-rate
target is reached.

Inputs are already tokenized/id-encoded (see ``repro_torch.core.tokenizer``).
The output assigns every line a template id (or -1 -> stored verbatim by
the codec) plus the global template list — exactly the "hidden structure"
the compressor consumes, and directly reusable by downstream tasks
(anomaly detection example uses the EventID stream).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cluster import ClusterConfig, cluster_sample
from .match import match_first
from .timing import StageTimer


@dataclass
class ISEConfig:
    sample_rate: float = 0.01     # paper: p ~ 0.01
    min_sample: int = 1000        # floor so tiny inputs still cluster
    max_iters: int = 5
    target_match_rate: float = 0.9  # paper: "empirically, 90%"
    seed: int = 0
    use_kernel: bool = True       # route matching through the CUDA kernel
    cluster: ClusterConfig = field(default_factory=ClusterConfig)


@dataclass
class ISEResult:
    templates: list[np.ndarray]          # token-id arrays with STAR_ID
    assign: np.ndarray                   # (N,) int32 template id, -1 = none
    match_rate_per_iter: list[float]
    sampled_per_iter: list[int]

    @property
    def match_rate(self) -> float:
        return float((self.assign >= 0).mean()) if len(self.assign) else 1.0


def iterative_structure_extraction(
    ids: np.ndarray,
    lens: np.ndarray,
    levels: np.ndarray | None = None,
    comps: np.ndarray | None = None,
    vocab_size: int | None = None,
    cfg: ISEConfig | None = None,
    stage_times: dict | None = None,
    device: str = "cuda",
) -> ISEResult:
    cfg = cfg or ISEConfig()
    tm = StageTimer(stage_times)
    n = ids.shape[0]
    vocab_size = vocab_size or int(ids.max(initial=1)) + 1
    rng = np.random.default_rng(cfg.seed)

    assign = np.full((n,), -1, np.int32)
    templates: list[np.ndarray] = []
    seen: set[tuple] = set()
    rates: list[float] = []
    sampled_counts: list[int] = []

    unmatched = np.arange(n)
    for _ in range(cfg.max_iters):
        if len(unmatched) == 0:
            break
        # --- sampling (Bernoulli at rate p, floored) ---
        k = max(min(cfg.min_sample, len(unmatched)), int(round(cfg.sample_rate * len(unmatched))))
        sample_idx = unmatched[rng.random(len(unmatched)) < (k / len(unmatched))]
        if len(sample_idx) == 0:
            sample_idx = unmatched[: cfg.min_sample]
        sampled_counts.append(len(sample_idx))

        # --- clustering the sample -> new templates ---
        with tm("ise.cluster"):
            new_templates = cluster_sample(
                ids[sample_idx],
                lens[sample_idx],
                levels[sample_idx] if levels is not None else None,
                comps[sample_idx] if comps is not None else None,
                cfg.cluster,
                vocab_size,
            )
        fresh: list[np.ndarray] = []
        for tpl in new_templates:
            key = tuple(int(x) for x in tpl)
            if key not in seen:
                seen.add(key)
                fresh.append(tpl)
        base_id = len(templates)
        templates.extend(fresh)

        # --- matching all unmatched lines against the new templates ---
        # (previously-unmatched lines can only match templates discovered
        # this round; older templates already failed on them)
        if fresh:
            with tm("ise.match"):
                local = match_first(ids[unmatched], lens[unmatched], fresh,
                                    use_kernel=cfg.use_kernel, device=device)
            hit = local >= 0
            assign[unmatched[hit]] = base_id + local[hit]
            unmatched = unmatched[~hit]
        rates.append(1.0 - len(unmatched) / max(n, 1))
        if rates[-1] >= cfg.target_match_rate:
            break

    return ISEResult(templates, assign, rates, sampled_counts)


def templates_as_strings(templates: list[np.ndarray], vocab) -> list[str]:
    out = []
    for tpl in templates:
        out.append(" ".join(vocab.token(int(t)) for t in tpl if int(t) != 0))
    return out
