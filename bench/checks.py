"""The comparisons that decide ``correct``. A cell's
``limits/<workload>.json`` names the numbers it compares and the limit
of each (the readings each limit was set from are in PERF.md).

- ``batch_mismatch``: tokens of the batches the steps consumed that the
  log lines do not give, packed as the batcher's format states (each line
  as UTF-8 bytes plus ``byte_offset``, then ``eos``, lines in order within
  a shard, shards whole in any order, batches cut from the stream in
  turn, labels the tokens shifted by one). Exact: limit 0.
- ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``
  that of the first step alone, which no update has moved yet.
- ``grad_gap``, ``change_gap``: the worst leaf's gap between the
  program's and the reference's norm (of the first clipped gradient, and
  of the change of the parameters over the checked steps), over the
  larger of the reference's norm of that leaf and of the median leaf.
  The change leaves out leaves whose first gradient, in the reference,
  is under a thousandth of the median leaf's. ``grad_gap_median``: the
  median leaf's gap of the first gradient.
- ``grad_diff``, ``grad_diff_median``: the worst and the median leaf's
  norm of the difference between the program's first gradient and the
  reference's, element by element, over the larger of the reference's
  norm of that leaf and of the median leaf. Rounding that is unbiased
  cancels in a norm and in a mean loss, but not in this difference.
- ``global_norm_gap``: the relative gap of the first gradient's global
  norm before clipping.
- ``served_gap``: the widest gap by which a served token's logit lies
  below the reference's best at its position.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def shard_streams(lines: list[str], shard_lines: int, byte_offset: int, eos: int) -> list:
    out = []
    for a in range(0, len(lines), shard_lines):
        parts = []
        for line in lines[a:a + shard_lines]:
            b = np.frombuffer(line.encode("utf-8", "surrogateescape"), np.uint8)
            parts.append(b.astype(np.int64) + byte_offset)
            parts.append(np.array([eos], np.int64))
        out.append(np.concatenate(parts))
    return out


def program_stream(batches: list[dict]) -> tuple[np.ndarray, int]:
    """(the token stream the batches were cut from, the labels that are
    not their row's tokens shifted by one)."""
    rows, bad = [], 0
    for b in batches:
        t = b["tokens"].cpu().numpy().astype(np.int64)
        lab = b["labels"].cpu().numpy().astype(np.int64)
        bad += int((lab[:, :-1] != t[:, 1:]).sum())
        rows.append(np.concatenate([t, lab[:, -1:]], axis=1).reshape(-1))
    return np.concatenate(rows), bad


def match_stream(stream: np.ndarray, shards: list) -> tuple[int, list[int]]:
    """(tokens of ``stream`` that no whole shard in an unused turn
    explains, the order of the shards matched). A new epoch makes every
    shard usable again."""
    pos, order, left = 0, [], set(range(len(shards)))
    while pos < len(stream):
        if not left:
            left = set(range(len(shards)))
        hit = None
        for k in sorted(left):
            n = min(len(shards[k]), len(stream) - pos)
            if np.array_equal(stream[pos:pos + n], shards[k][:n]):
                hit = k
                break
        if hit is None:
            return len(stream) - pos, order
        order.append(hit)
        left.discard(hit)
        pos += len(shards[hit])
    return 0, order


def reference_batches(shards: list, order: list[int], n: int, batch: int, seq: int) -> list[dict]:
    """The reference's own first ``n`` batches: its shard streams in
    ``order`` (then the rest in turn), cut into (batch, seq + 1) rows."""
    rest = [k for k in range(len(shards)) if k not in order]
    stream = np.concatenate([shards[k] for k in list(order) + rest])
    need = batch * (seq + 1)
    out = []
    for i in range(n):
        arr = stream[i * need:(i + 1) * need].reshape(batch, seq + 1)
        out.append({"tokens": arr[:, :-1], "labels": arr[:, 1:]})
    return out


def loss_gap(got: list[float], ref: list[float]) -> float:
    return max(abs(g - r) / max(abs(r), 1e-30) if math.isfinite(g) else math.inf
               for g, r in zip(got, ref))


def norm_gap(got: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(the worst leaf's gap, its name) over the leaves in ``keep`` (all
    where None)."""
    names = [k for k in ref if keep is None or k in keep]
    median = float(np.median([ref[k] for k in names]))
    worst, at = 0.0, ""
    for k in names:
        g = got[k]
        gap = abs(g - ref[k]) / max(ref[k], median) if math.isfinite(g) else math.inf
        if gap > worst or at == "":
            worst, at = gap, k
    return worst, at


def median_gap(got: dict, ref: dict) -> float:
    """The median leaf's gap, each gap as ``norm_gap`` measures it."""
    median = float(np.median(list(ref.values())))
    return float(np.median([abs(got[k] - v) / max(v, median) for k, v in ref.items()]))


def diff_gap(got: dict, ref: dict, ref_norms: dict, pick: str = "worst") -> float:
    """The worst (or ``pick="median"``) leaf's norm of ``got - ref``,
    each over the larger of the reference's norm of that leaf and of the
    median leaf; leaves are tensors of the same shape, or a missing
    ``got`` leaf reads infinite."""
    median = float(np.median(list(ref_norms.values())))
    gaps = []
    for k, r in ref.items():
        g = got.get(k)
        d = math.inf if g is None else float(torch.linalg.vector_norm(g.float() - r.float()))
        gaps.append(d / max(ref_norms[k], median) if math.isfinite(d) else math.inf)
    return float(np.median(gaps)) if pick == "median" else max(gaps)


def moved_leaves(ref_grads: dict) -> set[str]:
    """Leaves whose first gradient, in the reference, is at least a
    thousandth of the median leaf's: the others move by round-off."""
    median = float(np.median(list(ref_grads.values())))
    return {k for k, v in ref_grads.items() if v >= 1e-3 * median}


def served_gaps(ref_logits: np.ndarray, served: np.ndarray) -> np.ndarray:
    """Gap of each served token below the best logit at its position;
    a token outside the vocabulary reads infinite."""
    v = ref_logits.shape[-1]
    best = ref_logits.max(axis=-1)
    ok = served < v
    picked = np.take_along_axis(ref_logits, np.where(ok, served, 0)[..., None], -1)[..., 0]
    return np.where(ok, best - picked, np.inf)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is not finite, or has no limit, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        out[name] = {"value": value, "limit": lim}
        if lim is None or not (isinstance(value, (int, float)) and math.isfinite(value)
                               and value <= lim):
            ok = False
    return ok, out
