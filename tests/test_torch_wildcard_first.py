"""The port's first-hit matcher (``wildcard_match_first``) and the op
around it (``ops.match_first_bucketed``) against the JAX package's.

On the CPU the wrapper runs its plain version, the per-bucket (N, K) DP
with any / argmax / min. Through the bucket tables that ``ops`` builds,
it and ``ops.match_first_bucketed(device="cpu")`` must equal, with
``array_equal`` (int32 ids, tolerance 0), the JAX package's
``match_first_bucketed`` (its Pallas kernel in interpret mode) and its
numpy ``match_first(use_kernel=False)``, on the cases the first-hit
kernel must get right: lines with no bucket and buckets with no line,
star-only and mixed template lists, first hits past 32 and 64
candidates and a lower star id that beats a bucket hit, ``len`` at 0, T
and T+1, T around the 32-bit column words up to 255, ``t_len < 0`` and
empty calls. The CUDA kernel runs only on a card: its tests are marked
``cuda`` and skip elsewhere.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.match import match_first as ref_match_first
from repro.kernels import ops as rops
from repro_torch.core.match import match_first
from repro_torch.kernels import ops
from repro_torch.kernels import wildcard_match as wm

STAR = 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _case(rng, n, t, k, vocab=4, star_share=0.3, max_tt=6, long_stars=False):
    """Lines over ids 2..vocab+3 (ids past vocab+1 start no bucket), and
    ``k`` templates over ids 2..vocab+1 whose first token is a star with
    probability ``star_share``; a third of the lines are planted matches
    of a template, each star absorbing 1-3 tokens (up to T/2 with
    ``long_stars``); lengths run from 0 to T+1."""
    templates = []
    for _ in range(k):
        m = int(rng.integers(1, max_tt + 1))
        tpl = rng.integers(2, 2 + vocab, m).astype(np.int32)
        tpl[rng.random(m) < 0.3] = STAR
        tpl[0] = STAR if rng.random() < star_share else rng.integers(2, 2 + vocab)
        templates.append(tpl)
    logs = rng.integers(2, 4 + vocab, (n, t)).astype(np.int32)
    lens = rng.integers(0, t + 2, n).astype(np.int32)
    for r in range(0, n, 3):
        if not k:
            break
        row = []
        for tok in templates[int(rng.integers(0, k))]:
            if tok == STAR:
                hi = max(2, t // 2) if long_stars else 4
                row += rng.integers(2, 2 + vocab, int(rng.integers(1, hi))).tolist()
            else:
                row.append(int(tok))
        if len(row) <= t:
            logs[r, :len(row)] = row
            lens[r] = len(row)
    for r in range(n):
        logs[r, max(0, min(int(lens[r]), t)):] = 0
    return logs, lens, templates


def _group_case():
    """One bucket (first token 2) of 120 literal-first templates ``[2, 10 +
    id]`` and star-first ones at ids 45 and 70, so that a line ``[2, 10 +
    p]`` first hits at candidate p: in the first group of 32, the
    second, and past 64; ``[2, 60]`` and ``[2, 110]`` also match a star
    id (45, 70) lower than their bucket hit (50, 100), and ``[2, 15]`` a
    star id (80) above it. A template keyed by 9 has no line, lines
    starting with 7 have no bucket."""
    templates = []
    for i in range(121):
        if i == 45:
            templates.append(np.array([STAR, 60], np.int32))
        elif i == 70:
            templates.append(np.array([STAR, 110], np.int32))
        elif i == 80:
            templates.append(np.array([STAR, STAR, 15], np.int32))
        else:
            templates.append(np.array([2, 10 + i], np.int32))
    templates.append(np.array([9, STAR], np.int32))
    rows = [[2, 10 + p] for p in (0, 5, 31, 32, 40, 63, 64, 69, 71, 99, 120, 300)]
    rows += [[2, 60], [2, 110], [7, 15], [7, 60], [2, 15], [2]]
    logs = np.zeros((len(rows), 3), np.int32)
    lens = np.zeros(len(rows), np.int32)
    for r, row in enumerate(rows):
        logs[r, :len(row)] = row
        lens[r] = len(row)
    return logs, lens, templates


def _plain_through_tables(logs, lens, templates, t_lens=None):
    tmpl, tlens = ops.pack_templates(templates)
    tables = ops.bucket_tables(logs, tmpl, tlens)
    if t_lens is not None:
        tlens = t_lens
    return wm.wildcard_match_first_plain(*[_t(a) for a in (logs, lens, tmpl, tlens, *tables)]
                                         ).numpy()


def _check(logs, lens, templates):
    got = ops.match_first_bucketed(logs, lens, templates, device="cpu")
    assert got.dtype == np.int32 and got.shape == (logs.shape[0],)
    want = ref_match_first(logs, lens, templates, use_kernel=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_plain_through_tables(logs, lens, templates), want)
    np.testing.assert_array_equal(got, rops.match_first_bucketed(logs, lens, templates))
    np.testing.assert_array_equal(
        match_first(logs, lens, templates, use_kernel=True, device="cpu"), want)
    return got


def test_first_hit_in_each_candidate_group():
    logs, lens, templates = _group_case()
    got = _check(logs, lens, templates)
    np.testing.assert_array_equal(
        got, [0, 5, 31, 32, 40, 63, 64, 69, 71, 99, 120, -1, 45, 70, -1, 45, 5, -1])


@pytest.mark.parametrize("t", [31, 32, 63, 64, 127, 128, 255])
def test_widths_around_column_words(t):
    rng = np.random.default_rng(t)
    logs, lens, templates = _case(rng, 60, t, 90, long_stars=True)
    lens[:3] = [0, t, t + 1]
    _check(logs, lens, templates)


@pytest.mark.parametrize("seed", range(4))
def test_small_vocabulary_large_buckets(seed):
    """Ids 2-5: hits are frequent and four buckets share 400 templates,
    each holding more than 64 candidates."""
    rng = np.random.default_rng(100 + seed)
    logs, lens, templates = _case(rng, 200, 12, 400, star_share=0.1, max_tt=5)
    templates.append(np.zeros(0, np.int32))  # empty template: matches nothing
    tmpl, tlens = ops.pack_templates(templates)
    _, ptr, _, _ = ops.bucket_tables(logs, tmpl, tlens)
    assert np.diff(ptr).min() > 64
    got = _check(logs, lens, templates)
    assert (got >= 0).mean() > 0.3


def test_star_only_templates():
    rng = np.random.default_rng(9)
    logs, lens, templates = _case(rng, 100, 10, 40, star_share=1.0)
    assert all(tp[0] == STAR for tp in templates)
    got = _check(logs, lens, templates)
    assert (got >= 0).any()


def test_lines_longer_than_the_grid_and_negative_lengths_match_nothing():
    rng = np.random.default_rng(4)
    logs, lens, templates = _case(rng, 90, 8, 30)
    lens[::4] = 9
    lens[1::9] = -1
    got = _check(logs, lens, templates)
    assert (got[lens > 8] == -1).all() and (got[lens < 0] == -1).all()


def test_negative_template_lengths_match_nothing():
    """A template with ``t_len < 0`` stays a candidate of its bucket and
    never matches, as if it were empty."""
    rng = np.random.default_rng(5)
    logs, lens, templates = _case(rng, 150, 10, 40, vocab=3)
    full = ref_match_first(logs, lens, templates, use_kernel=False)
    hit_ids = sorted(set(full[full >= 0].tolist()))[:3]
    _, t_lens = ops.pack_templates(templates)
    t_lens[hit_ids] = -1
    cut = [np.zeros(0, np.int32) if i in hit_ids else tp for i, tp in enumerate(templates)]
    got = _plain_through_tables(logs, lens, templates, t_lens)
    np.testing.assert_array_equal(got, ref_match_first(logs, lens, cut, use_kernel=False))
    assert not np.isin(got, hit_ids).any()


@pytest.mark.parametrize("n,k", [(0, 5), (7, 0), (0, 0)])
def test_empty_calls(n, k):
    rng = np.random.default_rng(n + k)
    logs, lens, templates = _case(rng, n, 6, k)
    got = ops.match_first_bucketed(logs, lens, templates, device="cpu")
    np.testing.assert_array_equal(got, np.full(n, -1, np.int32))
    tmpl, tlens = ops.pack_templates(templates)
    out = wm.wildcard_match_first_plain(
        *[_t(a) for a in (logs, lens, tmpl, tlens, *ops.bucket_tables(logs, tmpl, tlens))])
    assert out.dtype == torch.int32 and out.tolist() == [-1] * n


def test_grid_of_width_zero_matches_nothing():
    logs = np.zeros((4, 0), np.int32)
    lens = np.array([0, 0, 1, -1], np.int32)
    templates = [np.array([2, STAR], np.int32), np.array([STAR], np.int32),
                 np.zeros(0, np.int32)]
    tmpl, tlens = ops.pack_templates(templates)
    line_bucket, _, _, _ = ops.bucket_tables(logs, tmpl, tlens)
    assert (line_bucket == -1).all()
    np.testing.assert_array_equal(ops.match_first_bucketed(logs, lens, templates, device="cpu"),
                                  [-1] * 4)
    np.testing.assert_array_equal(_plain_through_tables(logs, lens, templates), [-1] * 4)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 40), st.integers(1, 12), st.integers(0, 30), st.integers(2, 5),
       st.integers(0, 2**32 - 1))
def test_random_grids_equal_reference(n, t, k, vocab, seed):
    rng = np.random.default_rng(seed)
    logs, lens, templates = _case(rng, n, t, k, vocab=vocab)
    if k and rng.random() < 0.3:
        templates[int(rng.integers(0, k))] = np.zeros(0, np.int32)
    got = ops.match_first_bucketed(logs, lens, templates, device="cpu")
    want = ref_match_first(logs, lens, templates, use_kernel=False) if n and k \
        else np.full(n, -1, np.int32)
    np.testing.assert_array_equal(got, want)
    if n and k:
        np.testing.assert_array_equal(_plain_through_tables(logs, lens, templates), want)
        np.testing.assert_array_equal(got, rops.match_first_bucketed(logs, lens, templates))


def test_bucket_tables():
    templates = [np.array(a, np.int32) for a in (
        [5, 1], [1, 3], [3], [], [5, 2, 1], [1], [3, 3], [9])]
    tmpl, tlens = ops.pack_templates(templates)
    logs = np.array([[5, 2], [3, 0], [4, 4], [9, 9], [1, 1], [0, 0]], np.int32)
    line_bucket, ptr, tpl, star = ops.bucket_tables(logs, tmpl, tlens)
    assert all(a.dtype == np.int32 for a in (line_bucket, ptr, tpl, star))
    # buckets keyed 3, 5, 9 in that order; the empty template (3) nowhere
    np.testing.assert_array_equal(ptr, [0, 2, 4, 5])
    np.testing.assert_array_equal(tpl, [2, 6, 0, 4, 7])
    np.testing.assert_array_equal(star, [1, 5])
    np.testing.assert_array_equal(line_bucket, [1, 0, -1, 2, -1, -1])
    for b in range(len(ptr) - 1):
        ids = tpl[ptr[b]:ptr[b + 1]]
        assert (np.diff(ids) > 0).all()
        assert len({int(templates[i][0]) for i in ids}) == 1


def test_cpu_call_launches_nothing():
    ops.reset_launch_counts()
    logs, lens, templates = _group_case()
    ops.match_first_bucketed(logs, lens, templates, device="cpu")
    match_first(logs, lens, templates, use_kernel=True, device="cpu")
    assert not any(ops.launch_counts().values())


def test_input_hook_sees_one_first_hit_call_per_match_first(monkeypatch):
    """``match_first`` reaches the first-hit wrapper once a call (after its
    dedup), with every line and template in one set of tensors, and
    never the (N, K) wrapper."""
    seen = []
    rng = np.random.default_rng(6)
    logs, lens, templates = _case(rng, 300, 10, 50)
    logs = np.concatenate([logs, logs])  # duplicate rows: dedup runs first
    lens = np.concatenate([lens, lens])
    want = match_first(logs, lens, templates, use_kernel=True, device="cpu")
    monkeypatch.setattr(ops, "input_hook", lambda name, args: seen.append((name, args)))
    np.testing.assert_array_equal(
        match_first(logs, lens, templates, use_kernel=True, device="cpu"), want)
    assert [name for name, _ in seen] == ["wildcard_match_first"]
    args = seen[0][1]
    assert len(args) == 8 and all(a.dtype == torch.int32 for a in args)
    assert args[0].shape[1] == 10 and args[2].shape[0] == len(templates)
    assert args[0].shape[0] == len(np.unique(np.column_stack([lens, logs]), axis=0))
    assert torch.equal(wm.wildcard_match_first(*args), wm.wildcard_match_first_plain(*args))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    logs, lens, templates = _group_case()
    tmpl, tlens = ops.pack_templates(templates)
    args = [_t(a) for a in (logs, lens, tmpl, tlens, *ops.bucket_tables(logs, tmpl, tlens))]
    with pytest.raises(TypeError):
        wm.wildcard_match_first(*args[:4], args[4].long(), *args[5:])
    with pytest.raises(ValueError):
        wm.wildcard_match_first(*args[:4], args[4][:-1], *args[5:])
    with pytest.raises(ValueError):
        wm.wildcard_match_first(*args[:5], args[5][:0], *args[6:])
    with pytest.raises(ValueError):
        wm.wildcard_match_first(*args[:7], args[7][None])
    with pytest.raises(ValueError):
        wm.wildcard_match_first(args[0][0], *args[1:])


@pytest.mark.cuda
def test_cuda_first_hit_launches_once_per_match_first():
    """On the card: one launch per ``match_first`` call, none of the
    (N, K) kernel, and the assignment of ``device="cpu"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    for logs, lens, templates in (_group_case(),
                                  _case(np.random.default_rng(1), 3000, 64, 300,
                                        long_stars=True)):
        ops.reset_launch_counts()
        got = match_first(logs, lens, templates, use_kernel=True, device="cuda")
        counts = ops.launch_counts()
        assert counts["wildcard_match_first"] == 1 and counts["wildcard_match"] == 0
        np.testing.assert_array_equal(
            got, match_first(logs, lens, templates, use_kernel=True, device="cpu"))
