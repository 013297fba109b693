"""The port's fused match + span kernel (``match_extract``), its op, the
prefix tree and the kernel benchmark against the JAX package's.

The plain torch version (what a CPU tensor runs) must equal the Pallas
kernel in interpret mode with ``array_equal`` (int32, tolerance 0):
``assign`` in full and ``spans`` on the rows a template took, at row
counts that straddle the Pallas tile (BN=64) and on the edge cases of the
reference's own tests. ``ops.match_extract``, ``PrefixTree`` and the
host matcher on ``device="cpu"`` must equal the reference's on loggen
lines of the five datasets. One deliberate divergence is pinned: the
port's spans are 0 on every row with ``assign == -1``, where the
reference's op leaves what its padded kernel wrote. The CUDA kernel runs
only on a card: its test is marked ``cuda`` and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.trie import PrefixTree as RPrefixTree
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.match_extract import match_extract as pallas_match_extract
from repro_torch.benchmarks import kernel_bench
from repro_torch.core.ise import ISEConfig, iterative_structure_extraction
from repro_torch.core.match import extract_spans, extract_spans_dp, match_first
from repro_torch.core.tokenizer import Vocab, tokenize
from repro_torch.core.trie import PrefixTree
from repro_torch.data.loggen import DATASETS, generate_lines
from repro_torch.kernels import match_extract as me
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _case(rng, n, t, k, tt, star_rate=0.4):
    """Random grids with over-length and negative lengths, and templates
    of 0..tt tokens; a third of the lines are planted matches."""
    logs = rng.integers(2, 8, (n, t)).astype(np.int32)
    lens = rng.integers(-1, t + 3, n).astype(np.int32)
    for r in range(n):
        logs[r, max(0, min(int(lens[r]), t)):] = 0
    tpls = []
    for _ in range(k):
        m = int(rng.integers(0, tt + 1))
        tp = rng.integers(2, 8, m).astype(np.int32)
        tp[rng.random(m) < star_rate] = 1
        tpls.append(tp)
    for r in range(0, n, 3):
        row = []
        for tok in tpls[r % k]:
            row += rng.integers(2, 8, int(rng.integers(1, 3))).tolist() if tok == 1 \
                else [int(tok)]
        if len(row) <= t:
            logs[r] = 0
            logs[r, :len(row)] = row
            lens[r] = len(row)
    return logs, lens, tpls


def _n_slots(tpls):
    return max([1] + [int((tp == 1).sum()) for tp in tpls])


def _kernel_vs_pallas(logs, lens, tpls):
    tmpl, tlens = ops.pack_templates(tpls)
    n_slots = _n_slots(tpls)
    assign, spans = (x.numpy() for x in me.match_extract(
        _t(logs), _t(lens), _t(tmpl), _t(tlens), n_slots))
    p_assign, p_spans = (np.asarray(x) for x in pallas_match_extract(
        jnp.asarray(logs), jnp.asarray(lens), jnp.asarray(tmpl), jnp.asarray(tlens),
        n_slots=n_slots, interpret=True))
    np.testing.assert_array_equal(assign, p_assign)
    hit = assign >= 0
    np.testing.assert_array_equal(spans[hit], p_spans[hit])
    assert not spans[~hit].any()
    r_assign, r_spans = ref.match_extract_ref(logs, np.minimum(lens, logs.shape[1]), tmpl,
                                              tlens, n_slots)
    np.testing.assert_array_equal(assign[lens >= 0], r_assign[lens >= 0])
    np.testing.assert_array_equal(spans[hit], r_spans[hit])
    return assign


@pytest.mark.parametrize("n", [63, 64, 65])
@pytest.mark.parametrize("t,k,tt", [(9, 6, 6), (33, 4, 9)])
def test_match_extract_equals_pallas(n, t, k, tt):
    rng = np.random.default_rng(n * 13 + t)
    logs, lens, tpls = _case(rng, n, t, k, tt)
    assign = _kernel_vs_pallas(logs, lens, tpls)
    assert (assign >= 0).any(), "planted matches must register"


def test_match_extract_edges():
    """The reference's edge cases: a zero-length template matches only
    ``len == 0``, all-star templates, lowest id wins."""
    logs = np.array([[2, 3, 4, 0], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([3, 1, 0], np.int32)
    tpls = [np.zeros(0, np.int32), np.array([1, 1, 1], np.int32), np.array([1], np.int32)]
    assert _kernel_vs_pallas(logs, lens, tpls).tolist() == [1, 2, 0]
    assign, spans = ops.match_extract(logs, lens, tpls, device="cpu")
    assert assign.tolist() == [1, 2, 0]
    assert spans[0].tolist() == [[0, 1], [1, 2], [2, 3]] and spans[1].tolist() == \
        [[0, 1], [0, 0], [0, 0]]


def test_match_extract_overlength_template_sentinel():
    rng = np.random.default_rng(5)
    logs, lens, _ = _case(rng, 40, 6, 1, 1)
    tmpl, tlens = ops.pack_templates([np.array([2, 3, 4, 5, 6], np.int32)], t_max=3)
    assert tlens.tolist() == [-1]
    assign, spans = me.match_extract(_t(logs), _t(lens), _t(tmpl), _t(tlens), 1)
    assert (assign.numpy() == -1).all() and not spans.any()


def test_spans_are_zero_where_nothing_matched():
    """A line longer than the grid never matches, and its spans are 0.
    The reference's op returns the same ``assign`` but keeps the spans its
    pow-2 padded kernel wrote for the row ([[1, 5]] here); its oracle
    gives 0, as the port does."""
    logs = np.array([[2, 3, 4]], np.int32)
    lens = np.array([5], np.int32)
    tpls = [np.array([2, 1], np.int32)]
    assign, spans = ops.match_extract(logs, lens, tpls, device="cpu")
    assert assign.tolist() == [-1] and spans.tolist() == [[[0, 0]]]
    r_assign, _ = rops.match_extract(logs, lens, tpls)
    np.testing.assert_array_equal(assign, r_assign)
    tmpl, tlens = ops.pack_templates(tpls)
    r_assign, r_spans = rref.match_extract_ref(logs, lens, tmpl, tlens, 1)
    np.testing.assert_array_equal(assign, r_assign)
    np.testing.assert_array_equal(spans, r_spans)


@pytest.mark.parametrize("seed", range(6))
def test_ops_match_extract_equals_reference_random(seed):
    rng = np.random.default_rng(seed)
    logs, lens, tpls = _case(rng, 120, 10, 6, 6, star_rate=0.5)
    assign, spans = ops.match_extract(logs, lens, tpls, device="cpu")
    r_assign, r_spans = rops.match_extract(logs, lens, tpls)
    np.testing.assert_array_equal(assign, r_assign)
    hit = assign >= 0
    np.testing.assert_array_equal(spans[hit], r_spans[hit])
    assert not spans[~hit].any()
    assert not hit[lens > logs.shape[1]].any()


def _grid_and_templates(name, n=300, max_len=24):
    v = Vocab()
    lines = generate_lines(name, n, seed=13)
    ids, lens = v.encode_batch([tokenize(line.split(": ", 1)[-1])[0] for line in lines],
                               max_len, tight=True)
    res = iterative_structure_extraction(ids, lens, vocab_size=len(v),
                                         cfg=ISEConfig(min_sample=100), device="cpu")
    return ids, lens, res.templates


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_ops_match_extract_equals_reference_loggen(name):
    ids, lens, templates = _grid_and_templates(name)
    assign, spans = ops.match_extract(ids, lens, templates, device="cpu")
    r_assign, r_spans = rops.match_extract(ids, lens, templates)
    np.testing.assert_array_equal(assign, r_assign)
    hit = assign >= 0
    np.testing.assert_array_equal(spans[hit], r_spans[hit])
    assert hit.mean() > 0.5
    # the host matcher and span extraction agree with the fused op
    np.testing.assert_array_equal(assign, match_first(ids, lens, templates, use_kernel=False))
    for g in sorted(set(assign[hit].tolist())):
        rows = np.flatnonzero(assign == g)
        sp = extract_spans(ids[rows], lens[rows], templates[g])
        np.testing.assert_array_equal(spans[rows, : sp.shape[1]], sp)
        np.testing.assert_array_equal(sp, extract_spans_dp(ids[rows], lens[rows], templates[g]))
        assert not spans[rows, sp.shape[1]:].any()


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_prefix_tree_equals_reference(name):
    ids, lens, templates = _grid_and_templates(name)
    tree, rtree = PrefixTree(), RPrefixTree()
    for i, tp in enumerate(templates):
        tree.insert(tp, i)
        rtree.insert(tp, i)
    got, got_spans = tree.match_batch(ids, lens)
    want, want_spans = rtree.match_batch(ids, lens)
    np.testing.assert_array_equal(got, want)
    assert got_spans == want_spans
    # the trie matches exactly the lines some template matches
    assign = match_first(ids, lens, templates, use_kernel=False)
    np.testing.assert_array_equal(got >= 0, assign >= 0)


def test_launch_counts_have_five_kernels_and_cpu_leaves_them_at_zero():
    ops.reset_launch_counts()
    ids, lens, templates = _grid_and_templates("HDFS", n=120)
    ops.match_extract(ids, lens, templates, device="cpu")
    ops.simcount(ids, ops.pack_templates(templates)[0], device="cpu")
    ops.device_encode_batch(["a b", "c"], Vocab(), 4, device="cpu")
    ops.distinct_counts(np.array([0, 1, 1], np.int32), 2, device="cpu")
    assert ops.launch_counts() == {"wildcard_match": 0, "colcodec_transform": 0,
                                   "tokenize_hash": 0, "simcount": 0, "match_extract": 0,
                                   "distinct_counts": 0}


def test_kernel_bench_runs_on_cpu():
    """The slice's path end to end at small size: every row present, the
    bench's own asserts hold, nothing launched."""
    ops.reset_launch_counts()
    rows = kernel_bench.run(n_lines=2000, device="cpu")
    impls = [r["impl"] for r in rows]
    assert impls == [
        "trie (python)", "DP matcher (numpy)", "wildcard_match (plain torch, cpu)",
        "simcount (plain torch, cpu)", "tokenize_batch (host numpy)",
        "tokenize_hash (plain torch, cpu)", "match+extract (host fused anchors)",
        "match_extract (plain torch, cpu)"]
    assert all(r["lines_per_s"] > 0 for r in rows)
    assert not any(ops.launch_counts().values())


def test_match_extract_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.int32)
    k = torch.zeros((2, 5), dtype=torch.int32)
    kl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        me.match_extract(a.long(), v, k, kl, 1)
    with pytest.raises(ValueError):
        me.match_extract(a, v[:3], k, kl, 1)
    with pytest.raises(ValueError):
        me.match_extract(a, v, k, kl, 0)


@pytest.mark.cuda
def test_cuda_match_extract_equals_plain_version():
    """The CUDA kernel equals its plain version on the card (the
    chip_smoke.py check, at test size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(0)
    for n, t, k, tt in [(300, 12, 9, 7), (500, 128, 7, 129), (77, 31, 5, 40), (5, 3, 0, 1)]:
        logs, lens, tpls = _case(rng, n, t, max(k, 1), tt)
        tmpl, tlens = ops.pack_templates(tpls[:k], t_max=tt)
        args = [_t(a).cuda() for a in (logs, lens, tmpl, tlens)]
        got = me.match_extract(*args, _n_slots(tpls))
        want = me.match_extract_plain(*args, _n_slots(tpls))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
