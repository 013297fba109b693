"""The port's weighted-histogram kernel (``distinct_counts``) and its op
against the JAX package's, at small shapes.

The plain torch version (what a CPU tensor runs) must equal the Pallas
kernel in interpret mode, the JAX oracle ``ref.distinct_counts_ref`` and
the reference op on its kernel path (``prefer_host=False``) with
``array_equal`` (int32 counts, tolerance 0), at shapes that straddle the
Pallas kernel's 8-row tile and the op's 128-bin bucket, with -1 and
out-of-range rows, ``weights=None`` and int32 wraparound. The CUDA
kernel runs only on a card: its test is marked ``cuda`` and skips
elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.scan import distinct_counts as pallas_distinct_counts
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scan as sn

I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _case(rng, n, n_bins, wide=False):
    """inv with -1 and values >= n_bins; weights negative and, with
    ``wide``, near 2**31 so that the sums wrap."""
    inv = rng.integers(-1, n_bins + 3, n).astype(np.int32)
    if wide:
        w = rng.choice(np.array([I32.max, I32.max - 1, I32.min, -7, 3], np.int32), n)
    else:
        w = rng.integers(-5, 6, n).astype(np.int32)
    return inv, w


def _wrapped(inv, w, n_bins):
    """int64 sums of the rows in range, reduced to int32 bits."""
    acc = np.zeros(n_bins, np.int64)
    ok = (inv >= 0) & (inv < n_bins)
    np.add.at(acc, inv[ok].astype(np.int64), w[ok].astype(np.int64))
    return acc.astype(np.uint32).astype(np.int32)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n,n_bins", [
    (1, 1), (7, 127), (8, 128), (9, 129), (17, 3), (130, 300), (64, 1),
])
def test_distinct_counts_equals_pallas(n, n_bins, wide):
    rng = np.random.default_rng(n * 131 + n_bins + wide)
    inv, w = _case(rng, n, n_bins, wide)
    got = ref.distinct_counts_ref(_t(inv), _t(w), n_bins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_bins,)
    got = got.numpy()
    np.testing.assert_array_equal(got, _wrapped(inv, w, n_bins))
    np.testing.assert_array_equal(got, np.asarray(rref.distinct_counts_ref(
        jnp.asarray(inv), jnp.asarray(w), n_bins)))
    np.testing.assert_array_equal(got, np.asarray(pallas_distinct_counts(
        jnp.asarray(inv), jnp.asarray(w), n_bins=n_bins, interpret=True))[0])


# rows up to which the launcher runs one thread-block cluster (kSmallRows
# of csrc/distinct_counts.cu); one cooperative grid above
SMALL_ROWS = 16384
# (n, n_bins, every row in bin 0): an LZJS chunk's 8,192 rows, row counts
# on both sides of SMALL_ROWS, wrapping sums in one bin
LAUNCH_CASES = [(8192, 1, False), (8192, 2, False), (8192, 3999, False),
                (SMALL_ROWS - 1, 2, False), (SMALL_ROWS, 40, False), (SMALL_ROWS + 1, 40, False),
                (SMALL_ROWS + 5, 60_000, False), (4 * SMALL_ROWS + 3, 2, False),
                (8192, 5, True), (1_000_000, 5, True)]


def _launch_case(n, n_bins, one_bin):
    rng = np.random.default_rng(n + n_bins)
    if one_bin:
        return np.zeros(n, np.int32), np.full(n, I32.max - 2, np.int32)
    return _case(rng, n, n_bins, wide=True)


@pytest.mark.parametrize("n,n_bins,one_bin", LAUNCH_CASES)
def test_distinct_counts_launch_cases_equal_pallas(n, n_bins, one_bin):
    inv, w = _launch_case(n, n_bins, one_bin)
    got = sn.distinct_counts(_t(inv), _t(w), n_bins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_bins,)
    got = got.numpy()
    np.testing.assert_array_equal(got, _wrapped(inv, w, n_bins))
    np.testing.assert_array_equal(got, ref.distinct_counts_ref(_t(inv), _t(w), n_bins).numpy())
    np.testing.assert_array_equal(got, np.asarray(rref.distinct_counts_ref(
        jnp.asarray(inv), jnp.asarray(w), n_bins)))
    np.testing.assert_array_equal(got, np.asarray(pallas_distinct_counts(
        jnp.asarray(inv), jnp.asarray(w), n_bins=n_bins, interpret=True))[0])
    if one_bin:  # n * (2**31 - 3), wrapped to int32
        want = n * (int(I32.max) - 2) % 2**32
        assert int(got[0]) == want - (want >= 2**31) * 2**32 and not got[1:].any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,n_bins", [(1, 1), (9, 129), (255, 127), (257, 200), (0, 5), (4, 0)])
def test_ops_distinct_counts_equals_reference(n, n_bins, weighted):
    rng = np.random.default_rng(n + 7 * n_bins + weighted)
    inv, w = _case(rng, n, n_bins, wide=weighted)
    weights = w if weighted else None
    got = ops.distinct_counts(inv, n_bins, weights, device="cpu")
    assert got.dtype == np.int32 and got.shape == (n_bins,)
    np.testing.assert_array_equal(
        got, rops.distinct_counts(inv, n_bins, weights, prefer_host=False))
    np.testing.assert_array_equal(
        got, _wrapped(inv, w if weighted else np.ones(n, np.int32), n_bins))


def test_ops_distinct_counts_takes_int64_indexes():
    """Indexes beyond int32 add nothing (they must not wrap onto a bin)."""
    inv = np.array([0, 2, 2, 1, -1, 2, (1 << 32) + 1, -(1 << 32)], np.int64)
    got = ops.distinct_counts(inv, 3, device="cpu")
    assert got.tolist() == [1, 1, 3]
    np.testing.assert_array_equal(got, rops._distinct_counts_host(inv, np.ones(8, np.int32), 3))


@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.integers(-2, 40), st.integers(I32.min, I32.max)),
                max_size=60),
       st.integers(0, 40))
def test_distinct_counts_plain_property(rows, n_bins):
    inv = np.array([r[0] for r in rows], np.int32)
    w = np.array([r[1] for r in rows], np.int32)
    got = sn.distinct_counts(_t(inv), _t(w), n_bins).numpy()
    np.testing.assert_array_equal(got, rops._distinct_counts_host(inv, w, n_bins))
    np.testing.assert_array_equal(got, _wrapped(inv, w, n_bins))


def test_distinct_counts_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        sn.distinct_counts(a.long(), a, 3)
    with pytest.raises(ValueError):
        sn.distinct_counts(a, a[:3], 3)
    with pytest.raises(ValueError):
        sn.distinct_counts(a, a, -1)


@pytest.mark.cuda
def test_cuda_distinct_counts_equals_plain_version():
    """The CUDA kernel equals its plain version on the card, on both sides
    of the shared-memory limit and of the one-cluster row limit, with
    aligned and unaligned inputs (the chip_smoke.py check, at test size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(0)
    assert sn.small_rows() == SMALL_ROWS
    cases = [(_case(rng, n, n_bins, wide=True), n_bins) for n, n_bins in
             [(1, 1), (4097, 129), (9, 12_289), (5000, 60_000), (0, 4), (3, 0)]]
    cases += [(_launch_case(n, n_bins, one), n_bins) for n, n_bins, one in LAUNCH_CASES]
    for arrs, n_bins in cases:
        inv, w = (_t(a).cuda() for a in arrs)
        assert torch.equal(sn.distinct_counts(inv, w, n_bins),
                           sn.distinct_counts_plain(inv, w, n_bins))
        # one row past a 16-byte boundary: the kernel's 4-byte loads
        inv1, w1 = (torch.zeros(x.numel() + 1, dtype=torch.int32, device="cuda")[1:].copy_(x)
                    for x in (inv, w))
        assert torch.equal(sn.distinct_counts(inv1, w1, n_bins),
                           sn.distinct_counts_plain(inv1, w1, n_bins))
