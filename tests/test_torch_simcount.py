"""The port's φ kernel (``simcount``), its op and ``lcs_length`` against
the JAX package's, at small shapes.

The plain torch version (what a CPU tensor runs) must equal the Pallas
kernel in interpret mode and the JAX oracle with ``array_equal`` (int32
counts, tolerance 0), at shapes that straddle the Pallas tiles (BN=128,
BK=32, and T around the 32-position bitset word), and the host
``common_token_count`` the clustering calls. ``ops.simcount`` on
``device="cpu"`` must equal the reference's on loggen lines of the five
datasets against ISE templates. ``lcs_length`` must equal
``lcs_length_jax``. The CUDA kernel runs only on a card: its test is
marked ``cuda`` and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.lcs import lcs_length_jax
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.simcount import simcount as pallas_simcount
from repro_torch.core.ise import ISEConfig, iterative_structure_extraction
from repro_torch.core.lcs import common_token_count, lcs_length
from repro_torch.core.tokenizer import Vocab, tokenize
from repro_torch.data.loggen import DATASETS, generate_lines
from repro_torch.kernels import ops, ref
from repro_torch.kernels import simcount as sc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _case(rng, n, t, k, tt, vocab=9):
    """Token grids with PAD tails, STARs in both and repeated tokens."""
    logs = rng.integers(0, 2 + vocab, (n, t)).astype(np.int32)
    tmpl = rng.integers(0, 2 + vocab, (k, tt)).astype(np.int32)
    for r, ln in enumerate(rng.integers(0, t + 1, n)):
        logs[r, ln:] = 0
    if n:
        logs[0] = 0  # an all-PAD line
    return logs, tmpl


def _host_phi(logs, tmpl):
    return np.stack([common_token_count(row, tmpl) for row in logs]) if len(logs) \
        else np.zeros((0, tmpl.shape[0]), np.int32)


@pytest.mark.parametrize("n,t,k,tt", [
    (127, 31, 31, 5), (128, 32, 32, 7), (129, 33, 33, 9), (130, 31, 65, 33),
    (1, 1, 1, 1), (5, 40, 2, 70), (0, 4, 3, 2), (5, 4, 0, 2),
])
def test_simcount_equals_pallas(n, t, k, tt):
    rng = np.random.default_rng(n * 31 + t + k)
    logs, tmpl = _case(rng, n, t, k, tt)
    got = ref.simcount_ref(_t(logs), _t(tmpl))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, k)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(rref.simcount_ref(jnp.asarray(logs),
                                                                    jnp.asarray(tmpl))))
    if n and k:
        np.testing.assert_array_equal(got, np.asarray(pallas_simcount(
            jnp.asarray(logs), jnp.asarray(tmpl), interpret=True)))
    if k:
        np.testing.assert_array_equal(got, _host_phi(logs, tmpl))


def test_simcount_plain_row_blocks(monkeypatch):
    rng = np.random.default_rng(4)
    logs, tmpl = _case(rng, 200, 17, 9, 6)
    whole = sc.simcount_plain(_t(logs), _t(tmpl))
    monkeypatch.setattr(sc, "_PLAIN_TILE", 5 * 9 * 17)
    assert torch.equal(sc.simcount_plain(_t(logs), _t(tmpl)), whole)


def _grid_and_templates(name, n=300, max_len=24):
    v = Vocab()
    lines = generate_lines(name, n, seed=9)
    ids, lens = v.encode_batch([tokenize(line.split(": ", 1)[-1])[0] for line in lines],
                               max_len)
    res = iterative_structure_extraction(ids, lens, vocab_size=len(v),
                                         cfg=ISEConfig(min_sample=100), device="cpu")
    return ids, lens, res.templates


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_ops_simcount_equals_reference(name):
    ids, _, templates = _grid_and_templates(name)
    tm, _ = ops.pack_templates(templates)
    got = ops.simcount(ids, tm, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(ids), len(templates))
    np.testing.assert_array_equal(got, np.asarray(rops.simcount(ids, tm)))
    np.testing.assert_array_equal(got, _host_phi(ids, tm))
    # each line's own template holds its literal tokens
    assert (got.max(axis=1) > 0).mean() > 0.9


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=10),
       st.lists(st.integers(0, 6), min_size=1, max_size=10))
def test_lcs_length_equals_reference(a, b):
    a = np.array(a, np.int32)
    b = np.array(b, np.int32)
    got = lcs_length(a, b)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(lcs_length_jax(jnp.asarray(a), jnp.asarray(b)))
    # φ bounds the true LCS from above: every token of a common subsequence
    # is a valid token of the line present in the template
    phi = ops.simcount(a[None, :], b[None, :], device="cpu")[0, 0]
    assert int(got) <= phi


def test_lcs_length_edges():
    assert int(lcs_length(np.array([2, 3], np.int32), np.zeros(0, np.int32))) == 0
    assert int(lcs_length(np.array([1, 0, 2], np.int32), np.array([1, 2, 0], np.int32))) == 1
    assert int(lcs_length(np.array([2, 3, 4, 5]), np.array([5, 2, 4, 3, 5]))) == 3


def test_simcount_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        sc.simcount(a.long(), a)
    with pytest.raises(ValueError):
        sc.simcount(a[0], a)


@pytest.mark.cuda
def test_cuda_simcount_equals_plain_version():
    """The CUDA kernel equals its plain version on the card (the
    chip_smoke.py check, at test size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(0)
    for n, t, k, tt in [(300, 31, 33, 7), (1000, 128, 17, 128), (77, 33, 0, 4), (9, 1, 5, 400)]:
        logs, tmpl = (_t(a).cuda() for a in _case(rng, n, t, k, tt))
        assert torch.equal(sc.simcount(logs, tmpl), sc.simcount_plain(logs, tmpl))
