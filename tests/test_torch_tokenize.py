"""The port's byte tokenizer (``tokenize_hash``) and its ops against the
JAX package's, at small shapes.

The plain torch version (what a CPU tensor runs) must equal the Pallas
kernel in interpret mode and the JAX oracle in all four outputs, with
``array_equal`` (integer outputs, tolerance 0), at row counts and widths
that straddle the Pallas tile (BN=256). ``device_tokenize`` and
``device_encode_batch`` on ``device="cpu"`` must equal the reference's on
loggen lines of the five datasets: tokens, delimiters, ids, lengths and
the vocabulary. The CUDA kernel runs only on a card: its test is marked
``cuda`` and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.tokenizer import Vocab as RVocab
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import tokenize as rtk
from repro_torch.core.tokenizer import Vocab, reassemble, tokenize
from repro_torch.data.loggen import DATASETS, generate_lines
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tokenize as tk

DELIMS = tuple(ord(c) for c in ops.DEFAULT_DELIMITERS)
DELIM_HEAVY = [
    "", " ", ",,,;;;===", "a b,c;;x==1:  y", " lead", "trail ",
    "=a=b=c=", "::::", "x\ty\tz", "a" * 90 + ",b", "one", "* a *",
]


def _grid(rng, n, width):
    """Random bytes, a third of them delimiters, with lengths from 0 to
    past the width."""
    other = np.array([b for b in [*range(33, 127), 0xC3, 0xA9, 0xFF] if b not in DELIMS],
                     np.uint8)
    blocks = np.where(rng.random((n, width)) < 1 / 3,
                      rng.choice(np.array(DELIMS, np.uint8), size=(n, width)),
                      rng.choice(other, size=(n, width))).astype(np.uint8)
    lens = rng.integers(0, width + 3, n).astype(np.int32)
    for r in range(n):
        blocks[r, min(int(lens[r]), width):] = 0
    return blocks, lens


def _torch_args(blocks, lens, pws):
    return (torch.from_numpy(blocks), torch.from_numpy(lens),
            torch.from_numpy(pws[0][0]), torch.from_numpy(pws[1][0]))


@pytest.mark.parametrize("width", [1, 64, 65])
@pytest.mark.parametrize("n", [1, 255, 256, 257])
def test_tokenize_hash_equals_pallas(n, width):
    rng = np.random.default_rng(n * 7 + width)
    blocks, lens = _grid(rng, n, width)
    pws = tk.hash_powers(width)
    got = [o.numpy() for o in tk.tokenize_hash(*_torch_args(blocks, lens, pws), DELIMS)]
    assert [g.dtype for g in got] == [np.int8, np.int8, np.uint32, np.uint32]
    want = rtk.tokenize_hash(jnp.asarray(blocks), jnp.asarray(lens), jnp.asarray(pws[0][0]),
                             jnp.asarray(pws[1][0]), delims=DELIMS, interpret=True)
    for g, w, name in zip(got, want, ["mask", "starts", "pref1", "pref2"]):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_tokenize_hash_ref_equals_reference():
    blocks, blens, _ = ops.pack_lines(DELIM_HEAVY + ["blk_%d x" % i for i in range(300)])
    pws = tk.hash_powers(blocks.shape[1])
    got = ref.tokenize_hash_ref(*_torch_args(blocks, blens, pws), DELIMS)
    want = rref.tokenize_hash_ref(blocks, blens, pws[0][0], pws[1][0], DELIMS)
    for g, w, name in zip(got, want, ["mask", "starts", "pref1", "pref2"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("b", [1, 2, 7, 64, 300])
def test_hash_powers_equal_reference(b):
    for (pw, ipw), (rpw, ripw) in zip(tk.hash_powers(b), rtk.hash_powers(b)):
        np.testing.assert_array_equal(pw, rpw)
        np.testing.assert_array_equal(ipw, ripw)
        assert ((pw.astype(np.uint64) * ipw) & 0xFFFFFFFF == 1).all()


def test_pack_lines_pads_every_row():
    blocks, blens, enc = ops.pack_lines(DELIM_HEAVY)
    assert blocks.shape == (len(DELIM_HEAVY), max(len(e) for e in enc) + 1)
    assert (blocks[np.arange(len(enc)), blens] == 0).all()  # a trailing pad byte per row
    rblocks, rblens, renc = rops.pack_lines(DELIM_HEAVY, use_buckets=False)
    np.testing.assert_array_equal(blocks, rblocks)
    np.testing.assert_array_equal(blens, rblens)
    assert enc == renc


def _contents(name, n=200, seed=5):
    return [line.split(": ", 1)[-1] for line in generate_lines(name, n, seed=seed)]


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_device_tokenize_equals_reference(name):
    lines = _contents(name) + DELIM_HEAVY
    got = ops.device_tokenize(lines, device="cpu")
    assert got == rops.device_tokenize(lines)
    for line, (toks, delims) in zip(lines, got):
        assert reassemble(toks, delims) == line
        assert (toks, delims) == tokenize(line)


@pytest.mark.parametrize("name", sorted(DATASETS))
@pytest.mark.parametrize("max_len", [8, 48])
def test_device_encode_batch_equals_reference(name, max_len):
    contents = _contents(name) + DELIM_HEAVY + ["a b c", "* star", "blk_1 blk_2 blk_1"]
    v, rv, hv = Vocab(), RVocab(), Vocab()
    ids, lens = ops.device_encode_batch(contents, v, max_len, device="cpu")
    rids, rlens = rops.device_encode_batch(contents, rv, max_len)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(lens, rlens)
    assert v._to_str == rv._to_str
    hids, hlens = hv.encode_batch([tokenize(c)[0] for c in contents], max_len, tight=True)
    np.testing.assert_array_equal(ids, hids)
    np.testing.assert_array_equal(lens, hlens)
    assert v._to_str == hv._to_str


def test_device_encode_batch_loose_width_and_empty():
    contents = ["a b", "c"]
    ids, lens = ops.device_encode_batch(contents, Vocab(), 6, tight=False, device="cpu")
    rids, rlens = rops.device_encode_batch(contents, RVocab(), 6, tight=False)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(lens, rlens)
    ids, lens = ops.device_encode_batch([], Vocab(), 6, device="cpu")
    assert ids.shape == (0, 1) and lens.shape == (0,)
    assert ops.device_tokenize([], device="cpu") == []


@settings(max_examples=40, deadline=None)
@given(st.lists(st.text(alphabet=" ,;:=abXY\t", max_size=20), min_size=1, max_size=8))
def test_device_tokenizer_roundtrips(lines):
    for line, (toks, delims) in zip(lines, ops.device_tokenize(lines, device="cpu")):
        assert reassemble(toks, delims) == line


def test_tokenize_hash_rejects_what_the_kernel_does_not_take():
    b = torch.zeros((3, 4), dtype=torch.uint8)
    ln = torch.zeros(3, dtype=torch.int32)
    pw = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(TypeError):
        tk.tokenize_hash(b.to(torch.int32), ln, pw, pw, DELIMS)
    with pytest.raises(ValueError):
        tk.tokenize_hash(b, ln[:2], pw, pw, DELIMS)
    with pytest.raises(ValueError):
        tk.tokenize_hash(b, ln, pw[:3], pw, DELIMS)
    with pytest.raises(ValueError):
        tk.tokenize_hash(b, ln, pw, pw, (300,))


@pytest.mark.parametrize("n,width", [(33, 61), (29, 70), (17, 125), (9, 127), (7, 300),
                                     (3, 1001), (2, 2033), (2, 2034), (2, 4097), (1, 6000)])
def test_tokenize_hash_equals_pallas_at_tile_edges(n, width):
    """Widths at the CUDA kernel's tiling edges, as on the card: tiles of
    whole rows that are and are not 16-byte multiples, a row that just
    fits a 2,048-byte chunk with its lead, rows that take two and three
    chunks."""
    rng = np.random.default_rng(n * 7 + width)
    blocks, lens = _grid(rng, n, width)
    pws = tk.hash_powers(width)
    got = tk.tokenize_hash(*_torch_args(blocks, lens, pws), DELIMS)
    want = rtk.tokenize_hash(jnp.asarray(blocks), jnp.asarray(lens), jnp.asarray(pws[0][0]),
                             jnp.asarray(pws[1][0]), delims=DELIMS, interpret=True)
    for g, w, name in zip(got, want, ["mask", "starts", "pref1", "pref2"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.cuda
def test_cuda_tokenize_hash_equals_plain_version():
    """The CUDA kernel equals its plain version on the card (the
    chip_smoke.py check, at test size): widths whose tiles are and are not
    16-byte multiples, a row that just fits a chunk, rows walked in two
    and three chunks, row counts that leave a partial last tile, and the
    input 3 bytes past a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(0)
    for n, width in [(1, 1), (300, 63), (300, 64), (77, 65), (301, 125), (45, 300), (7, 1001),
                     (5, 2033), (5, 2034), (9, 4097), (3, 6000)]:
        blocks, lens = _grid(rng, n, width)
        args = [a.cuda() for a in _torch_args(blocks, lens, tk.hash_powers(width))]
        shifted = torch.zeros(n * width + 3, dtype=torch.uint8, device="cuda")[3:]
        shifted = shifted.view(n, width).copy_(args[0])
        for a in (args, [shifted] + args[1:]):
            got = tk.tokenize_hash(*a, DELIMS)
            want = tk.tokenize_hash_plain(*a, DELIMS)
            for g, w in zip(got, want):
                assert torch.equal(g.to(torch.int64), w.to(torch.int64))
