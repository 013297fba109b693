"""The port's kernels against the JAX package's, at small shapes.

For each ported kernel the plain torch version (what a CPU tensor runs)
must equal, with ``array_equal`` (integer outputs, tolerance 0), the JAX
oracle in ``repro.kernels.ref``, the numpy twin in ``repro.kernels.ops``
and the Pallas kernel in interpret mode, at shapes that straddle the
Pallas tiles (BN=256 / BK=8 for the matcher, RN=8 for the column
transform). The numpy in/out ops of the port (``device="cpu"``) must
equal the reference's, masking rules included. The CUDA kernels
themselves run only on a card: their test is marked ``cuda`` and skips
elsewhere.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.match import match_first as ref_match_first
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.colcodec import colcodec_transform as pallas_colcodec
from repro.kernels.wildcard_match import wildcard_match as pallas_wildcard_match
from repro_torch.core.match import match_first
from repro_torch.kernels import build, ops
from repro_torch.kernels import colcodec as cc
from repro_torch.kernels import ref
from repro_torch.kernels import wildcard_match as wm

KERNELS_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _rand_case(rng, n, t, k, tt, star_rate=0.25, vocab=22):
    logs = rng.integers(2, 2 + vocab, (n, t)).astype(np.int32)
    lens = rng.integers(0, t + 1, (n,)).astype(np.int32)
    for r in range(n):
        logs[r, lens[r]:] = 0
    tmpl = rng.integers(2, 2 + vocab, (k, tt)).astype(np.int32)
    tmpl[rng.random((k, tt)) < star_rate] = 1
    tlens = rng.integers(1, tt + 1, (k,)).astype(np.int32)
    for r in range(k):
        tmpl[r, tlens[r]:] = 0
    # plant matches: line r = template r with each star -> 1-3 tokens
    for r in range(min(n, k)):
        row = []
        for j in range(tlens[r]):
            tok = int(tmpl[r, j])
            row += [int(rng.integers(2, 2 + vocab))] * int(rng.integers(1, 4)) \
                if tok == 1 else [tok]
        if len(row) <= t:
            logs[r] = 0
            logs[r, :len(row)] = row
            lens[r] = len(row)
    return logs, lens, tmpl, tlens


def _edge_rows(rng, logs, lens, tmpl, tlens):
    """Lines longer than the grid, negative lengths and matches-nothing
    templates, as the pipeline's tight grid and pack_templates give."""
    n, t = logs.shape
    if n:
        lens[rng.random(n) < 0.1] = t + 2
        lens[0] = -1 if n > 3 else lens[0]
    if len(tlens) > 2:
        tlens[2] = -1
    return logs, lens, tmpl, tlens


# --------------------------------------------------------- wildcard_match

@pytest.mark.parametrize("n,t,k,tt", [
    (1, 1, 1, 1), (5, 6, 2, 4), (70, 12, 10, 6), (260, 24, 9, 10), (257, 33, 17, 12),
    (40, 65, 7, 70), (0, 4, 3, 2), (6, 4, 0, 2),
])
def test_wildcard_match_plain_equals_reference(n, t, k, tt):
    rng = np.random.default_rng(n * 131 + t)
    case = _edge_rows(rng, *_rand_case(rng, n, t, k, tt, vocab=4))
    got = ref.wildcard_match_ref(*[_t(a) for a in case]).numpy()
    assert got.shape == (n, k) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, np.asarray(rref.wildcard_match_ref(
        *[jnp.asarray(a) for a in case])))
    np.testing.assert_array_equal(got, rops._wildcard_match_np(*case))
    if n and k:
        pallas = np.asarray(pallas_wildcard_match(*[jnp.asarray(a) for a in case],
                                                  interpret=True)).astype(bool)
        np.testing.assert_array_equal(got, pallas)
    if n and k and t >= 6:
        assert got.any(), "planted matches must register"


def test_wildcard_match_plain_row_blocks(monkeypatch):
    """The plain version's row blocking (a small tile forces many blocks)
    gives the same matrix as one block."""
    rng = np.random.default_rng(5)
    case = [_t(a) for a in _edge_rows(rng, *_rand_case(rng, 300, 20, 11, 9, vocab=3))]
    whole = wm.wildcard_match_plain(*case)
    monkeypatch.setattr(wm, "_PLAIN_TILE", 7 * 11 * 21)
    assert torch.equal(wm.wildcard_match_plain(*case), whole)


@pytest.mark.parametrize("n,t,k,tt", [(5, 6, 2, 4), (70, 12, 10, 6), (300, 17, 20, 10)])
def test_ops_wildcard_match_equals_reference(n, t, k, tt):
    rng = np.random.default_rng(n + 7 * k)
    case = _edge_rows(rng, *_rand_case(rng, n, t, k, tt, vocab=3))
    got = ops.wildcard_match(*case, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(rops.wildcard_match(*case)))
    np.testing.assert_array_equal(got, np.asarray(rops.wildcard_match(*case, use_buckets=False)))
    assert not got[case[1] > t].any()  # lens > T never match


@pytest.mark.parametrize("t_max", [None, 3, 5])
def test_pack_templates_equals_reference(t_max):
    rng = np.random.default_rng(3)
    templates = [rng.integers(1, 9, int(m)).astype(np.int32) for m in (1, 4, 2, 6, 3)]
    got = ops.pack_templates(templates, t_max)
    want = rops.pack_templates(templates, t_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if t_max is not None:
        assert (got[1][[len(tp) > t_max for tp in templates]] == -1).all()


def test_pack_templates_sentinel_matches_nothing():
    """An over-length template gets t_len=-1 and matches nothing, even a
    line that equals its prefix."""
    long_tpl = np.array([5, 6, 7, 8], np.int32)
    tmpl, tlens = ops.pack_templates([long_tpl, np.array([5, 1], np.int32)], t_max=3)
    assert list(tlens) == [-1, 2]
    logs = np.array([[5, 6, 7], [5, 9, 9]], np.int32)
    lens = np.array([3, 3], np.int32)
    got = ops.wildcard_match(logs, lens, tmpl, tlens, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(rops.wildcard_match(logs, lens, tmpl, tlens)))
    assert not got[:, 0].any() and got[:, 1].all()


@pytest.mark.parametrize("seed", range(4))
def test_match_first_bucketed_equals_reference(seed):
    rng = np.random.default_rng(seed)
    logs, lens, tmpl, tlens = _rand_case(rng, 150, 14, 12, 7, star_rate=0.35, vocab=3)
    lens[::17] = 15  # longer than the grid
    templates = [tmpl[i, : tlens[i]].copy() for i in range(len(tlens))]
    templates.append(np.zeros(0, np.int32))  # empty template: matches nothing
    got = ops.match_first_bucketed(logs, lens, templates, device="cpu")
    np.testing.assert_array_equal(got, rops.match_first_bucketed(logs, lens, templates))
    np.testing.assert_array_equal(
        match_first(logs, lens, templates, use_kernel=True, device="cpu"),
        ref_match_first(logs, lens, templates, use_kernel=False))
    np.testing.assert_array_equal(
        match_first(logs, lens, templates, use_kernel=False, device="cpu"), got)


# ----------------------------------------------------- colcodec_transform

def _col_case(rng, r, c, wide):
    lim = 1 << 31 if wide else 1 << 28
    vals = rng.integers(-lim + 1, lim, (r, c)).astype(np.int32)
    vals[:, ::4] = np.where(rng.random(vals[:, ::4].shape) < 0.5, lim - 1, -lim + 1)
    lens = rng.integers(0, c + 2, (r,)).astype(np.int32)
    mode = rng.integers(0, 4, (r,)).astype(np.int32)
    refv = rng.integers(-lim + 1, lim, (r,)).astype(np.int32)
    return vals, lens, mode, refv


@pytest.mark.parametrize("r,c", [(1, 1), (3, 5), (8, 128), (9, 130), (17, 300)])
@pytest.mark.parametrize("wide", [False, True])
def test_colcodec_plain_equals_reference(r, c, wide):
    rng = np.random.default_rng(r * 1000 + c + wide)
    case = _col_case(rng, r, c, wide)
    got = ref.colcodec_transform_ref(*[_t(a) for a in case])
    assert got.dtype == torch.uint32
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(rref.colcodec_transform_ref(*case)))
    np.testing.assert_array_equal(got, rops._colcodec_transform_host(*case))
    pallas = pallas_colcodec(*[jnp.asarray(a) for a in case], interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("r,c", [(1, 1), (1, 37), (4, 300), (9, 17)])
def test_delta_zigzag_equals_reference(r, c):
    rng = np.random.default_rng(r + c)
    vals, lens, _, _ = _col_case(rng, r, c, wide=False)
    mode = (np.arange(r) % 3 + 1).astype(np.int32)
    got = ops.delta_zigzag(vals, lens, mode, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(rops.delta_zigzag(vals, lens, mode)))
    np.testing.assert_array_equal(
        got, np.asarray(rops.delta_zigzag(vals, lens, mode, use_buckets=False)))
    assert ops.delta_zigzag(np.zeros((0, 3), np.int32), [], [], device="cpu").shape == (0, 3)


# ------------------------------------------------------- wrapper contract

def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.int32)
    k = torch.zeros((2, 5), dtype=torch.int32)
    kl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        wm.wildcard_match(a.long(), v, k, kl)
    with pytest.raises(ValueError):
        wm.wildcard_match(a, v[:3], k, kl)
    with pytest.raises(ValueError):
        wm.wildcard_match(a, v, k, kl[:1])
    with pytest.raises(ValueError):
        wm.wildcard_match(a[0], v, k, kl)
    with pytest.raises(TypeError):
        cc.colcodec_transform(a, v, v, v.long())
    with pytest.raises(ValueError):
        cc.colcodec_transform(a, v[:2], v, v)
    with pytest.raises(ValueError):
        cc.colcodec_transform(a[0], v, v, v)
    with pytest.raises(ValueError):
        ops.check_device("meta")


def test_cpu_tensors_launch_nothing():
    """Launch counts move only where a kernel is launched: the plain
    versions that CPU tensors run leave them at 0."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(1)
    logs, lens, tmpl, tlens = _rand_case(rng, 20, 6, 3, 4)
    ops.wildcard_match(logs, lens, tmpl, tlens, device="cpu")
    ops.delta_zigzag(logs, lens, np.ones(20, np.int32), device="cpu")
    assert ops.launch_counts() == {"wildcard_match": 0, "wildcard_match_first": 0,
                                   "colcodec_transform": 0, "tokenize_hash": 0, "simcount": 0,
                                   "match_extract": 0, "distinct_counts": 0}


def test_input_hook_sees_each_wrapper_call(monkeypatch):
    """``ops.input_hook`` gets the tensors each kernel wrapper is handed,
    and the result does not change with it set."""
    seen = []
    rng = np.random.default_rng(2)
    logs, lens, tmpl, tlens = _rand_case(rng, 20, 6, 3, 4)
    mode = np.ones(20, np.int32)
    want_m = ops.wildcard_match(logs, lens, tmpl, tlens, device="cpu")
    want_c = ops.delta_zigzag(logs, lens, mode, device="cpu")
    monkeypatch.setattr(ops, "input_hook", lambda name, args: seen.append((name, args)))
    np.testing.assert_array_equal(ops.wildcard_match(logs, lens, tmpl, tlens, device="cpu"),
                                  want_m)
    np.testing.assert_array_equal(ops.delta_zigzag(logs, lens, mode, device="cpu"), want_c)
    assert [name for name, _ in seen] == ["wildcard_match", "colcodec_transform"]
    m_args, c_args = seen[0][1], seen[1][1]
    np.testing.assert_array_equal(m_args[0].numpy(), logs)
    np.testing.assert_array_equal(m_args[3].numpy(), tlens)
    assert [tuple(a.shape) for a in c_args] == [(20, 6), (20,), (20,), (20,)]
    assert all(a.dtype == torch.int32 for a in (*m_args, *c_args))


def test_no_fallback_in_kernel_modules():
    """No try/except in the kernel layer: a build or launch failure on a
    CUDA tensor raises, it never turns into the plain path."""
    for path in sorted(KERNELS_DIR.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path.name


def test_build_hash_tracks_source_and_needs_nvcc(monkeypatch, tmp_path):
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    assert all(p.parent == build.BUILD_DIR for p in paths.values())
    src = tmp_path / "colcodec.cu"
    src.write_text("// edited\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("colcodec") != paths["colcodec"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["colcodec"])
    assert not (tmp_path / "build").exists()


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    """Each CUDA kernel equals its plain version on the card (the
    chip_smoke.py check, at test size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    rng = np.random.default_rng(0)
    for n, t, k, tt in [(300, 12, 9, 7), (1000, 128, 17, 128), (77, 31, 5, 40)]:
        case = [_t(a).cuda() for a in _edge_rows(rng, *_rand_case(rng, n, t, k, tt, vocab=4))]
        assert torch.equal(wm.wildcard_match(*case), wm.wildcard_match_plain(*case))
    for n, t, k, tt in [(300, 12, 40, 7), (500, 64, 90, 20), (77, 255, 70, 40)]:
        logs, lens, tmpl, tlens = _edge_rows(rng, *_rand_case(rng, n, t, k, tt, vocab=4))
        case = [_t(a).cuda() for a in (logs, lens, tmpl, tlens,
                                       *ops.bucket_tables(logs, tmpl, tlens))]
        assert torch.equal(wm.wildcard_match_first(*case), wm.wildcard_match_first_plain(*case))
    for r, c in [(1, 1), (9, 130), (2, 100_000)]:
        case = [_t(a).cuda() for a in _col_case(rng, r, c, wide=True)]
        assert torch.equal(cc.colcodec_transform(*case).to(torch.int64),
                           cc.colcodec_transform_plain(*case).to(torch.int64))
