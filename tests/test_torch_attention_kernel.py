"""The fused attention kernel (``repro_torch.kernels.attention``) against
the plain version ``models.layers._attention`` on the same inputs.

The kernels are CUDA C++ and run only on a card, so their tests are
marked ``cuda`` and skip elsewhere. fp32 inputs: the kernel's output and
gradients within ``FP32_REL`` of the plain version's (the same bound as
``test_torch_models.py::test_attention``; products in true fp32 on both
sides, TF32 off). bf16 inputs: the kernel rounds P and dS to bf16 for
their products where the plain version computes in fp32 throughout, so
each of its errors against a float64 computation may be at most
``BF16_ERR_RATIO`` times the plain version's on the same bf16 inputs
(the plain version's own error is its single rounding to bf16; one more
rounding of the same size, independent of it, makes ~1.4 times that).
The CPU tests need no card: CPU tensors take the plain version and
launch nothing. The card has no JAX: the plain version is held to the
JAX package's attention, o and gradients, on the CPU
(``test_torch_models.py::test_attention_and_its_gradients_at_the_kernels_cases``).
"""

import itertools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import attention as fa
from repro_torch.models import init_params, layers
from repro_torch.models.transformer import loss_fn

FP32_REL = 1e-5
BF16_ERR_RATIO = 2.0

H = 8
SHAPES = [(256, 256), (100, 1500)]  # Sq = Sk; Sq != Sk with whisper's ragged 1,500 frames
CASES = list(itertools.product((True, False), SHAPES, (H, H // 2, H // 8), (32, 64, 128),
                               (False, True)))


def _id(case):
    causal, (sq, sk), kv, hd, lens = case
    return f"{'causal' if causal else 'full'}-{sq}x{sk}-kv{kv}-hd{hd}-{'len' if lens else 'all'}"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(sq, sk, kv, hd, lens, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen) for shape in
               ((2, sq, H, hd), (2, sk, kv, hd), (2, sk, kv, hd)))
    do = torch.randn((2, sq, H, hd), generator=gen)
    # row 0 has every key masked: it averages v over all Sk keys
    kv_len = torch.tensor([0, sk * 2 // 3], dtype=torch.int32, device=dev) if lens else None
    return [t.to(dev, dtype) for t in (q, k, v, do)], kv_len


def _plain(q, k, v, kv_len, causal):
    rep = q.shape[2] // k.shape[2]
    return layers._attention(q, layers._repeat_kv(k, rep), layers._repeat_kv(v, rep), kv_len,
                             causal=causal, k_chunk=1024)


def _with_grads(fn, q, k, v, do):
    """fn(q, k, v) and the gradients of <fn(q, k, v), do> for q, k, v."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(do)
    return [out.detach(), q.grad, k.grad, v.grad]


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / (want.norm() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_kernel_equals_plain_version_in_fp32(card, case):
    causal, (sq, sk), kv, hd, lens = case
    assert not torch.backends.cuda.matmul.allow_tf32
    (q, k, v, do), kv_len = _inputs(sq, sk, kv, hd, lens, torch.float32, card)
    got = _with_grads(lambda *a: fa.flash_attention(*a, kv_len, causal=causal), q, k, v, do)
    want = _with_grads(lambda *a: _plain(*a, kv_len, causal), q, k, v, do)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) < FP32_REL, (name, _rel(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_kernel_error_in_bf16_within_twice_the_plain_versions(card, case):
    causal, (sq, sk), kv, hd, lens = case
    (q, k, v, do), kv_len = _inputs(sq, sk, kv, hd, lens, torch.bfloat16, card)
    exact = _with_grads(lambda *a: _dense(*a, kv_len, causal),
                        *(t.double() for t in (q, k, v, do)))
    got = _with_grads(lambda *a: fa.flash_attention(*a, kv_len, causal=causal), q, k, v, do)
    plain = _with_grads(lambda *a: _plain(*a, kv_len, causal), q, k, v, do)
    for name, g, p, e in zip(("o", "dq", "dk", "dv"), got, plain, exact):
        assert g.dtype == torch.bfloat16, name
        assert _err(g, e) <= BF16_ERR_RATIO * _err(p, e), (name, _err(g, e), _err(p, e))


def _dense(q, k, v, kv_len, causal):
    """Attention in one masked softmax, in the inputs' dtype (float64 here),
    masked scores at ``layers.NEG_INF`` as the plain version sets them."""
    rep = q.shape[2] // k.shape[2]
    k, v = layers._repeat_kv(k, rep), layers._repeat_kv(v, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    qpos = torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = torch.ones_like(s, dtype=torch.bool)
    if causal:
        keep = keep & (qpos >= kpos)
    if kv_len is not None:
        keep = keep & (kpos < kv_len[:, None, None, None])
    s = torch.where(keep, s, layers.NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.cuda
def test_backward_is_the_same_bits_on_every_run(card):
    (q, k, v, do), kv_len = _inputs(512, 512, H // 2, 128, False, torch.bfloat16, card, seed=3)
    runs = [_with_grads(lambda *a: fa.flash_attention(*a, causal=True), q, k, v, do)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_reduced_qwen3_runs_the_kernel_and_never_the_plain_version(card, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("layers._attention ran on a CUDA tensor")

    monkeypatch.setattr(layers, "_attention", plain)
    cfg = get_config("qwen3-1.7b").reduced()
    model = init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=card, dtype=torch.int32)
    fa.reset_launches()
    loss, _ = loss_fn(model, {"tokens": toks, "labels": toks})
    loss.backward()
    torch.cuda.synchronize()
    per_pass = cfg.n_layers * (2 if cfg.remat else 1)  # remat runs each block's forward again
    assert (fa.forward_launches(), fa.backward_launches()) == (per_pass, cfg.n_layers)
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
def test_head_dim_96_raises_on_the_card(card):
    q = torch.zeros((1, 16, 4, 96), device=card, dtype=torch.bfloat16)
    k = torch.zeros((1, 16, 2, 96), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        layers.attention(q, k, k, causal=True)


# ------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [H, H // 2, H // 8])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(causal, kv):
    (q, k, v, _), _ = _inputs(12, 12, kv, 32, False, torch.float32, "cpu")
    kv_len = torch.tensor([12, 7])
    fa.reset_launches()
    got = layers.attention(q, k, v, causal=causal, kv_len=kv_len)
    assert (fa.forward_launches(), fa.backward_launches()) == (0, 0)
    assert torch.equal(got, _plain(q, k, v, kv_len, causal))


def test_the_kernel_refuses_what_it_does_not_take():
    q, k = torch.zeros((1, 4, 2, 64)), torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="head dim 96"):
        fa.flash_attention(torch.zeros((1, 4, 2, 96)), torch.zeros((1, 4, 1, 96)),
                           torch.zeros((1, 4, 1, 96)), causal=True)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.double(), k.double(), causal=True)
    with pytest.raises(ValueError, match="KV heads dividing"):
        fa.flash_attention(torch.zeros((1, 4, 3, 64)), k.expand(1, 4, 2, 64),
                           k.expand(1, 4, 2, 64), causal=False)
