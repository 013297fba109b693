"""The port's LM training path against the JAX package's: ``loss_fn`` and
its gradients for every family, the vocab-chunked loss, remat, and
``make_train_step`` (one and two microbatches).

Every case draws its weights with the reference's ``init_params`` at
``.reduced(dtype="float32")`` widths and carries them across with
``weights.from_reference``, so both packages compute on the same
numbers; gradients are compared leaf by leaf in the reference's tree
(``weights.stack``). Tolerances: the loss within ``LOSS_REL`` (summation
order: ~1e-7 here); each gradient leaf within ``GRAD_REL`` of its
largest |value| (the backward's reassociation compounds the forward's
~1e-6: up to ~2e-5 here, on the SSM families).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.optim.adamw import AdamWHyper as RAdamWHyper
from repro.optim.adamw import adamw_init as radamw_init
from repro.train.steps import make_train_step as rmake_train_step
from repro_torch import configs
from repro_torch.models import ModelConfig, init_params, loss_fn
from repro_torch.models.weights import from_reference, stack, to_reference
from repro_torch.optim.adamw import AdamWHyper, adamw_init
from repro_torch.train.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
    make_train_step_explicit,
)

# one arch of each family: dense, moe, hybrid (mamba + attention + MoE),
# ssm (RWKV6), vlm, audio (encoder-decoder)
FAMILIES = ["qwen1.5-0.5b", "dbrx-132b", "jamba-v0.1-52b", "rwkv6-7b", "internvl2-2b",
            "whisper-base"]
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _cfgs(arch, **over):
    """(reference, port) configs, reduced, fp32; a MoE with room for every
    slot (capacity_factor 8, as the reference's decode test), so that no
    token's routing sits on a capacity edge."""
    if rconfigs.get_config(arch).n_experts:
        over.setdefault("capacity_factor", 8.0)
    return (rconfigs.get_config(arch).reduced(dtype="float32", **over),
            configs.get_config(arch).reduced(dtype="float32", **over))


def _batch(cfg, b=2, s=16, seed=0) -> dict:
    """Tokens, next-token labels with every 5th masked (-1), and the
    family's stubs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, ::5] = -1
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.n_patches:
        out["vision"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().float() if isinstance(tree, torch.Tensor)
                                    else tree, np.float32)}


def _port_grads(model, batch):
    params = dict(model.named_parameters())
    loss, metrics = loss_fn(model, _t(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), metrics, _flat(stack(model, dict(zip(params, grads))))


def _assert_grads_close(got: dict, want: dict, rel=GRAD_REL):
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()) + 1e-10, (path, err, float(np.abs(w).max()))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(FAMILIES.index(arch)))
    batch = _batch(rcfg)
    (want, wm), wgrads = jax.value_and_grad(
        lambda p: rmodels.loss_fn(p, rcfg, _j(batch)), has_aux=True)(params)
    model = from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    got, gm, grads = _port_grads(model, batch)
    assert abs(got - float(want)) <= LOSS_REL * abs(float(want))
    assert abs(float(gm["aux"]) - float(wm["aux"])) <= 1e-5 * max(1.0, abs(float(wm["aux"])))
    if rcfg.n_experts:
        assert float(wm["aux"]) > 0
    _assert_grads_close(grads, _flat(jax.tree.map(np.asarray, wgrads)))


def test_vlm_prefix_carries_no_labels():
    """The patch prefix gets label -1: the loss counts the text's labels
    only, as a text-only batch of the same labels would."""
    rcfg, cfg = _cfgs("internvl2-2b")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _t(_batch(cfg))
    with torch.no_grad():
        loss, m = loss_fn(model, batch)
        all_masked, _ = loss_fn(model, dict(batch, labels=torch.full_like(batch["labels"], -1)))
    assert torch.isfinite(loss) and float(all_masked) == 0.0


def test_vocab_chunked_loss_equals_the_full_loss():
    """``cfg.vocab_chunk``: 96 does not divide 512 and falls to 64; the value
    equals the full-logits loss and the reference's chunked loss, and so
    do the gradients (the port's test of ``tests/test_models.py``'s)."""
    cfg = ModelConfig(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab_size=512, remat=False, attn_chunk_k=16, dtype="float32")
    chunked = dataclasses.replace(cfg, vocab_chunk=96)
    params = rmodels.init_params(rmodels.ModelConfig(**dataclasses.asdict(cfg)),
                                 jax.random.PRNGKey(0))
    model = from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    batch = _batch(cfg, s=32, seed=1)
    full, _, g_full = _port_grads(model, batch)
    model_c = from_reference(chunked, to_reference(model), device="cpu")
    part, _, g_part = _port_grads(model_c, batch)
    assert abs(full - part) <= 1e-6 * abs(full)
    _assert_grads_close(g_part, g_full, rel=1e-5)
    rchunked = rmodels.ModelConfig(**dataclasses.asdict(chunked))
    want = float(rmodels.loss_fn(params, rchunked, _j(batch))[0])
    assert abs(part - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b"])
def test_remat_gives_the_gradients_of_no_remat(arch):
    """``cfg.remat`` (the default of every config) recomputes each block in
    the backward: the same loss and gradients as keeping the activations."""
    _, cfg = _cfgs(arch)
    assert cfg.remat
    model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    plain = from_reference(dataclasses.replace(cfg, remat=False), to_reference(model),
                           device="cpu")
    batch = _batch(cfg, seed=2)
    l1, _, g1 = _port_grads(model, batch)
    l2, _, g2 = _port_grads(plain, batch)
    assert l1 == l2
    _assert_grads_close(g1, g2, rel=1e-6)


def _small_dense():
    return ModelConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=32,
                       remat=False, attn_chunk_k=8, dtype="float32")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Two steps of ``make_train_step`` (fp32 grad accumulation over the
    microbatches, clipping, AdamW) from the same weights and batch: loss
    and grad norm within 1e-5. An AdamW step moves a parameter by about
    lr * g / |g|, so a gradient error e moves it by up to lr * e / |g|,
    at most 2 lr: with e the gradients' tolerance (``GRAD_REL`` of the
    largest), each parameter within 1e-6 + 2 lr min(1, 2 e / |g|) a step,
    |g| its smaller gradient of the two steps."""
    rcfg, cfg = _cfgs("qwen1.5-0.5b")
    params = rmodels.init_params(rcfg, jax.random.PRNGKey(3))
    batch = _batch(rcfg, b=4, seed=3)
    lr = 1e-3
    rstep = jax.jit(rmake_train_step(rcfg, RAdamWHyper(lr=lr), microbatches=microbatches))
    model = from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    step = make_train_step(cfg, AdamWHyper(lr=lr), microbatches=microbatches)
    p, o = params, radamw_init(params)
    opt = adamw_init(model)
    gmin, top = None, 0.0
    for _ in range(2):
        grads = _flat(jax.tree.map(np.asarray, jax.grad(
            lambda q: rmodels.loss_fn(q, rcfg, _j(batch))[0])(p)))
        top = max([top] + [float(np.abs(g).max()) for g in grads.values()])
        gmin = ({k: np.abs(g) for k, g in grads.items()} if gmin is None
                else {k: np.minimum(gmin[k], np.abs(g)) for k, g in grads.items()})
        p, o, wm = rstep(p, o, _j(batch))
        model, opt, gm = step(model, opt, _t(batch))
        for key in ("loss", "grad_norm"):
            assert abs(float(gm[key]) - float(wm[key])) <= 1e-5 * abs(float(wm[key])), key
    assert int(opt["step"]) == int(o["step"]) == 2
    got, want = _flat(to_reference(model)), _flat(jax.tree.map(np.asarray, p))
    for path, w in want.items():
        e = 2 * GRAD_REL * top / np.maximum(gmin[path], 1e-30)
        bound = 1e-6 + 2 * 2 * lr * np.minimum(1.0, e)
        assert (np.abs(got[path] - w) <= bound).all(), path


def test_loss_decreases_tiny_train():
    """``tests/test_models.py::test_loss_decreases_tiny_train`` on the port:
    30 steps on a tiny dense model, the loss must drop below 0.7 of its
    start."""
    cfg = ModelConfig(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab_size=64, remat=False, attn_chunk_k=16)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, AdamWHyper(lr=3e-3))
    opt = adamw_init(model)
    toks = torch.tile(torch.arange(32)[None, :], (4, 1)) % 64
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    losses = []
    for _ in range(30):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::6]


def test_train_step_keeps_the_parameters_and_bf16():
    """The update is in place: each ``nn.Parameter`` object survives, bf16
    parameters stay bf16, the moments are fp32."""
    cfg = configs.get_config("qwen1.5-0.5b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {k: (id(p), p.dtype, p.detach().clone()) for k, p in model.named_parameters()}
    opt = adamw_init(model)
    batch = _t(_batch(cfg))
    model, opt, m = make_train_step(cfg)(model, opt, batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    for k, p in model.named_parameters():
        assert id(p) == before[k][0] and p.dtype == before[k][1], k
        assert opt["mu"][k].dtype == opt["nu"][k].dtype == torch.float32, k
    assert model.embed.dtype == torch.bfloat16
    assert not torch.equal(model.embed, before["embed"][2])


def test_explicit_step_on_one_device_is_the_plain_step():
    """With no process group (one card) the explicit step reduces nothing:
    it is ``make_train_step`` with one microbatch and no ``lr_fn``."""
    cfg = _small_dense()
    a = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = from_reference(cfg, to_reference(a), device="cpu")
    batch = _t(_batch(cfg, seed=4))
    oa, ob = adamw_init(a), adamw_init(b)
    err = {"x": torch.ones(1)}
    for _ in range(2):
        a, oa, ma = make_train_step(cfg)(a, oa, batch)
        b, ob, err2, mb = make_train_step_explicit(cfg)(b, ob, err, batch)
        assert err2 is err
        assert float(ma["loss"]) == float(mb["loss"])
    for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q)


def test_prefill_and_decode_steps_wrap_serving():
    from repro_torch.models import decode_step, prefill

    cfg = configs.get_config("qwen3-1.7b").reduced(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    logits, cache = make_prefill_step(cfg)(model, {"tokens": toks})
    want, wcache = prefill(model, {"tokens": toks}, toks.shape[1])
    assert torch.equal(logits, want) and cache["blocks"][0]["sub0"]["k"].shape[1] == 16
    step_logits, _ = make_decode_step(cfg)(model, cache, logits.argmax(-1)[:, None])
    want_step, _ = decode_step(model, wcache, want.argmax(-1)[:, None])
    assert torch.equal(step_logits, want_step)
