"""The plain reference against the port at a tiny size on the CPU, in
fp32 on both sides; and the reference stands alone."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import checks, ports, references, weights
from bench.references import dense_decoder as ref

BENCH = Path(__file__).resolve().parent
CONFIGS = ["qwen1.5-0.5b", "qwen3-1.7b"]


def _setup(name, seed=11):
    import json

    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = references.of(c).tiny(c)
    W = weights.make_weights(c, seed, "cpu", torch.float32)
    port = ports.of(c)
    pcfg = dataclasses.replace(port.model_config(c, name), dtype="float32", attn_chunk_k=8)
    return c, W, pcfg, port.build_model(W, pcfg, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_served_logits_agree(name):
    from repro_torch.models import decode_step, forward, prefill

    c, W, pcfg, model = _setup(name)
    v = c["vocab_size"]
    toks = torch.randint(0, v, (3, 20), generator=torch.Generator().manual_seed(1))
    got = forward(model, {"tokens": toks})[0][..., :v]
    with references.exact_fp32():
        want = ref.logits_at(W, c, toks, list(range(20)))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # a prefill of 16 positions, then 4 decode steps through the cache
    logits, cache = prefill(model, {"tokens": toks[:, :16]}, 20)
    steps = [logits]
    for i in range(16, 19):
        logits, cache = decode_step(model, cache, toks[:, i:i + 1])
        steps.append(logits)
    got = torch.stack(steps, dim=1)[..., :v]
    assert (got - want[:, 15:19]).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_agree(name):
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    c, W, pcfg, model = _setup(name)
    port = ports.of(c)
    opt_cfg = {"lr": 6e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
               "grad_clip": 1.0, "z_loss": 1e-4}
    gen = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(3):
        arr = torch.randint(3, 259, (4, 17), generator=gen)
        batches.append({"tokens": arr[:, :-1].clone(), "labels": arr[:, 1:].clone()})
    hyper = adamw.AdamWHyper(**{k: v for k, v in opt_cfg.items() if k != "z_loss"})
    step = steps.make_train_step(pcfg, hyper)
    opt = adamw.adamw_init(model)
    losses, first = [], None
    for b in batches:
        model, opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        if first is None:
            first = {k: port.leaf(model, k, opt["mu"][port.program_name(k)]).detach() / 0.1
                     for k in W}
    grads = {k: float(g.norm()) for k, g in first.items()}
    change = {k: float((port.leaf(model, k).detach() - W[k]).norm()) for k in W}
    with references.exact_fp32():
        want = ref.train_steps(W, c, batches, opt_cfg, rows=3, keep_grads=True)
    assert checks.loss_gap(losses, want["losses"]) < 1e-5
    assert checks.norm_gap(grads, want["grad_norms"])[0] < 1e-4
    assert checks.diff_gap(first, want["grads"], want["grad_norms"]) < 1e-4
    assert checks.norm_gap(change, want["change_norms"])[0] < 1e-4
    # half the rows (the fault) and fp8 products (the control) read apart
    half = ref.train_steps(W, c, batches, opt_cfg, rows=3, half_batch=True)
    fp8 = ref.train_steps(W, c, batches, opt_cfg, rows=3, quant="fp8", keep_grads=True)
    assert checks.loss_gap(half["losses"], want["losses"]) > 1e-4
    assert checks.loss_gap(fp8["losses"], want["losses"]) > 1e-4
    assert checks.diff_gap(fp8["grads"], want["grads"], want["grad_norms"], "median") > 1e-2


def test_reference_imports_nothing_of_the_program_nor_jax():
    for path in [*sorted((BENCH / "references").glob("*.py")), BENCH / "weights.py",
                 BENCH / "checks.py", BENCH / "counts.py", BENCH / "loggen.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in {"__future__", "contextlib", "importlib", "math",
                                           "numpy", "torch", "json", "pathlib"}, (path.name, m)
    probe = ("import sys, bench.references.dense_decoder, bench.checks, bench.counts, "
             "bench.weights, bench.loggen; print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
