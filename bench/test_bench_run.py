"""Whole runs of each cell at a tiny size on the CPU: the result line's
keys, the independence guard, and ``correct`` false under each fault a
cell can have, planted in the program underneath the harness."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import checks, harness, readings, tinycell

ROOT = Path(__file__).resolve().parent.parent
TRAIN, SERVE = "train.qwen1.5-0.5b.spark", "serve.qwen3-1.7b.triage"


@pytest.mark.parametrize("name", [TRAIN, SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    line, printed = tinycell.run(name, trace=trace)
    assert json.loads(printed.strip().splitlines()[-1]) == line
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = harness.load_cell(name)
    assert set(line["metrics"]) <= {m["name"] for m in harness.metrics_of(cell, trace)}
    if not trace:  # the end-to-end metrics read from host clocks are all there
        assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(cell, False)}
    assert set(line["checks"]) == set(cell.limits)
    assert "[counts] " in printed


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_readings_come_from_the_cells_own_run(name):
    """``readings.py``'s loop drives the cell's own run: the program's
    numbers, and the control's and faults' beside them."""
    cell = tinycell.cell(name)
    seed = 2**31 + 11
    got = list(readings.readings(cell, [seed], {seed}, torch.device("cpu"), seconds=0.5))
    assert [g["seed"] for g in got] == [seed]
    assert set(cell.limits) <= set(got[0]["program"])
    assert checks.judge({k: got[0]["program"][k] for k in cell.limits}, cell.limits)[0]
    want = {"control_fp8"} | ({"fault_half_batch"} if name == TRAIN else set())
    assert set(got[0]["controls"]) == want
    for numbers in got[0]["controls"].values():
        assert set(cell.limits) <= set(numbers)


def test_a_module_of_the_jax_package_loaded_by_the_run_withholds_the_result(monkeypatch):
    from bench.kinds import serve

    fake = type(sys)("repro")
    real_free = serve.Program.free

    def free(self):  # the run loads the JAX package before its window closes
        sys.modules["repro"] = fake
        real_free(self)

    monkeypatch.setattr(serve.Program, "free", free)
    try:
        line, printed = tinycell.run(SERVE)
    finally:
        if sys.modules.get("repro") is fake:
            del sys.modules["repro"]
    assert line is None and '"correct"' not in printed


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from repro_torch.models import loss_fn
    from repro_torch.train import steps

    def frozen(cfg, hyper=None, **kw):
        def step(model, opt, batch):  # the loss, and no update
            with torch.no_grad():
                loss, _ = loss_fn(model, batch)
            return model, opt, {"loss": loss, "grad_norm": loss * 0}
        return step

    monkeypatch.setattr(steps, "make_train_step", frozen)
    line, _ = tinycell.run(TRAIN)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(monkeypatch):
    from repro_torch.train import steps

    real = steps.loss_fn

    def half(model, batch):
        n = batch["tokens"].shape[0] // 2
        return real(model, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(steps, "loss_fn", half)
    line, _ = tinycell.run(TRAIN)
    assert line["correct"] is False


def test_a_served_token_altered_is_not_correct(monkeypatch):
    from repro_torch.models import serving

    real = serving.decode_step

    def altered(model, cache, tokens):
        logits, cache = real(model, cache, tokens)
        bump = torch.zeros_like(logits)
        bump[:, 7] = 1e4  # token 7 wins every step
        return logits + bump, cache

    monkeypatch.setattr(serving, "decode_step", altered)
    line, _ = tinycell.run(SERVE)
    assert line["correct"] is False


def test_a_batch_altered_is_not_correct(monkeypatch):
    from repro_torch.data import pipeline

    real = pipeline.TokenBatcher.next_batch

    def altered(self, batch, seq):
        out = real(self, batch, seq)
        out["tokens"][0, 5] = 3 + (int(out["tokens"][0, 5]) - 2) % 256
        return out

    monkeypatch.setattr(pipeline.TokenBatcher, "next_batch", altered)
    line, _ = tinycell.run(TRAIN)
    assert line["correct"] is False and line["checks"]["batch_mismatch"]["value"] > 0


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload", SERVE,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and '"correct"' not in out.stdout
