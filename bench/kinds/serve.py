"""Serving cells: static batches through the port's ``prefill`` and
``decode_step``, greedy, in a closed loop (the next batch is due when the
previous one returned).

Set-up: the weights from the seed loaded into the port's model, and a
pool of ``prompt_pool`` batches of prompts drawn on the card from the
seed (every seed the same sizes); one batch served to warm every shape.
A batch is a prefill of ``batch`` prompts of ``prompt`` tokens into a
cache of ``prompt + new_tokens`` slots, its argmax, a synchronise, then
``new_tokens - 1`` decode steps on the cache, each fed the argmax of the
last, and the tokens brought to the host. A request's latency runs from
when its batch was due to its last token. The window serves batches
until ``--seconds`` have passed and ends with the last batch's return.

After the window (and, traced, one profiled batch) the port's state is
freed, and the reference runs once over each of ``sample_requests``
requests drawn from the seed among those the window finished: its
prompt and its served tokens, whose gaps below the reference's best
logit at their positions are compared. With ``controls``, the control
(the reference in fp8 in the program's place) is read on the same
requests too, for ``readings.py``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import checks, counts, ports, references, trace, weights


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The port's model and the prompt pool, built from the run's seed."""

    def __init__(self, run):
        tr, c, dev = run.cell.traffic, run.cell.config, run.device
        self.tr, self.dev = tr, dev
        pt = ports.of(c)
        self.pcfg = pt.model_config(c, run.cell.workload["config"])
        self.model = pt.build_model(weights.make_weights(c, run.sub(3), dev), self.pcfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(run.sub(4))
        shape = (tr["prompt_pool"], tr["batch"], tr["prompt"])
        self.pool = torch.randint(0, c["vocab_size"], shape, generator=gen, device=dev,
                                  dtype=torch.int32)
        self.max_len = tr["prompt"] + tr["new_tokens"]
        self.served, self.prefill_s, self.decode_s, self.latency_s = [], [], [], []

    def batch(self, k: int, due: float):
        """Serve batch ``k`` of the pool, due at host time ``due``."""
        from repro_torch.models import serving

        t0 = time.perf_counter()
        logits, cache = serving.prefill(self.model, {"tokens": self.pool[k % len(self.pool)]},
                                        self.max_len)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        _sync(self.dev)
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(self.tr["new_tokens"] - 1):
            logits, cache = serving.decode_step(self.model, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu()
        t2 = time.perf_counter()
        self.served.append((k, toks.numpy()))
        self.prefill_s.append(t1 - t0)
        self.decode_s.append(t2 - t1)
        self.latency_s.append(t2 - due)

    def free(self):
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_gaps(run, prompts: np.ndarray, served: np.ndarray, quant=None) -> np.ndarray:
    """(requests, new_tokens) gaps of ``served`` below the reference's
    best logit, or (``quant``) of the token the reference in that
    precision puts first, with weights made again from the seed."""
    tr, c, dev = run.cell.traffic, run.cell.config, run.device
    W = {k: v.float() for k, v in weights.make_weights(c, run.sub(3), dev).items()}
    p, g = tr["prompt"], tr["new_tokens"]
    positions = list(range(p - 1, p + g - 1))
    ref = references.of(c)
    rows = ref.block_rows(c, p + g - 1, False)
    out = []
    with references.exact_fp32():
        for a in range(0, len(prompts), rows):
            seq = np.concatenate([prompts[a:a + rows], served[a:a + rows, :-1]], axis=1)
            toks = torch.from_numpy(seq.astype(np.int64)).to(dev)
            want = ref.logits_at(W, c, toks, positions).cpu().numpy()
            pick = served[a:a + rows]
            if quant is not None:
                pick = ref.logits_at(W, c, toks, positions, quant).argmax(-1).cpu().numpy()
            out.append(checks.served_gaps(want, pick))
    return np.concatenate(out)


def sample(run, prog: Program) -> tuple[np.ndarray, np.ndarray]:
    """(prompts, served tokens) of ``sample_requests`` requests drawn from
    the seed among those served."""
    tr = run.cell.traffic
    rows = [(k, r) for k, toks in prog.served for r in range(len(toks))]
    n = min(tr["sample_requests"], len(rows))
    pick = np.random.default_rng(run.sub(5)).choice(len(rows), n, replace=False)
    pool = prog.pool.cpu().numpy()
    served = {k: toks for k, toks in prog.served}
    prompts = np.stack([pool[rows[i][0] % len(pool), rows[i][1]] for i in sorted(pick)])
    toks = np.stack([served[rows[i][0]][rows[i][1]] for i in sorted(pick)])
    return prompts, toks


def run(run, controls: bool = False) -> dict:
    tr, dev = run.cell.traffic, run.device
    prog = Program(run)
    prog.batch(0, time.perf_counter())  # warm-up: every shape of the window
    prog.served, prog.prefill_s, prog.decode_s, prog.latency_s = [], [], [], []
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    deadline, due, k = t_window + run.seconds, t_window, 0
    while due < deadline:
        prog.batch(k, due)
        due = time.perf_counter()  # closed loop: the next is due now
        k += 1
    window_s = due - t_window
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    n = len(prog.latency_s)
    rec = {"t_window": t_window, "window_s": window_s, "batches": n,
           "requests": n * tr["batch"],
           "tokens": n * tr["batch"] * (tr["prompt"] + tr["new_tokens"]),
           "latency_s": [x for x in prog.latency_s for _ in range(tr["batch"])],
           "prefill_s": list(prog.prefill_s), "decode_s": list(prog.decode_s),
           "decode_steps": tr["new_tokens"] - 1}
    if run.trace:
        _, rec["trace"] = trace.profiled(lambda: prog.batch(k, time.perf_counter()), dev)
        rec["trace"]["steps"] = 1
        prog.served.pop()
    prompts, served = sample(run, prog)
    prog.free()
    gaps = reference_gaps(run, prompts, served)
    phases = counts.serve_batch(run.cell.config, tr["batch"], tr["prompt"], tr["new_tokens"])
    every = {"served_gap": float(gaps.max())}
    rec.update(kind="serve", attempted=n * tr["batch"], failed=0, memory_peak_bytes=peak,
               numbers={k: every.get(k, math.nan) for k in run.cell.limits}, every=every,
               phases=phases)
    run.log.append(f"[serve] {n} batches of {tr['batch']} in {window_s:.3f} s; widest served "
                   f"gap {float(gaps.max())} over {gaps.size} tokens of {len(prompts)} requests")
    if controls:
        fp8 = reference_gaps(run, prompts, served, "fp8")
        rec["controls"] = {"control_fp8": {"served_gap": float(fp8.max())}}
    return rec


def tiny(t: dict) -> dict:
    """The traffic ``t`` cut to a few short batches, for the CPU tests."""
    return dict(t, batch=4, prompt=32, new_tokens=4, prompt_pool=3, sample_requests=5)
