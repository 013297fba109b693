"""Training cells: the port's ``make_train_step`` on batches that its
``TokenBatcher`` reads from logzip shards the port wrote in set-up.

Set-up: the traffic's log lines from the seed (``loggen``), written as
logzip shards on the card (``write_logzip_shards``, the launcher's
corpus rule) under the run's ``TMPDIR``; the weights from the seed
loaded into the port's model; AdamW's state; the step. The first
``checked_steps`` steps go through the window's own call and feed, and
are the warm-up: after the first, each leaf's gradient as AdamW got it
(its first moment over 1 - b1), copied to the host, and its norm; after
the last, the norm of each leaf's change. The window then steps until ``--seconds`` have
passed, dispatching ahead with no synchronise a step (the batcher's
upload waits as it does in the launcher), the losses left on the card,
and ends with a synchronise: its tokens are those of every step issued.

After the window (and, traced, a profiled sub-window of
``profile_steps`` steps) the port's state is freed, and the reference
works the batches out again from the log lines and follows the checked
steps from the same weights, made again from the seed. With
``controls``, the control (the reference in fp8 in the program's place)
and the half-batch fault (the reference on half the rows) follow them
too, for ``readings.py``.
"""

from __future__ import annotations

import math
import tempfile
import time

import torch

from .. import checks, counts, loggen, ports, references, trace, weights


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The port's training job, built from the run's seed."""

    def __init__(self, run, workdir: str):
        from repro_torch.core.codec import LogzipConfig
        from repro_torch.core.ise import ISEConfig
        from repro_torch.data import pipeline
        from repro_torch.optim import adamw
        from repro_torch.train import steps

        tr, c, dev = run.cell.traffic, run.cell.config, run.device
        self.tr, self.c, self.dev = tr, c, dev
        self.lines = list(loggen.generate_lines(tr["dataset"], tr["corpus_lines"], seed=run.sub(1)))
        fmt = loggen.DATASETS[tr["dataset"]]["format"]
        pipeline.write_logzip_shards(
            iter(self.lines), workdir, shard_lines=tr["shard_lines"],
            cfg=LogzipConfig(level=tr["level"], kernel=tr["kernel"], format=fmt,
                             ise=ISEConfig(min_sample=tr["ise_min_sample"]), device=str(dev)))
        self.batcher = pipeline.TokenBatcher(workdir, mode="bytes", seed=run.sub(2) % 2**31,
                                             device=dev)
        self.port = ports.of(c)
        self.pcfg = self.port.model_config(c, run.cell.workload["config"], remat=tr["remat"])
        self.w0 = weights.make_weights(c, run.sub(3), dev)
        self.model = self.port.build_model(self.w0, self.pcfg, dev)
        o = tr["optimizer"]
        self.opt = adamw.adamw_init(self.model)
        self.step = steps.make_train_step(self.pcfg, adamw.AdamWHyper(
            lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
            grad_clip=o["grad_clip"]))
        self.batches, self.losses, self.norms = [], [], []
        self.wait_s, self.dispatch_s = [], []

    def one(self):
        """One step through the window's call and feed, timed on the host."""
        t0 = time.perf_counter()
        batch = self.batcher.next_batch(self.tr["batch"], self.tr["seq"])
        t1 = time.perf_counter()
        self.model, self.opt, m = self.step(self.model, self.opt, batch)
        t2 = time.perf_counter()
        self.batches.append(batch)
        self.losses.append(m["loss"])
        self.norms.append(m["grad_norm"])
        self.wait_s.append(t1 - t0)
        self.dispatch_s.append(t2 - t1)

    def checked(self, n: int) -> dict:
        """The first ``n`` steps -> the program's first gradient (on the
        host) and the norms of it and of the change, per leaf, under the
        benchmark's names."""
        b1, pt = self.tr["optimizer"]["b1"], self.port
        self.one()
        with torch.no_grad():
            mu = self.opt["mu"]
            grads = {k: pt.leaf(self.model, k, mu[pt.program_name(k)]).float() / (1 - b1)
                     for k in self.w0}
            grad = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            grads = {k: g.cpu() for k, g in grads.items()}
        for _ in range(n - 1):
            self.one()
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(pt.leaf(self.model, k).float()
                                                        - self.w0[k].float())) for k in self.w0}
        self.w0 = None
        return {"grads": grads, "grad_norms": grad, "change_norms": change,
                "global_norm": float(self.norms[0])}

    def free(self):
        self.model = self.opt = self.step = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_steps(run, lines, batches_taken, n: int, quant=None, half_batch=False) -> tuple:
    """(the reference's first ``n`` steps, the batch mismatch count),
    from the log lines and weights made again from the seed."""
    tr, c, dev = run.cell.traffic, run.cell.config, run.device
    shards = checks.shard_streams(lines, tr["shard_lines"], tr["byte_offset"], tr["eos"])
    stream, bad_labels = checks.program_stream(batches_taken)
    unexplained, order = checks.match_stream(stream, shards)
    mine = checks.reference_batches(shards, order, n, tr["batch"], tr["seq"])
    mine = [{k: torch.from_numpy(v.copy()).to(dev) for k, v in b.items()} for b in mine]
    W = {k: v.float() for k, v in weights.make_weights(c, run.sub(3), dev).items()}
    opt = dict(tr["optimizer"], z_loss=tr["z_loss"])
    ref = references.of(c)
    rows = ref.block_rows(c, tr["seq"], True)
    with references.exact_fp32():
        out = ref.train_steps(W, c, mine, opt, quant=quant, rows=rows, half_batch=half_batch,
                              keep_grads=True)
    return out, unexplained + bad_labels


def compare(got: dict, want: dict, mismatch: int, worst: dict | None = None) -> dict:
    """Every number the check can compare (``limits`` picks those it
    does); ``worst`` gets the leaf each norm gap is read at."""
    moved = checks.moved_leaves(want["grad_norms"])
    grad_gap, grad_at = checks.norm_gap(got["grad_norms"], want["grad_norms"])
    change_gap, change_at = checks.norm_gap(got["change_norms"], want["change_norms"], moved)
    if worst is not None:
        worst.update(grad_gap=grad_at, change_gap=change_at,
                     unmoved=sorted(set(want["grad_norms"]) - moved))
    return {"batch_mismatch": mismatch, "loss_gap": checks.loss_gap(got["losses"], want["losses"]),
            "loss1_gap": checks.loss_gap(got["losses"][:1], want["losses"][:1]),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_gap_median": checks.median_gap(got["grad_norms"], want["grad_norms"]),
            "grad_diff": checks.diff_gap(got["grads"], want["grads"], want["grad_norms"]),
            "grad_diff_median": checks.diff_gap(got["grads"], want["grads"], want["grad_norms"],
                                                "median"),
            "global_norm_gap": checks.loss_gap([got["global_norm"]], [want["global_norm"]])}


def run(run, controls: bool = False) -> dict:
    tr, dev = run.cell.traffic, run.device
    n_checked = tr["checked_steps"]
    with tempfile.TemporaryDirectory(prefix="bench-shards-") as workdir:
        prog = Program(run, workdir)
        got = prog.checked(n_checked)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_window = time.perf_counter()
        deadline = t_window + run.seconds
        while time.perf_counter() < deadline:
            prog.one()
        _sync(dev)
        window_s = time.perf_counter() - t_window
        steps = len(prog.losses) - n_checked
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        rec = {"t_window": t_window, "window_s": window_s, "steps": steps,
               "tokens": steps * tr["batch"] * tr["seq"],
               "batch_wait_s": prog.wait_s[n_checked:], "dispatch_s": prog.dispatch_s[n_checked:]}
        if run.trace:
            _, rec["trace"] = trace.profiled(
                lambda: [prog.one() for _ in range(tr["profile_steps"])], dev)
            rec["trace"]["steps"] = tr["profile_steps"]
        losses = [float(x) for x in torch.stack(prog.losses).cpu()]
        got["losses"] = losses[:n_checked]
        batches = prog.batches
        prog.free()
    want, mismatch = reference_steps(run, prog.lines, batches, n_checked)
    phases = counts.train_step(run.cell.config, tr["batch"], tr["seq"])
    worst = {}
    every = compare(got, want, mismatch, worst)
    rec.update(kind="train", attempted=len(losses),
               failed=sum(not math.isfinite(x) for x in losses), memory_peak_bytes=peak,
               numbers={k: every.get(k, math.nan) for k in run.cell.limits}, every=every,
               phases=phases)
    run.log.append(f"[train] losses of the checked steps {got['losses']}, reference "
                   f"{want['losses']}; global norms {got['global_norm']}, reference "
                   f"{want['global_norm']}; the worst leaves {worst}; "
                   f"{steps} steps in {window_s:.3f} s")
    if controls:
        rec["controls"] = {}
        for what, kw in (("control_fp8", {"quant": "fp8"}),
                         ("fault_half_batch", {"half_batch": True})):
            other, _ = reference_steps(run, prog.lines, batches, n_checked, **kw)
            rec["controls"][what] = compare(other, want, 0)
            run.log.append(f"[train] {what}: losses {other['losses']}, "
                           f"global norm {other['global_norm']}")
    return rec


def tiny(t: dict) -> dict:
    """The traffic ``t`` cut to a few short batches, for the CPU tests."""
    return dict(t, corpus_lines=1500, shard_lines=500, batch=4, seq=64, profile_steps=1)
