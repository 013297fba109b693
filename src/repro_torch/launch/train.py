"""Training launcher: checkpoint/restart, preemption-safe
(``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \
        --steps 100 --workdir /tmp/run1 --device cpu
    # kill -TERM it mid-run, re-launch with the same workdir -> exact resume

The reference's flags, defaults and prints, plus ``--device`` ("cuda" by
default, which fails where there is no card). Fault-tolerance contract:

- the corpus: 40,000 lines of ``--dataset`` (loggen, seed 0) written as
  8,000-line logzip shards on ``--device`` (level 3, the dataset's
  format, ISE on 300-line samples), unless ``shards/manifest.json``
  exists; batches of bytes from ``TokenBatcher`` (seed 0);
- checkpoints every ``--ckpt-every`` steps, async and atomic, keep=3, in
  the reference's format (``checkpoint.ckpt``);
- SIGTERM / SIGINT write a final checkpoint and exit 0 (preemption);
- a restart resumes the parameters, AdamW's state and the data
  cursor (sample-exact).

Over several processes (``WORLD_SIZE`` > 1 with ``RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` in the environment, as ``torchrun`` sets them, or a
process group the caller initialised) the run is sharded as the
reference's is over its devices: a ``(world // --model-parallel,
--model-parallel)`` ("data", "model") mesh (``launch.mesh.
make_local_mesh``), installed for the activation constraints, the heads
padded to it (``tp_pad``), the parameters and AdamW's moments placed by
``distributed.param_pspecs`` and each batch by ``batch_pspecs``; NCCL
on "cuda", gloo on "cpu". Every rank draws the same init and reads the
same batches; rank 0 writes the shards and the checkpoints (whole
tensors, the reference's format) and prints. One process has no mesh.
``main(argv)`` returns the run's per-step losses and seconds, for
callers in the same process.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch
import torch.distributed as dist


def _init_group(dev: torch.device) -> None:
    """Join the process group the environment describes, once."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or world < 2:
        return
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    addr = os.environ.get("MASTER_ADDR", "localhost")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=world)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true", help="family-preserving small config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--dataset", default="Spark")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails where there is no card) or cpu")
    args = ap.parse_args(argv)

    from ..checkpoint.ckpt import CheckpointManager
    from ..configs import get_config
    from ..core.codec import LogzipConfig
    from ..core.ise import ISEConfig
    from ..data.loggen import DATASETS, generate_lines
    from ..data.pipeline import BYTE_VOCAB, TokenBatcher, write_logzip_shards
    from ..distributed.act_shard import install_mesh
    from ..distributed.sharding import (
        batch_pspecs,
        param_pspecs,
        shard_batch,
        shard_model,
        shard_opt_state,
    )
    from ..kernels.ops import check_device
    from ..launch.mesh import make_local_mesh
    from ..models import init_params, tp_pad
    from ..optim.adamw import AdamWHyper, adamw_init, cosine_schedule
    from ..train.steps import load_train_state, make_train_step, train_state

    dev = check_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=BYTE_VOCAB, attn_chunk_k=max(64, args.seq // 4))

    _init_group(dev)
    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_local_mesh(args.model_parallel, device=args.device)
        install_mesh(mesh)
        cfg = tp_pad(cfg, args.model_parallel)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    if mesh is not None:
        say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    shard_dir = os.path.join(args.workdir, "shards")
    if lead and not os.path.exists(os.path.join(shard_dir, "manifest.json")):
        write_logzip_shards(
            generate_lines(args.dataset, 40000, seed=0), shard_dir, shard_lines=8000,
            cfg=LogzipConfig(level=3, format=DATASETS[args.dataset]["format"],
                             ise=ISEConfig(min_sample=300), device=args.device),
        )
    if mesh is not None:
        dist.barrier()
    batcher = TokenBatcher(shard_dir, mode="bytes", seed=0, device=dev)

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(model)
    if mesh is not None:
        specs = param_pspecs(model, cfg, mesh)
        shard_model(model, mesh, specs)
        opt = shard_opt_state(opt, mesh, specs)
    step_fn = make_train_step(cfg, AdamWHyper(lr=args.lr), microbatches=args.microbatches,
                              lr_fn=cosine_schedule(args.lr, 20, args.steps))

    mgr = CheckpointManager(os.path.join(args.workdir, "ckpt"), keep=3)
    start = 0
    tree, extra, s = mgr.restore(device=dev)
    if tree is not None:
        opt = load_train_state(model, tree)
        batcher.load_state_dict(extra["data"])
        start = s
        say(f"resumed from step {s} (sample-exact)")
    del tree

    stop = {"now": False}

    def handle(sig, frame):
        print(f"signal {sig}: checkpointing and exiting...", flush=True)
        stop["now"] = True

    def stopping() -> bool:
        """Whether any rank was signalled (every rank stops at one step)."""
        if mesh is None:
            return stop["now"]
        flag = torch.tensor([float(stop["now"])], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    handlers = {sig: signal.signal(sig, handle) for sig in (signal.SIGTERM, signal.SIGINT)}
    run = {"start": start, "losses": [], "step_seconds": [], "ckpt_seconds": None}
    try:
        t0 = time.time()
        for step in range(start, args.steps):
            ts = time.perf_counter()
            batch = batcher.next_batch(args.batch, args.seq)
            if mesh is not None:
                batch = shard_batch(batch, mesh, batch_pspecs(batch, mesh))
            model, opt, m = step_fn(model, opt, batch)
            loss = float(m["loss"])  # waits for the step
            run["step_seconds"].append(time.perf_counter() - ts)
            run["losses"].append(loss)
            if step % 10 == 0 or step == args.steps - 1:
                tok_s = args.batch * args.seq * (step - start + 1) / max(time.time() - t0, 1e-9)
                say(f"step {step:5d}  loss {loss:.3f}  {tok_s:,.0f} tok/s")
            now = stopping()
            if now or (step and step % args.ckpt_every == 0):
                mgr.wait()
                mgr.save_async(step + 1, train_state(model, opt),
                               extra={"data": batcher.state_dict()})
                if now:
                    mgr.wait()
                    say(f"preemption checkpoint at step {step + 1} complete")
                    sys.exit(0)
        tc = time.perf_counter()
        mgr.save_async(args.steps, train_state(model, opt),
                       extra={"data": batcher.state_dict()})
        mgr.wait()
        run["ckpt_seconds"] = time.perf_counter() - tc
        say(f"done: {args.steps} steps in {time.time()-t0:.0f}s")
    finally:
        mgr.wait()
        for sig, h in handlers.items():
            signal.signal(sig, h)
        if mesh is not None:
            install_mesh(None)
    return run


if __name__ == "__main__":
    main()
