"""Multi-pod dry run (``repro.launch.dryrun``), on shapes only.

For an (architecture x input-shape x mesh) cell: a fake process group of
256 (16 x 16) or 512 (2 x 16 x 16) ranks in this process, the production
``DeviceMesh`` over it, the model, AdamW's moments, the batch or the
decode cache built on ``"meta"`` (shapes with no storage) and placed by
the ported sharding rules, then one step run under the cost model
(``launch.hlo_cost.CostModel``): rank 0's local ops and the collectives
DTensor issues, counted as the reference counts a compiled step's HLO.
The JSON artifact has the reference's keys wherever the quantity is the
same; memory per rank is

- ``argument_bytes``: the local shards of the parameters, the moments and
  the batch, or of the parameters, the decode cache and the tokens;
- ``temp_bytes``: the peak of the storage the step allocated and still
  held, above the arguments;
- ``output_bytes`` / ``alias_bytes``: the step's outputs, and those of
  them that are arguments updated in place (the parameters of a train
  step, the states of a decode cache),

held against the H100 80GB HBM3's 80 GB (``HBM_BYTES``). The reference's
``xla_cost_analysis`` has no counterpart. As the reference's
``out_shardings`` do, a prefill step returns its cache placed by
``cache_pspecs`` (the redistribution is part of the traced step), and a
decode step takes a cache placed so and returns it placed so.
``cache_all_gathers`` (prefill and decode cells) counts the all-gathers
whose input is as large as a rank's block of a 4-D cache leaf (K/V,
RWKV's state) or larger: split-K decode gathers none. The process group is set up process-wide, so a
sweep runs one subprocess a cell (``--all``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --shape decode_32k --mesh both \
      --device cpu

``--device`` is the mesh's device type ("cuda" by default, which raises
where there is no card; the cell itself needs no device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..models import ModelConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")
HBM_BYTES = 80e9  # one H100 80GB HBM3


def default_microbatches(cfg: ModelConfig, batch: int = 256, dp_size: int = 16) -> int:
    """Grad-accum depth so activations fit (the reference's hillclimb
    lever; its thresholds were set for its 16 GB chips and are kept, not
    re-derived for the 80 GB card).

    Capped so each microbatch still covers the DP axes: a microbatch
    smaller than dp_size gets replicated."""
    n = analytic_params(cfg)["total"]
    if n > 100e9:
        mb = 16
    elif n > 30e9:
        mb = 16
    elif n > 2e9:
        mb = 4
    else:
        mb = 1
    return max(1, min(mb, batch // max(dp_size, 1)))


def analytic_params(cfg: ModelConfig) -> dict:
    """Total and per-token-active param counts (MODEL_FLOPS = 6*N_active*D)."""
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.padded_vocab
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    total = V * d * (1 if cfg.tie_embeddings else 2)
    active = total
    for i in range(L):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            a = d * h * hd + 2 * d * kv * hd + h * hd * d
        elif kind == "mamba":
            di, ds, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
            a = d * 2 * di + cfg.ssm_conv * di + di * (dr + 2 * ds) + dr * di + di * ds + di + di * d
        else:
            a = 4 * d * d + 2 * d * cfg.rwkv_decay_lora
        total += a
        active += a
        if kind == "rwkv6":
            total += 2 * d * f
            active += 2 * d * f
        else:
            nmat = 3 if cfg.ffn_act == "swiglu" else 2
            if cfg.layer_is_moe(i):
                total += d * cfg.n_experts + cfg.n_experts * nmat * d * f
                active += d * cfg.n_experts + cfg.top_k * nmat * d * f
            else:
                total += nmat * d * f
                active += nmat * d * f
    if cfg.n_enc_layers:
        enc = cfg.n_enc_layers * (2 * d * h * hd + 2 * d * kv * hd + 2 * d * f)
        x = L * (2 * d * h * hd + 2 * d * kv * hd)
        total += enc + x
        active += enc + x
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape: str) -> float:
    info = SHAPES[shape]
    n_active = analytic_params(cfg)["active"]
    tokens = info["batch"] * (info["seq"] if info["kind"] in ("train", "prefill") else 1)
    mult = 6.0 if info["kind"] == "train" else 2.0
    return mult * n_active * tokens


def parallel_mode(cfg: ModelConfig, shape: str) -> str:
    """Pure-DP (+ZeRO-1) for small-model training: with d_model ~1-2k a
    16-way TP spends more on per-layer activation all-reduces than on
    math. Threshold (the reference's, set for its 16 GB chips): replicated
    bf16 params + ZeRO-1 moments must fit comfortably; batch must cover
    the whole mesh."""
    n = analytic_params(cfg)["total"]
    info = SHAPES[shape]
    if info["kind"] == "train" and n <= 2.2e9:
        return "dp"
    return "2d"


def input_specs(arch: str, shape: str, cfg: ModelConfig) -> dict:
    """Every model input of this cell, on ``"meta"``: ``{"batch": ...}``
    for train / prefill, ``{"cache": ..., "tokens": ...}`` for decode."""
    from ..models import init_cache

    info = SHAPES[shape]
    s, b = info["seq"], info["batch"]
    meta = torch.device("meta")
    dt = torch.bfloat16
    if info["kind"] in ("train", "prefill"):
        toks = s - (cfg.n_patches or 0)
        batch = {"tokens": torch.empty((b, toks), dtype=torch.int32, device=meta)}
        if info["kind"] == "train":
            batch["labels"] = torch.empty((b, toks), dtype=torch.int32, device=meta)
        if cfg.n_patches:
            batch["vision"] = torch.empty((b, cfg.n_patches, cfg.d_model), dtype=dt, device=meta)
        if cfg.n_enc_layers:
            batch["frames"] = torch.empty((b, cfg.n_frames, cfg.d_model), dtype=dt, device=meta)
        return {"batch": batch}
    # decode: one new token against an s-long cache
    return {"cache": init_cache(cfg, b, s, device=meta),
            "tokens": torch.empty((b, 1), dtype=torch.int32, device=meta)}


def fake_group(n: int) -> None:
    """This process as rank 0 of a fake process group of ``n`` ranks
    (collectives are recorded, never run); once a process."""
    import torch.distributed as dist
    # registers the "fake" backend (PyTorch keeps it with its test helpers)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"already set up; this cell needs {n} (one process a cell)")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if type(t).__name__ == "DTensor" else t


def _bytes(ts) -> int:
    return sum(_local(t).numel() * _local(t).element_size() for t in ts)


def cache_all_gathers(cache, gathers) -> int:
    """The all-gathers (``CostModel``'s ``all_gather_inputs``: [shape,
    count] pairs) whose input is 4-D and at least as large as the
    smallest local block of a 4-D leaf of ``cache`` (K/V, RWKV's state):
    the gathers of a cache block, or of anything as large."""
    blocks = [_local(t).numel() for t in _leaves(cache) if t.ndim == 4]
    if not blocks:
        return 0
    least = min(blocks)
    return sum(n for shape, n in gathers
               if len(shape) == 4 and int(torch.Size(shape).numel()) >= least)


def lower_cell(arch: str, shape: str, multi_pod: bool, microbatches: int | None = None,
               device="cuda", *, mesh=None, cfg=None, mode=None):
    """The cell's mesh, config, step and placed inputs, built on shapes
    -> (mesh, cfg, step, args, microbatches, mode). ``mesh`` (a
    ``DeviceMesh`` over a process group the caller set up), ``cfg`` (the
    arch's, before ``tp_pad``) and ``mode`` ("2d" / "dp") replace the
    production mesh, the arch's config and ``parallel_mode``'s choice, for
    a small rehearsal of a cell."""
    from ..distributed.act_shard import install_mesh
    from ..distributed.sharding import (
        batch_pspecs,
        cache_pspecs,
        param_pspecs,
        shard_batch,
        shard_cache,
        shard_model,
        shard_opt_state,
        zero1_opt_pspecs,
    )
    from ..kernels.ops import check_device
    from ..models import Transformer, serving, tp_pad
    from ..optim.adamw import adamw_init
    from ..train.steps import make_decode_step, make_train_step
    from .mesh import make_production_mesh

    dev = check_device(device)
    if mesh is None:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    tp = sizes["model"]
    cfg = tp_pad(cfg if cfg is not None else get_config(arch), tp)
    info = SHAPES[shape]
    mode = mode or parallel_mode(cfg, shape)
    n_chips = mesh.size()
    if mode == "dp" and info["batch"] % n_chips == 0:
        dp_axes = tuple(mesh.mesh_dim_names)
        install_mesh(mesh, dp_axes=dp_axes, tp=False)
        # dp-mode keeps the vocab unsharded -> the vocab-chunked loss, so
        # (B,S,V) fp32 logits never materialize
        cfg = dataclasses.replace(cfg, vocab_chunk=8192)
    else:
        mode = "2d"
        dp_axes = None
        install_mesh(mesh)  # activation sharding constraints inside the model

    model = Transformer(cfg, "meta")
    p_specs = param_pspecs(model, cfg, mesh, mode=mode)
    opt = adamw_init(model) if info["kind"] == "train" else None
    m_specs = zero1_opt_pspecs(model, mesh) if mode == "dp" else p_specs
    shard_model(model, mesh, p_specs)
    specs = input_specs(arch, shape, cfg)
    mb = 0
    if info["kind"] == "train":
        dp_size = 1
        for a in ("pod", "data"):
            dp_size *= sizes.get(a, 1)
        if microbatches is not None:
            mb = microbatches
        elif mode == "dp":
            mb = 1
        else:
            mb = default_microbatches(cfg, info["batch"], dp_size)
        opt = shard_opt_state(opt, mesh, m_specs)
        batch = shard_batch(specs["batch"], mesh,
                            batch_pspecs(specs["batch"], mesh, dp_axes=dp_axes))
        step = make_train_step(cfg, microbatches=mb)
        args = (model, opt, batch)
    elif info["kind"] == "prefill":
        def step(model, batch):  # the cache out as the reference's out_shardings place it
            logits, cache = serving.prefill(model, batch, info["seq"])
            return logits, shard_cache(cache, mesh, cache_pspecs(cache, cfg, mesh))

        args = (model, shard_batch(specs["batch"], mesh, batch_pspecs(specs["batch"], mesh)))
    else:  # decode: one token against the placed cache
        step = make_decode_step(cfg)
        toks = {"t": specs["tokens"]}
        args = (model, shard_cache(specs["cache"], mesh, cache_pspecs(specs["cache"], cfg, mesh)),
                shard_batch(toks, mesh, batch_pspecs(toks, mesh))["t"])
    return mesh, cfg, step, args, mb, mode


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str, microbatches=None,
             device="cuda", *, mesh=None, cfg=None, mode=None) -> dict:
    """One cell traced -> its artifact (also written to ``out_dir``);
    ``mesh``, ``cfg`` and ``mode`` as ``lower_cell`` takes them."""
    from ..distributed.act_shard import install_mesh
    from . import hlo_cost

    multi = mesh_kind == "multi"
    n_dev = mesh.size() if mesh is not None else 512 if multi else 256
    print(f"=== {arch} x {shape} x {mesh_kind} ({n_dev} ranks) ===", flush=True)
    t0 = time.time()
    mesh, cfg, step, args, mb, mode = lower_cell(arch, shape, multi, microbatches, device,
                                                 mesh=mesh, cfg=cfg, mode=mode)
    t_lower = time.time() - t0
    arg_leaves = _leaves([args[0].state_dict(keep_vars=True)] + list(args[1:]))
    arg_keys = {_local(t).untyped_storage()._cdata for t in arg_leaves}
    t0 = time.time()
    try:
        cm = hlo_cost.CostModel(n_dev)
        with cm:
            out = step(*args)
    finally:
        install_mesh(None)
    t_trace = time.time() - t0
    costs = cm.result()
    kind = SHAPES[shape]["kind"]
    outs = _leaves(list(out[1:]) if kind == "train" else list(out))
    if kind == "train":
        outs += _leaves(dict(out[0].named_parameters()))
    out_bytes = _bytes(outs)
    alias = _bytes([t for t in outs if _local(t).untyped_storage()._cdata in arg_keys])
    terms = hlo_cost.roofline_terms(costs)
    mf = model_flops(cfg, shape)
    memory = {
        "argument_bytes": _bytes(arg_leaves),
        "output_bytes": out_bytes,
        "temp_bytes": costs["peak_live_bytes"],
        "alias_bytes": alias,
    }
    memory["peak_bytes"] = memory["argument_bytes"] + memory["temp_bytes"]
    memory["fits_hbm"] = memory["peak_bytes"] <= HBM_BYTES
    art = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "chips": n_dev,
        "mode": mode,
        "microbatches": mb,
        "padded_heads": cfg.n_heads,
        "lower_s": round(t_lower, 2),
        "trace_s": round(t_trace, 2),
        "memory": memory,
        "hbm_bytes_per_chip": HBM_BYTES,
        "hlo_cost": {
            "flops_per_device": costs["flops"],
            "hbm_bytes_per_device": costs["hbm_bytes"],
            "convert_bytes_per_device": costs["convert_bytes"],
            "collective_bytes": costs["collective_bytes"],
            "collective_count": costs["collective_count"],
            "collective_bytes_total": costs["collective_bytes_total"],
            "dot_count": costs["dot_count"],
            "op_count": costs["op_count"],
            "all_gather_inputs": costs["all_gather_inputs"],
        },
        "cache_all_gathers": (None if kind == "train" else cache_all_gathers(
            args[1] if kind == "decode" else out[1], costs["all_gather_inputs"])),
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / max(costs["flops"], 1.0),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json"), "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({k: art[k] for k in ("memory", "roofline", "useful_flops_ratio",
                                          "trace_s")}, indent=1), flush=True)
    return art


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (default; fails where there is no "
                         "card) or cpu")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:  # every applicable cell, or those of --arch / --shape
        for a in ARCH_IDS:
            for s in SHAPES:
                if shape_applicable(a, s) and args.arch in (None, a) and args.shape in (None, s):
                    cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape))
    if len(cells) * len(meshes) == 1:
        run_cell(cells[0][0], cells[0][1], meshes[0], args.out, args.microbatches, args.device)
        return

    failures = []
    for a, s in cells:  # one process a cell: the fake group is process-wide
        for m in meshes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                   "--mesh", m, "--out", args.out, "--device", args.device]
            if args.microbatches is not None:
                cmd += ["--microbatches", str(args.microbatches)]
            p = subprocess.run(cmd, capture_output=True, text=True)
            print(p.stdout, end="", flush=True)
            if p.returncode:
                failures.append((a, s, m, p.stderr[-2000:]))
                print(f"FAILED {a} {s} {m}: {p.stderr[-400:]}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[:3])
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
