"""Serving launcher: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The port of ``repro.launch.serve``: the same flags and loop on the
arch's ``.reduced()`` config, its weights drawn from seed 0 and its
prompts from ``np.random.default_rng(0)``. ``--device`` ("cuda" by
default, which fails where there is no card) is checked before the
weights are built. ``serve_requests`` is the loop, for callers that
bring their own model.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve_requests(model, requests: int, batch: int, prompt_len: int, max_new: int,
                   rng: np.random.Generator, log=print) -> dict:
    """Serve ``requests`` random prompts in batches of ``batch``: a
    prefill (after ``cfg.n_patches`` zero patch embeddings for a VLM,
    with ``cfg.n_frames`` zero frames for the audio encoder), then
    ``max_new - 1`` greedy decode steps. Returns the
    generated tokens of each batch and the seconds spent, the card's work
    synchronised before each clock read."""
    from ..models import decode_step, prefill

    cfg = model.cfg
    dev = model.device
    max_len = prompt_len + max_new + (cfg.n_patches or 0)
    # the modality stubs, zeros as in the reference: the VLM's patch
    # embeddings before the prompt, the audio encoder's frames
    stubs = {}
    if cfg.n_patches:
        stubs["vision"] = torch.zeros((batch, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev)
    if cfg.n_enc_layers:
        stubs["frames"] = torch.zeros((batch, cfg.n_frames, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    served, outputs, prefill_s, decode_s, steps = 0, [], 0.0, 0.0, 0
    sync()
    t0 = time.perf_counter()
    while served < requests:
        n = min(batch, requests - served)
        toks = rng.integers(3, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
        tp = time.perf_counter()
        logits, cache = prefill(model, {"tokens": torch.from_numpy(toks).to(dev), **stubs},
                                max_len)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        sync()
        td = time.perf_counter()
        prefill_s += td - tp
        outs = [tok]
        for _ in range(max_new - 1):
            logits, cache = decode_step(model, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            outs.append(tok)
        sync()
        decode_s += time.perf_counter() - td
        steps += max_new - 1
        outputs.append(torch.cat(outs, dim=1).cpu())
        served += n
        log(f"batch of {n} served ({served}/{requests})")
    dt = time.perf_counter() - t0
    return {"served": served, "tokens": outputs, "seconds": dt, "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": steps,
            "tok_per_s": served * max_new / dt}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails where there is no card) or cpu")
    args = ap.parse_args()

    from ..configs import get_config
    from ..kernels.ops import check_device
    from ..models import init_params

    dev = check_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    out = serve_requests(model, args.requests, args.batch, args.prompt_len, args.max_new,
                         np.random.default_rng(0), log=lambda m: print(m, flush=True))
    print(f"{out['served']} requests x {args.max_new} tokens in {out['seconds']:.1f}s "
          f"({out['tok_per_s']:.1f} tok/s, reduced {args.arch}, {dev.type})")


if __name__ == "__main__":
    main()
