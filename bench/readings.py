"""The readings that the limits of ``limits/<workload>.json`` are set
from, on the card at the cell's own size: the compared numbers of the
program on each of ``--seeds``, and of the control (the reference in
fp8 in the program's place) and, for a training cell, of the half-batch
fault on each of ``--controls``. Each seed is a run of the cell's own
driver, as the benchmark makes it, with a window of ``--seconds``
(default 1: a training cell's checked steps and a step more, a serving
cell's first batch).

    python3 bench/readings.py --workload <name> --seeds 1,2,3 --controls 1,2,3 \
        --out chiprun_out/readings.json
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, controls, device, seconds: float = 1.0):
    """Yield, for each seed of ``seeds`` and then of ``controls``, the
    numbers the cell's driver compares (``program``; every number it can
    compare, not only those with a limit) and, for a seed in
    ``controls``, those of the control and faults (``controls``)."""
    from bench import harness

    for seed in list(seeds) + sorted(set(controls) - set(seeds)):
        t = time.perf_counter()
        run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device, t0=t)
        rec = harness.driver(cell).run(run, controls=seed in controls)
        yield {"seed": seed, "in_program_set": seed in seeds, "program": rec["every"],
               "controls": rec.get("controls", {}), "log": run.log,
               "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.controls.split(",") if s}
    out = []
    for got in readings(cell, seeds, controls, torch.device("cuda", 0), args.seconds):
        out.append(got)
        print(json.dumps(got), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
