"""Two source trees of the port, in turns on one card: the batch compress
and an LZJS session of 1,000,000 HDFS lines, with stage seconds and
launch counts.

Each tree is a ``src`` directory that holds ``repro_torch`` (an older
commit unpacked with ``git archive``, say). The lines (loggen HDFS, seed
42, as ``chip_smoke.py`` phase 3 makes them) are written once to a
temporary file; then each run is a process of its own that imports
``repro_torch`` from its tree, builds its kernels, compresses the lines
twice (the second is reported: the first carries the builds and the
first launches) and runs one ``StreamingCompressor`` session of
8,192-line chunks, on the card. The runs go A, B, B, A, so that a drift
of the host's speed falls on both sides. One JSON line per run: wall
seconds, archive bytes, every stage's seconds and the launches of the
compress and of the session.

    python -m repro_torch.benchmarks.compress_ab --a OLD/src --b src
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time

LINES = 1_000_000


def _one(src: str, lines_path: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.core.codec import LogzipConfig, compress
    from repro_torch.core.stream import StreamingCompressor
    from repro_torch.data.loggen import DATASETS
    from repro_torch.kernels import build, ops

    build.build(build.SOURCES)
    with open(lines_path, encoding="utf-8", errors="surrogateescape") as f:
        lines = f.read().split("\n")
    cfg = LogzipConfig(format=DATASETS["HDFS"]["format"], device="cuda")
    out = {"src": src}
    for key in ("compress (first)", "compress"):
        stages: dict = {}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        blob = compress(lines, cfg, stage_times=stages)
        torch.cuda.synchronize()
        out[key] = {"s": time.perf_counter() - t0, "bytes": len(blob), "stages": stages,
                    "launches": ops.launch_counts()}
    stages = {}
    ops.reset_launch_counts()
    buf = io.BytesIO()
    t0 = time.perf_counter()
    with StreamingCompressor(buf, cfg, chunk_lines=8192, stage_times=stages) as sc:
        sc.feed(lines)
    torch.cuda.synchronize()
    out["session"] = {"s": time.perf_counter() - t0, "bytes": len(buf.getvalue()),
                      "stages": stages, "launches": ops.launch_counts()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", help="src directory of the first tree")
    ap.add_argument("--b", help="src directory of the second tree")
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LINES_FILE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_one(*args.worker)), flush=True)
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    from ..data.loggen import generate_lines

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lines.txt")
        with open(path, "w", encoding="utf-8", errors="surrogateescape") as f:
            f.write("\n".join(generate_lines("HDFS", LINES, seed=42)))
        for side, src in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  os.path.abspath(src), path],
                                 capture_output=True, text=True)
            if run.returncode:
                print(run.stderr[-3000:], file=sys.stderr)
                return run.returncode
            print(f"{side} {run.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
