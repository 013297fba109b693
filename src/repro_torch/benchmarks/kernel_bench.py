"""Throughput of the logzip hot-spot kernels against their host paths.

Compares, on Spark lines from loggen (seed 3) and templates that ISE
extracts from the first 4,000 of them: the python trie, the numpy DP
matcher and ``match_first`` through the ``wildcard_match_first`` kernel
(one first-hit launch per call); the ``simcount`` kernel; the
host ``tokenize_batch`` and the ``tokenize_hash`` kernel; and the host
match + span extraction and the fused ``match_extract`` kernel. The
matchers must agree (the asserts of ``run``).

On ``device="cuda"`` (the default) the kernels run on the card and the
rows say ``(cuda)``; ``device="cpu"`` runs their plain torch versions and
the rows say so. Every time is a host clock around a call that returns
numpy, so it includes the copies to and from the card, except the
``tokenize_hash`` row, which times the kernel on a grid already there.

    python -m repro_torch.benchmarks.kernel_bench [--device cpu] [--n-lines N]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.ise import ISEConfig, iterative_structure_extraction
from ..core.match import extract_spans, match_first
from ..core.tokenizer import Vocab, tokenize, tokenize_batch
from ..core.trie import PrefixTree
from ..data.loggen import generate_lines
from ..kernels import ops
from ..kernels.tokenize import hash_powers, tokenize_hash


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _label(device) -> str:
    return "cuda" if ops.check_device(device).type == "cuda" else "plain torch, cpu"


def _prep(n_lines=20000, device="cuda"):
    v = Vocab()
    lines = generate_lines("Spark", n_lines, seed=3)
    toks = [tokenize(l.split(": ", 1)[-1])[0] for l in lines]
    ids, lens = v.encode_batch(toks, 48)
    # build templates from a sample via ISE
    res = iterative_structure_extraction(ids[:4000], lens[:4000], vocab_size=len(v),
                                         cfg=ISEConfig(min_sample=300), device=device)
    return ids, lens, res.templates


def run(n_lines=20000, device="cuda") -> list[dict]:
    label = _label(device)
    ids, lens, templates = _prep(n_lines, device)
    rows = []

    t0 = time.time()
    tree = PrefixTree()
    for i, t in enumerate(templates):
        tree.insert(t, i)
    a_trie, _ = tree.match_batch(ids, lens)
    rows.append({"impl": "trie (python)", "lines_per_s": len(ids) / (time.time() - t0)})

    t0 = time.time()
    a_np = match_first(ids, lens, templates, use_kernel=False)
    rows.append({"impl": "DP matcher (numpy)", "lines_per_s": len(ids) / (time.time() - t0)})

    t0 = time.time()
    a_k = match_first(ids, lens, templates, use_kernel=True, device=device)
    rows.append({"impl": f"wildcard_match_first ({label})",
                 "lines_per_s": len(ids) / (time.time() - t0)})

    assert ((a_np >= 0) == (a_trie >= 0)).all()
    assert (a_np == a_k).all()

    tm, tl = ops.pack_templates(templates)
    sub = min(len(ids), 8192)
    t0 = time.time()
    ops.simcount(ids[:sub], tm, device=device)
    rows.append({"impl": f"simcount ({label})", "lines_per_s": sub / (time.time() - t0)})
    rows.extend(run_fused_kernels(n_lines, device))
    return rows


def run_fused_kernels(n_lines=20000, device="cuda") -> list[dict]:
    """The byte tokenizer/hasher and the fused match+extract pass against
    their host paths, as bytes/s over the raw input they consume."""
    label = _label(device)
    lines = [l.split(": ", 1)[-1] for l in generate_lines("Spark", n_lines, seed=3)]
    raw_bytes = sum(len(l.encode("utf-8", "surrogateescape")) for l in lines)
    rows: list[dict] = []

    # --- tokenizer: host vectorized grid vs device kernel
    t0 = time.time()
    tokenize_batch(lines, Vocab(), 48)
    host_s = time.time() - t0
    rows.append({"impl": "tokenize_batch (host numpy)",
                 "bytes_per_s": raw_bytes / host_s, "lines_per_s": n_lines / host_s})

    dev = ops.check_device(device)
    blocks, blens, _ = ops.pack_lines(lines)
    pws = hash_powers(blocks.shape[1])
    args = (torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev),
            torch.from_numpy(pws[0][0]).to(dev), torch.from_numpy(pws[1][0]).to(dev))
    delims = tuple(ord(c) for c in ops.DEFAULT_DELIMITERS)
    tokenize_hash(*args, delims)  # build the kernel
    _sync(dev)
    t0 = time.time()
    tokenize_hash(*args, delims)
    _sync(dev)
    dev_s = time.time() - t0
    rows.append({"impl": f"tokenize_hash ({label})",
                 "bytes_per_s": raw_bytes / dev_s, "lines_per_s": n_lines / dev_s})

    # --- fused match+extract: host anchor pass vs device kernel
    v = Vocab()
    grid = tokenize_batch(lines, v, 48)
    res = iterative_structure_extraction(grid.ids[:4000], grid.lens[:4000],
                                         vocab_size=len(v), cfg=ISEConfig(min_sample=300),
                                         device=device)
    t0 = time.time()
    a = match_first(grid.ids, grid.lens, res.templates, use_kernel=False)
    for g in sorted(set(a[a >= 0].tolist())):
        rws = (a == g).nonzero()[0]
        extract_spans(grid.ids[rws], grid.lens[rws], res.templates[g])
    host_s = time.time() - t0
    rows.append({"impl": "match+extract (host fused anchors)",
                 "bytes_per_s": raw_bytes / host_s, "lines_per_s": n_lines / host_s})

    ops.match_extract(grid.ids[:64], grid.lens[:64], res.templates, device=device)  # build
    t0 = time.time()
    a_dev, _ = ops.match_extract(grid.ids, grid.lens, res.templates, device=device)
    dev_s = time.time() - t0
    assert (a_dev == a).all()
    rows.append({"impl": f"match_extract ({label})",
                 "bytes_per_s": raw_bytes / dev_s, "lines_per_s": n_lines / dev_s})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-lines", type=int, default=20000)
    args = ap.parse_args(argv)
    ops.reset_launch_counts()
    for row in run(args.n_lines, args.device):
        print(json.dumps(row))
    print(json.dumps({"launches": ops.launch_counts()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
