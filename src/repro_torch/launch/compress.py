"""logzip CLI.

    # batch pack (bounded line buffering; LZJM when chunked)
    PYTHONPATH=src python -m repro_torch.launch.compress pack in.log out.lzj \
        --format "<Date> <Time> <Level> <Component>: <Content>" --level 3 \
        --workers 4 [--shared-store]
    # streaming session -> LZJS (bounded memory; '-' reads stdin)
    cat in.log | PYTHONPATH=src python -m repro_torch.launch.compress stream - out.lzjs \
        --format "..." --chunk-lines 8192 [--append]
    # unpack any of LZJF / LZJM / LZJS; --range uses the LZJS footer index
    PYTHONPATH=src python -m repro_torch.launch.compress unpack out.lzjs back.log \
        [--range START:COUNT]
    PYTHONPATH=src python -m repro_torch.launch.compress inspect out.lzjs
    # compressed-domain queries (no full decompression; see DESIGN.md §11)
    PYTHONPATH=src python -m repro_torch.launch.compress grep out.lzjs PATTERN \
        [--regex] [--count] [--range START:COUNT] [--template K] \
        [--field F=V] [--json] [--limit N] [--stats] [--explain]
    # compressed-domain aggregations (DESIGN.md §14; never materialize)
    PYTHONPATH=src python -m repro_torch.launch.compress agg out.lzjs \
        (--by-template | --top FIELD | --top-param EVENT:STAR | \
         --histogram FIELD [--bucket N]) [-k N] [--json] [--stats]
    PYTHONPATH=src python -m repro_torch.launch.compress extract out.lzjs \
        [--template K] [--range START:COUNT] [--json]
    # durability (DESIGN.md §13): diagnose / repair a damaged archive;
    # --salvage on unpack/grep reads the survivors without repairing
    PYTHONPATH=src python -m repro_torch.launch.compress fsck out.lzjs [--json]
    PYTHONPATH=src python -m repro_torch.launch.compress repair out.lzjs [--json]

``pack``, ``stream``, ``agg``, ``compact`` and ``serve`` take ``--device``:
``cuda`` (the default) runs the port's kernels on the card and fails
where there is none; ``cpu`` runs their plain torch versions. The other
verbs run on the host only.

``pack``/``stream`` accept ``-`` as the input to read stdin. Input lines
are streamed with bounded buffering (one chunk at a time), never via a
whole-file ``read()``.
"""

from __future__ import annotations

import argparse
import io
import sys


def _open_input(path: str):
    if path == "-":
        return io.TextIOWrapper(sys.stdin.buffer, encoding="utf-8",
                                errors="surrogateescape"), False
    return open(path, encoding="utf-8", errors="surrogateescape"), True


def _iter_lines(f, bufsize: int = 1 << 20):
    """Yield exactly ``f.read().split("\\n")`` with bounded memory."""
    carry = ""
    while True:
        block = f.read(bufsize)
        if not block:
            yield carry
            return
        parts = (carry + block).split("\n")
        carry = parts.pop()
        yield from parts


def _cmd_pack(args) -> None:
    from repro_torch.core.codec import LogzipConfig, compress
    from repro_torch.core.parallel import compress_parallel, frame_multi

    cfg = LogzipConfig(level=args.level, kernel=args.kernel, format=args.format,
                       device=args.device)
    f, close = _open_input(args.infile)
    raw = 0
    try:
        if args.chunk_lines and args.workers <= 1 and not args.shared_store:
            # bounded memory: compress chunk-by-chunk as lines arrive
            # (compressed blobs are small and accumulate until the count
            # prefix can be written)
            blobs: list[bytes] = []
            buf: list[str] = []
            for line in _iter_lines(f):
                raw += len(line.encode("utf-8", "surrogateescape")) + 1
                buf.append(line)
                if len(buf) >= args.chunk_lines:
                    blobs.append(compress(buf, cfg))
                    buf = []
            if buf or not blobs:  # _iter_lines always yields >= 1 line
                blobs.append(compress(buf, cfg))
            raw -= 1
            blob = frame_multi(blobs)
        else:
            # multi-worker / shared-store paths need the full chunk list
            lines = list(_iter_lines(f))
            raw = sum(len(l.encode("utf-8", "surrogateescape")) + 1 for l in lines) - 1
            blob = compress_parallel(lines, cfg, n_workers=args.workers,
                                     chunk_lines=args.chunk_lines,
                                     shared_store=args.shared_store)
    finally:
        if close:
            f.close()
    with open(args.outfile, "wb") as fo:
        fo.write(blob)
    print(f"{raw/1e6:.2f} MB -> {len(blob)/1e6:.3f} MB (CR {raw/max(len(blob),1):.1f}x)")


def _cmd_stream(args) -> None:
    from repro_torch.core.codec import LogzipConfig
    from repro_torch.core.stream import StreamingCompressor
    from repro_torch.ingest.service import footer_cfg

    f, close = _open_input(args.infile)
    raw = 0
    try:
        # an append continues with the container's own settings, on --device
        cfg = footer_cfg(args.outfile, args.device) if args.append else \
            LogzipConfig(level=args.level, kernel=args.kernel, format=args.format,
                         device=args.device)
        with StreamingCompressor(args.outfile, cfg, chunk_lines=args.chunk_lines,
                                 chunk_bytes=args.chunk_bytes,
                                 append=args.append) as sc:
            for line in _iter_lines(f):
                raw += len(line.encode("utf-8", "surrogateescape")) + 1
                sc.feed_line(line)
            summary = sc.close()
    finally:
        if close:
            f.close()
    raw -= 1
    print(f"{raw/1e6:.2f} MB -> {summary['n_chunks']} chunks, "
          f"{summary['n_lines']} total lines, {summary['n_templates']} templates, "
          f"{summary['n_params']} params -> {args.outfile}")


def _cmd_unpack(args) -> None:
    from repro_torch.core.parallel import decompress_parallel
    from repro_torch.core.stream import STREAM_MAGIC, LZJSReader

    with open(args.infile, "rb") as f:
        magic = f.read(4)
    if args.salvage and magic != STREAM_MAGIC:
        sys.exit(f"--salvage needs an LZJS container; "
                 f"{args.infile} has magic {magic!r}")
    if args.range:
        if magic != STREAM_MAGIC:
            sys.exit(f"--range needs an LZJS container (footer random access); "
                     f"{args.infile} has magic {magic!r}")
        start_s, sep, count_s = args.range.partition(":")
        try:
            if not sep:
                raise ValueError
            start, count = int(start_s), int(count_s)
        except ValueError:
            sys.exit(f"--range wants START:COUNT (got {args.range!r})")
        rd = LZJSReader(args.infile, salvage=args.salvage)
        lines = rd.read_range(start, count)
        note = f" (range {start}:{count}, decoded {rd.chunks_decoded}/{len(rd)} chunks)"
        rd.close()
    elif magic == STREAM_MAGIC:
        rd = LZJSReader(args.infile, salvage=args.salvage)
        lines = rd.read_all()
        note = ""
        if args.salvage:
            lost = rd.stats().get("salvage", {}).get("lost_line_ranges") or \
                [[e["line_start"], e["line_start"] + e["n_lines"]]
                 for e in rd.index if e.get("q")]
            if lost:
                note = f" (salvage: lost line ranges {lost})"
        rd.close()
    else:
        with open(args.infile, "rb") as f:
            blob = f.read()
        lines = decompress_parallel(blob, n_workers=args.workers)
        note = ""
    with open(args.outfile, "w", encoding="utf-8", errors="surrogateescape") as f:
        f.write("\n".join(lines))
    print(f"wrote {len(lines)} lines to {args.outfile}{note}")


def _parse_range(spec: str) -> tuple[int, int]:
    start_s, sep, count_s = spec.partition(":")
    try:
        if not sep:
            raise ValueError
        start, count = int(start_s), int(count_s)
    except ValueError:
        sys.exit(f"--range wants START:COUNT (got {spec!r})")
    return start, start + count


def _build_query(args):
    from repro_torch.core import query as Q

    preds = []
    if getattr(args, "pattern", None) is not None:
        preds.append(Q.Regex(args.pattern) if args.regex else Q.Substring(args.pattern))
    if args.range:
        preds.append(Q.LineRange(*_parse_range(args.range)))
    if args.template is not None:
        preds.append(Q.EventIs(args.template))
    if getattr(args, "param_range", None):
        parts = args.param_range.split(":")
        try:
            if len(parts) != 4:
                raise ValueError
            ev, star, lo, hi = (int(p) for p in parts)
        except ValueError:
            sys.exit(f"--param-range wants EVENT:STAR:LO:HI (got {args.param_range!r})")
        preds.append(Q.ParamRange(ev, star, lo, hi))
    for fv in args.field or []:
        f, sep, v = fv.partition("=")
        if not sep or not f:
            sys.exit(f"--field wants FIELD=VALUE (got {fv!r})")
        preds.append(Q.FieldEq(f, v))
    if not preds:
        sys.exit("grep needs a PATTERN or at least one of "
                 "--range/--template/--field/--param-range")
    return Q.And(*preds) if len(preds) > 1 else preds[0]


def _cmd_grep(args) -> None:
    import json as _json

    from repro_torch.core import query as Q

    q = _build_query(args)
    if args.explain:
        for row in Q.explain(args.infile, q):
            print(f"{row['class']:6s} [{row['event'] if row['event'] is not None else '-'}] "
                  f"{row['template']}")
        for row in Q.plan(args.infile, q, salvage=args.salvage):
            verdict = "open" if row["open"] else f"skip ({row['reason']})"
            probes = f"  bloom probes {row['bloom_probes']}" if row["bloom_probes"] else ""
            print(f"chunk {row['chunk']:4d} lines [{row['lines'][0]}:"
                  f"{row['lines'][1]})  {verdict}{probes}")
        return
    stats = Q.QueryStats()
    if args.count:
        print(Q.count(args.infile, q, stats=stats, salvage=args.salvage))
    else:
        hits = Q.search(args.infile, q, stats=stats, salvage=args.salvage)
        n_out = 0
        for no, line in hits:
            if args.json:
                print(_json.dumps({"line": no, "text": line}))
            else:
                print(f"{no}:{line}")
            n_out += 1
            if args.limit and n_out >= args.limit:
                break
    if args.stats:
        _print_query_stats(stats)


def _print_query_stats(stats) -> None:
    print(f"query: {stats.hits} hits; decoded {stats.chunks_opened}/"
          f"{stats.chunks_total} chunks (skipped {stats.chunks_skipped}), "
          f"materialized {stats.rows_materialized} lines", file=sys.stderr)
    if stats.chunks_skipped_by:
        why = ", ".join(f"{k}: {v}" for k, v in
                        sorted(stats.chunks_skipped_by.items(), key=lambda kv: -kv[1]))
        print(f"query: skipped by screen -> {why}", file=sys.stderr)
    if stats.bloom_probes:
        fpp = stats.bloom_false_positives / max(stats.bloom_passes, 1)
        print(f"query: bloom probes {stats.bloom_probes}, passes "
              f"{stats.bloom_passes}, observed false positives "
              f"{stats.bloom_false_positives} ({fpp:.1%})", file=sys.stderr)
    if stats.chunks_counted_from_manifest:
        print(f"query: {stats.chunks_counted_from_manifest} chunks counted "
              f"from their manifest histogram (never opened)", file=sys.stderr)


def _cmd_agg(args) -> None:
    """Compressed-domain aggregations (DESIGN.md §14): every mode runs
    over distinct decoded values with multiplicities — no line is ever
    materialized — and ``--by-template`` needs only the footer manifests
    on screened (v3) archives."""
    import json as _json

    from repro_torch.core import query as Q

    modes = [m for m in ("by_template", "top", "top_param", "histogram")
             if getattr(args, m)]
    if len(modes) != 1:
        sys.exit("agg wants exactly one of --by-template / --top / "
                 "--top-param / --histogram")
    stats = Q.QueryStats()
    mode = modes[0]
    if mode == "by_template":
        counts = Q.count_by_template(args.infile, stats=stats,
                                     salvage=args.salvage, device=args.device)
        tpl_by_gid = {}
        try:
            from repro_torch.core.stream import LZJSReader

            rd = LZJSReader(args.infile, salvage=args.salvage)
            tpl_by_gid = {g: " ".join("<*>" if t is None else t for t in tpl)
                          for g, tpl in enumerate(rd.templates)}
            rd.close()
        except (ValueError, OSError):
            pass  # non-LZJS archive: chunk-local ids, no session store
        rows = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        for g, c in rows:
            if args.json:
                print(_json.dumps({"event": g, "count": c,
                                   "template": tpl_by_gid.get(g)}))
            else:
                print(f"{c:8d}  [{g}] {tpl_by_gid.get(g, '')}")
    elif mode == "top":
        for v, c in Q.top_k(args.infile, args.top, k=args.k, stats=stats,
                            salvage=args.salvage, device=args.device):
            print(_json.dumps({"value": v, "count": c}) if args.json
                  else f"{c:8d}  {v}")
    elif mode == "top_param":
        parts = args.top_param.split(":")
        try:
            if len(parts) != 2:
                raise ValueError
            ev, star = int(parts[0]), int(parts[1])
        except ValueError:
            sys.exit(f"--top-param wants EVENT:STAR (got {args.top_param!r})")
        for v, c in Q.top_k(args.infile, event=ev, star=star, k=args.k,
                            stats=stats, salvage=args.salvage,
                            device=args.device):
            print(_json.dumps({"value": v, "count": c}) if args.json
                  else f"{c:8d}  {v}")
    else:
        hist = Q.time_histogram(args.infile, args.histogram,
                                bucket=args.bucket, stats=stats,
                                salvage=args.salvage, device=args.device)
        for b, c in hist.items():
            if args.json:
                print(_json.dumps({"bucket": b, "start": b * args.bucket,
                                   "count": c}))
            else:
                print(f"{b * args.bucket:>12d}  {c:8d}  {'#' * min(c * 60 // max(max(hist.values()), 1), 60)}")
    if args.stats:
        _print_query_stats(stats)


def _cmd_extract(args) -> None:
    import json as _json

    from repro_torch.core.query import extract_records

    rng = _parse_range(args.range) if args.range else None
    for rec in extract_records(args.infile, event=args.template, line_range=rng):
        if args.json:
            print(_json.dumps(rec))
        else:
            params = " ".join(rec["params"])
            print(f"{rec['line']}\t{rec['event']}\t{rec['template']}\t{params}")


def _coltype_report(objects: dict, meta: dict) -> list[str]:
    """Per-column type/size/savings lines for one chunk (DESIGN.md §12).

    Typed bytes are the column's actual objects; the reference is the
    same values re-encoded under the v1 TEXT layout (sub-field split, no
    shared ParamDict), so the figure isolates what the typed codec
    bought for that column."""
    from repro_torch.core.codec import ChunkReader
    from repro_torch.core.encode import ColumnCodec

    coltypes = meta.get("coltypes") or {}
    if not coltypes:
        return []
    counts: dict[str, int] = {}
    for t in coltypes.values():
        counts[t] = counts.get(t, 0) + 1
    summary = ", ".join(f"{n} {t}" for t, n in sorted(counts.items(),
                                                      key=lambda kv: -kv[1]))
    n_typed = sum(n for t, n in counts.items() if t != "text")
    lines = [f"typed columns: {n_typed}/{len(coltypes)} ({summary})"]
    cr = ChunkReader(objects, meta)
    rows = []
    for name, t in coltypes.items():
        if t == "text":
            continue
        typed_b = sum(len(v) for k, v in objects.items()
                      if k == name or k.startswith(f"{name}."))
        if name.startswith("h."):
            n = cr.n_ok
        else:
            tk = int(name[1:name.index(".")])
            n = len(cr.events[cr.events == tk]) if len(cr.events) else 0
        try:
            values = ColumnCodec(name).decode(objects, n)
            text_b = sum(len(v) for v in ColumnCodec(name).encode(values).values())
        except Exception:
            continue
        rows.append((name, t, typed_b, text_b))
    rows.sort(key=lambda r: r[3] - r[2], reverse=True)
    for name, t, typed_b, text_b in rows:
        gain = (1 - typed_b / text_b) if text_b else 0.0
        lines.append(f"  {name:14s} {t:13s} {typed_b:7d} B vs text {text_b:7d} B"
                     f"  ({gain:+.1%})")
    return lines


def _format_report(rep: dict, as_json: bool) -> None:
    import json as _json

    if as_json:
        print(_json.dumps(rep, indent=2))
        return
    state = "clean" if rep["clean"] else "damaged"
    print(f"{state}: v{rep['version']} container, {rep['n_chunks']} chunks, "
          f"{rep['n_lines']} lines  header {'ok' if rep['header_ok'] else 'DAMAGED'}"
          f"  footer {'ok' if rep['footer_ok'] else 'DAMAGED'}")
    for k, s in enumerate(rep["chunk_status"]):
        if s != "ok":
            print(f"  chunk {k}: {', '.join(s)}")
    if rep.get("envelopes_restored"):
        print(f"restored {rep['envelopes_restored']} record envelope(s)")
    if rep.get("quarantined"):
        print(f"quarantined chunks: {rep['quarantined']}")
    if rep.get("lost_line_ranges"):
        for lo, hi in rep["lost_line_ranges"]:
            print(f"  lost lines [{lo}, {hi})")


def _cmd_fsck(args) -> None:
    from repro_torch.core.recover import fsck

    rep = fsck(args.infile)
    _format_report(rep, args.json)
    sys.exit(0 if rep["clean"] else 1)


def _cmd_repair(args) -> None:
    from repro_torch.core.recover import repair

    rep = repair(args.infile)
    _format_report(rep, args.json)


def _cmd_compact(args) -> None:
    """Merge N LZJS sessions into one sealed archive (DESIGN.md §16):
    re-clustered shared template store, fresh ParamDict, max-level
    recompression. Damaged inputs are salvaged; skipped chunks are
    reported, never silently dropped (exit 3 when lines were lost and
    --strict is set)."""
    import json as _json

    from repro_torch.lifecycle import compact

    rep = compact(args.inputs, args.outfile, level=args.level,
                  kernel=args.kernel, chunk_lines=args.chunk_lines,
                  salvage=not args.no_salvage, fold=not args.no_fold,
                  specialize=not args.no_specialize, device=args.device)
    d = rep.to_dict()
    if args.json:
        print(_json.dumps(d, indent=2))
    else:
        rc = d["recluster"]
        ratio = d["ratio_vs_inputs"]
        print(f"compacted {len(rep.inputs)} inputs -> {rep.out}: "
              f"{d['n_lines']} lines, {d['bytes_in']} -> {d['bytes_out']} B"
              + (f" ({ratio:.2f}x vs summed inputs)" if ratio else ""))
        print(f"templates: {rc.get('templates_in', 0)} in -> "
              f"{rc.get('templates_out', 0)} out "
              f"({rc.get('dead', 0)} dead, {rc.get('folded', 0)} folded, "
              f"{rc.get('specialized', 0)} specialized)")
        for s in rep.skipped:
            print(f"  skipped {s['input']} chunk {s['chunk']}: "
                  f"lines [{s['line_start']}, "
                  f"{s['line_start'] + s['n_lines']}): {s['why']}")
        if rep.lost_lines:
            print(f"lost {rep.lost_lines} lines to damaged input chunks")
    if rep.lost_lines and args.strict:
        sys.exit(3)


def _cmd_serve(args) -> None:
    """Run the multi-tenant ingestion daemon (DESIGN.md §15) until
    SIGTERM/SIGINT. First signal = graceful drain (stop admitting,
    flush, seal every tenant session); second = forced abort — crash-
    equivalent, the per-tenant WAL carries recovery on the next start."""
    import signal
    import threading

    from repro_torch.core.codec import LogzipConfig
    from repro_torch.ingest.service import IngestDaemon

    cfg = LogzipConfig(level=args.level, kernel=args.kernel,
                       format=args.format, device=args.device) if args.format else None
    retention = None
    if args.retention:
        from repro_torch.lifecycle import RetentionManager, RetentionPolicy

        retention = RetentionManager(
            args.root, RetentionPolicy(rollup_after=args.rollup_after))
    address = (args.host, args.port) if args.port is not None else args.socket
    daemon = IngestDaemon(args.root, address, cfg=cfg,
                          chunk_lines=args.chunk_lines,
                          queue_lines=args.queue_lines,
                          max_tenants=args.max_tenants,
                          retention=retention, device=args.device).start()
    print(f"serving {args.root} on {daemon.address}", flush=True)

    def _term(signum, frame):
        threading.Thread(target=daemon.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    daemon.wait()
    print("drained")


def _cmd_inspect(args) -> None:
    from repro_torch.core.codec import open_container, read_structured
    from repro_torch.core.parallel import MULTI_MAGIC, iter_multi_chunks
    from repro_torch.core.stream import STREAM_MAGIC, LZJSReader

    with open(args.infile, "rb") as f:
        blob = f.read()
    if blob[:4] == STREAM_MAGIC:
        rd = LZJSReader(io.BytesIO(blob))
        s = rd.stats()
        print(f"LZJS stream: {s['n_lines']} lines in {s['n_chunks']} chunks  "
              f"level: {s['level']}  kernel: {s['kernel']}  "
              f"v{s['version']}" + ("" if s["version"] < 3 else " (checksummed)"))
        print(f"session store: {s['n_templates']} templates, {s['n_params']} params")
        for k, e in enumerate(s["chunks"][:args.max_chunks]):
            crc = s["crc"][k]
            tag = "" if crc in ("ok", "n/a") else f"  crc: {crc}"
            print(f"  chunk {k:3d}: lines [{e['line_start']}, "
                  f"{e['line_start']+e['n_lines']})  +{e['n_delta']} templates  "
                  f"+{e.get('pd_delta', 0)} params  match {e['match_rate']:.3f}{tag}")
        if len(s["chunks"]) > args.max_chunks:
            print(f"  ... {len(s['chunks']) - args.max_chunks} more chunks")
        # per-column type/savings breakdown of the first chunk (v2 only)
        if len(rd):
            objects, meta = open_container(rd.chunk_blob(0))
            for line in _coltype_report(objects, meta):
                print(line)
        for t in rd.templates[:args.max_templates]:
            print("  ", " ".join("<*>" if x is None else x for x in t))
        return
    if blob[:4] == MULTI_MAGIC:
        total_lines = 0
        rates = []
        all_templates: set[str] = set()
        rows = []
        for k, part in enumerate(iter_multi_chunks(blob)):
            s = read_structured(part)
            n = s["meta"]["n"]
            total_lines += n
            rates.append((s["match_rate"] or 0.0, n))
            all_templates.update(s["templates"])
            rows.append((k, n, len(s["templates"]), s["match_rate"]))
        agg = sum(r * n for r, n in rates) / max(total_lines, 1)
        print(f"LZJM multi-chunk archive: {total_lines} lines in {len(rows)} chunks  "
              f"distinct templates: {len(all_templates)}  "
              f"line-weighted match_rate: {agg:.3f}")
        for k, n, t, r in rows[:args.max_chunks]:
            print(f"  chunk {k:3d}: {n} lines  {t} templates  match {r:.3f}")
        if len(rows) > args.max_chunks:
            print(f"  ... {len(rows) - args.max_chunks} more chunks")
        objects, meta = open_container(next(iter_multi_chunks(blob)))
        for line in _coltype_report(objects, meta):
            print(line)
        return
    s = read_structured(blob)
    print(f"lines: {s['meta']['n']}  level: {s['meta']['level']}  "
          f"templates: {len(s['templates'])}  match_rate: {s['match_rate']:.3f}")
    objects, meta = open_container(blob)
    for line in _coltype_report(objects, meta):
        print(line)
    for t in s["templates"][:args.max_templates]:
        print("  ", t)


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run: cuda (default; fails where "
                        "there is no card) or cpu (their plain torch versions)")


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack", help="batch compress a file ('-' = stdin)")
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("--format", default=None)
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--kernel", default="gzip", choices=["gzip", "bzip2", "lzma"])
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--chunk-lines", type=int, default=None)
    p.add_argument("--shared-store", action="store_true",
                   help="seed one TemplateStore from a sample and share it "
                        "across all chunks (cross-chunk EventID stability)")
    _device_arg(p)
    s = sub.add_parser("stream", help="streaming session -> LZJS ('-' = stdin)")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--format", default=None)
    s.add_argument("--level", type=int, default=3)
    s.add_argument("--kernel", default="gzip", choices=["gzip", "bzip2", "lzma"])
    s.add_argument("--chunk-lines", type=int, default=8192)
    s.add_argument("--chunk-bytes", type=int, default=8 << 20)
    s.add_argument("--append", action="store_true",
                   help="extend an existing LZJS container in place")
    _device_arg(s)
    u = sub.add_parser("unpack", help="decode LZJF / LZJM / LZJS")
    u.add_argument("infile")
    u.add_argument("outfile")
    u.add_argument("--workers", type=int, default=1)
    u.add_argument("--range", default=None, metavar="START:COUNT",
                   help="decode only this line range (LZJS footer random access)")
    u.add_argument("--salvage", action="store_true",
                   help="read a damaged LZJS container via the scan-rebuilt "
                        "index (surviving chunks only)")
    i = sub.add_parser("inspect", help="per-archive / per-chunk stats")
    i.add_argument("infile")
    i.add_argument("--max-chunks", type=int, default=20)
    i.add_argument("--max-templates", type=int, default=20)
    g = sub.add_parser("grep", help="compressed-domain search (template pushdown)")
    g.add_argument("infile")
    g.add_argument("pattern", nargs="?", default=None,
                   help="fixed string (default) or regex with --regex")
    g.add_argument("--regex", action="store_true", help="treat PATTERN as a regex")
    g.add_argument("--count", action="store_true", help="print only the hit count")
    g.add_argument("--range", default=None, metavar="START:COUNT",
                   help="restrict to a global line range")
    g.add_argument("--template", type=int, default=None, metavar="K",
                   help="restrict to EventID K")
    g.add_argument("--param-range", default=None, metavar="EVENT:STAR:LO:HI",
                   help="integer range over one parameter column; typed "
                        "numeric columns answer from manifest bounds "
                        "(chunks outside the range are never decoded)")
    g.add_argument("--field", action="append", default=None, metavar="F=V",
                   help="header-field equality (repeatable)")
    g.add_argument("--json", action="store_true", help="JSON-lines output")
    g.add_argument("--limit", type=int, default=None, help="stop after N hits")
    g.add_argument("--stats", action="store_true",
                   help="print chunks-decoded accounting to stderr")
    g.add_argument("--explain", action="store_true",
                   help="print the per-template pushdown classification and exit")
    g.add_argument("--salvage", action="store_true",
                   help="query a damaged LZJS container (surviving chunks only)")
    a = sub.add_parser("agg", help="compressed-domain aggregations "
                                   "(counts/top-k/histogram, no materialization)")
    a.add_argument("infile")
    a.add_argument("--by-template", action="store_true",
                   help="line count per EventID (manifest histograms: "
                        "v3 archives never open a chunk)")
    a.add_argument("--top", default=None, metavar="FIELD",
                   help="top-k values of a header field")
    a.add_argument("--top-param", default=None, metavar="EVENT:STAR",
                   help="top-k values of one template's parameter column")
    a.add_argument("--histogram", default=None, metavar="FIELD",
                   help="integer histogram of a header field (e.g. a timestamp)")
    a.add_argument("--bucket", type=int, default=60,
                   help="histogram bucket width (default 60)")
    a.add_argument("-k", type=int, default=10, help="top-k size (default 10)")
    a.add_argument("--json", action="store_true", help="JSON-lines output")
    a.add_argument("--stats", action="store_true",
                   help="print chunks-decoded accounting to stderr")
    a.add_argument("--salvage", action="store_true",
                   help="aggregate a damaged LZJS container "
                        "(surviving chunks only)")
    _device_arg(a)
    x = sub.add_parser("extract", help="structured records (line/EventID/params)")
    x.add_argument("infile")
    x.add_argument("--template", type=int, default=None, metavar="K")
    x.add_argument("--range", default=None, metavar="START:COUNT")
    x.add_argument("--json", action="store_true", help="JSON-lines output")
    fk = sub.add_parser("fsck", help="diagnose an LZJS container (read-only; "
                                     "exit 1 when damaged)")
    fk.add_argument("infile")
    fk.add_argument("--json", action="store_true", help="full report as JSON")
    rp = sub.add_parser("repair", help="repair an LZJS container in place "
                                       "(rebuild footer, restore envelopes, "
                                       "quarantine damaged chunks)")
    rp.add_argument("infile")
    rp.add_argument("--json", action="store_true", help="full report as JSON")
    sv = sub.add_parser("serve", help="multi-tenant ingestion daemon "
                                      "(write-ahead durable; SIGTERM drains, "
                                      "a second SIGTERM force-aborts)")
    sv.add_argument("root", help="directory for per-tenant archives + WALs")
    sv.add_argument("--socket", default=None, metavar="PATH",
                    help="unix socket path (default ROOT/ingest.sock)")
    sv.add_argument("--port", type=int, default=None,
                    help="listen on TCP instead of a unix socket")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--format", default=None,
                    help="default log format for new tenants (HELLO cfg wins)")
    sv.add_argument("--level", type=int, default=3)
    sv.add_argument("--kernel", default="gzip", choices=["gzip", "bzip2", "lzma"])
    sv.add_argument("--chunk-lines", type=int, default=4096)
    sv.add_argument("--queue-lines", type=int, default=1024,
                    help="bounded per-tenant queue (backpressure above it)")
    sv.add_argument("--max-tenants", type=int, default=64)
    sv.add_argument("--retention", action="store_true",
                    help="run the tiered retention policy on tenant "
                         "roll-over (hot -> sealed -> rollup)")
    sv.add_argument("--rollup-after", type=int, default=4,
                    help="sealed segments per rollup window (with "
                         "--retention; default 4)")
    _device_arg(sv)
    cp = sub.add_parser("compact", help="merge N LZJS sessions into one "
                                        "sealed archive (re-clustered shared "
                                        "store, max-level recompression; "
                                        "salvages damaged inputs)")
    cp.add_argument("outfile")
    cp.add_argument("inputs", nargs="+", help="input .lzjs sessions "
                                              "(may be damaged/repaired)")
    cp.add_argument("--level", type=int, default=3)
    cp.add_argument("--kernel", default="lzma",
                    choices=["gzip", "bzip2", "lzma"])
    cp.add_argument("--chunk-lines", type=int, default=16384)
    cp.add_argument("--no-salvage", action="store_true",
                    help="fail on damaged inputs instead of skipping "
                         "and reporting their chunks")
    cp.add_argument("--no-fold", action="store_true",
                    help="disable cross-session near-duplicate template "
                         "folding")
    cp.add_argument("--no-specialize", action="store_true",
                    help="disable constant-star template specialization")
    cp.add_argument("--strict", action="store_true",
                    help="exit 3 when any input lines were lost")
    cp.add_argument("--json", action="store_true", help="report as JSON")
    _device_arg(cp)
    args = ap.parse_args()
    if hasattr(args, "device"):
        from repro_torch.kernels.ops import check_device

        check_device(args.device)  # raises before any file is touched

    try:
        {"pack": _cmd_pack, "stream": _cmd_stream, "unpack": _cmd_unpack,
         "inspect": _cmd_inspect, "grep": _cmd_grep, "agg": _cmd_agg,
         "extract": _cmd_extract, "serve": _cmd_serve,
         "fsck": _cmd_fsck, "repair": _cmd_repair,
         "compact": _cmd_compact}[args.cmd](args)
    except BrokenPipeError:
        raise  # handled by the __main__ guard (exit 0, not an error)
    except (OSError, ValueError) as e:
        # operational failures (missing file, bad magic, damaged input,
        # append onto a non-LZJS target) are one-line diagnostics with a
        # distinct exit code — never tracebacks
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from e


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # e.g. `inspect ... | head`
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
