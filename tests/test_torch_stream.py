"""The port's streaming (LZJS) and multi-chunk (LZJM) containers against
the JAX package's, byte for byte.

The port runs on ``device="cpu"`` here, where each kernel wrapper runs its
plain torch version. It must rebuild the committed golden LZJS and LZJM
fixtures from the recipes of ``tests/fixture_defs.py``; each package
must read the other's archives; append, ``iter_stream``, ``read_range``
and salvage must behave as the reference's on one loggen corpus with
small chunks; and ``compress_parallel`` through its spawned worker pool
must write what the serial path writes.
"""

import dataclasses
import io

import fixture_defs as fd
import pytest

from repro.core import codec as rcodec
from repro.core import parallel as rparallel
from repro.core import recover as rrecover
from repro.core import stream as rstream
from repro.core.ise import ISEConfig as RISEConfig
from repro.data import loggen as rloggen
from repro_torch.core import codec, parallel, recover, stream
from repro_torch.core.ise import ISEConfig

FMT = rloggen.DATASETS["Spark"]["format"]
N_LINES = 1500
CHUNK_LINES = 200
_LINES: list = []


def corpus() -> list[str]:
    if not _LINES:
        _LINES.extend(rloggen.generate_lines("Spark", N_LINES, seed=21))
    return _LINES


def cfgs(**kw):
    """The same settings as a reference and a port (device="cpu") config."""
    ise = dict(min_sample=100, max_iters=2, seed=0)
    ref = rcodec.LogzipConfig(format=FMT, ise=RISEConfig(**ise), **kw)
    port = codec.LogzipConfig(format=FMT, ise=ISEConfig(**ise), device="cpu", **kw)
    return ref, port


def lzjs(mod, lines, cfg, **kw) -> bytes:
    buf = io.BytesIO()
    with mod.StreamingCompressor(buf, cfg, chunk_lines=kw.pop("chunk_lines", CHUNK_LINES),
                                 **kw) as sc:
        sc.feed(lines)
    return buf.getvalue()


def port_fixture_cfg(typed, integrity, screens=False):
    ref = fd.fixture_cfg(typed, integrity, screens)
    return codec.LogzipConfig(
        level=ref.level, kernel=ref.kernel, format=ref.format,
        ise=ISEConfig(min_sample=ref.ise.min_sample, max_iters=ref.ise.max_iters,
                      seed=ref.ise.seed),
        typed_columns=typed, integrity=integrity, screens=screens, device="cpu")


@pytest.mark.parametrize("ext,typed,integrity,screens", [
    ("lzjs", False, False, False), ("v2.lzjs", True, False, False),
    ("v3.lzjs", True, True, False), ("v3s.lzjs", True, True, True),
    ("lzjm", False, False, False), ("v2.lzjm", True, False, False),
    ("v3.lzjm", True, True, False)])
def test_golden_fixtures(ext, typed, integrity, screens):
    cfg = port_fixture_cfg(typed, integrity, screens)
    lines = fd.fixture_lines()
    if ext.endswith("lzjs"):
        got = lzjs(stream, lines, cfg, chunk_lines=fd.CHUNK_LINES)
    else:
        got = parallel.compress_parallel(lines, cfg, n_workers=1, chunk_lines=fd.CHUNK_LINES)
    with open(fd.fixture_path(ext), "rb") as f:
        golden = f.read()
    assert got == golden
    assert parallel.decompress_parallel(golden) == lines


VARIANTS = {"v1": dict(typed_columns=False, integrity=False),
            "v2": dict(typed_columns=True, integrity=False),
            "v3": dict(integrity=True, screens=False),
            "v3s": dict(integrity=True, screens=True),
            "level2": dict(level=2),
            "level1": dict(level=1)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lzjs_equals_reference_and_each_reads_the_other(variant):
    lines = corpus() + ["", "no header here", "x" * 300]
    ref_cfg, port_cfg = cfgs(**VARIANTS[variant])
    blob = lzjs(stream, lines, port_cfg)
    assert blob == lzjs(rstream, lines, ref_cfg)
    assert rstream.decompress_lzjs(blob) == lines
    assert stream.decompress_lzjs(lzjs(rstream, lines, ref_cfg)) == lines
    assert lzjs(stream, lines, port_cfg, pipeline=False) == blob


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "level1"])
def test_lzjm_equals_reference_and_each_reads_the_other(variant):
    lines = corpus()
    ref_cfg, port_cfg = cfgs(**VARIANTS[variant])
    blob = parallel.compress_parallel(lines, port_cfg, chunk_lines=400)
    assert blob == rparallel.compress_parallel(lines, ref_cfg, chunk_lines=400)
    assert rparallel.decompress_parallel(blob) == lines
    assert parallel.decompress_parallel(
        rparallel.compress_parallel(lines, ref_cfg, chunk_lines=400)) == lines
    assert list(parallel.iter_multi_chunks(blob)) == list(rparallel.iter_multi_chunks(blob))


def test_shared_store_equals_reference():
    lines = corpus()
    ref_cfg, port_cfg = cfgs()
    assert parallel.seed_template_store(lines, port_cfg).templates == \
        rparallel.seed_template_store(lines, ref_cfg).templates
    blob = parallel.compress_parallel(lines, port_cfg, chunk_lines=500, shared_store=True)
    assert blob == rparallel.compress_parallel(lines, ref_cfg, chunk_lines=500,
                                               shared_store=True)


def test_spawned_workers_equal_the_serial_path(monkeypatch):
    """Two spawned workers write the archive the serial path writes, and
    no task was retried (a retry would mean the pool failed)."""
    def no_retry(_delay):
        raise AssertionError("the worker pool failed and a task was retried")

    monkeypatch.setattr(parallel, "DEFAULT_RETRY_POLICY",
                        dataclasses.replace(parallel.DEFAULT_RETRY_POLICY, sleep=no_retry))
    lines = corpus()[:900]
    _, port_cfg = cfgs()
    blob = parallel.compress_parallel(lines, port_cfg, n_workers=2, chunk_lines=300)
    assert blob == parallel.compress_parallel(lines, port_cfg, n_workers=1, chunk_lines=300)
    assert parallel.decompress_parallel(blob, n_workers=2) == lines


def test_iter_stream_and_read_range_equal_reference():
    lines = corpus()
    ref_cfg, _ = cfgs()
    blob = lzjs(rstream, lines, ref_cfg)
    assert list(stream.iter_stream(io.BytesIO(blob))) == \
        list(rstream.iter_stream(io.BytesIO(blob))) == lines
    rd, rrd = stream.LZJSReader(io.BytesIO(blob)), rstream.LZJSReader(io.BytesIO(blob))
    assert rd.templates == rrd.templates and rd.params == rrd.params
    for start, n in [(0, 1), (615, 700), (1499, 50), (400, 200)]:
        assert rd.read_range(start, n) == rrd.read_range(start, n) == lines[start:start + n]
        assert rd.covering_chunks(start, n) == rrd.covering_chunks(start, n)
    assert rd.chunks_decoded == rrd.chunks_decoded
    assert [rd.manifest(k) for k in range(len(rd))] == \
        [rrd.manifest(k) for k in range(len(rrd))]
    assert rd.stats() == rrd.stats()


def test_append_equals_reference(tmp_path):
    lines = corpus()
    ref_cfg, port_cfg = cfgs()
    paths = {}
    for name, mod, cfg in (("port", stream, port_cfg), ("ref", rstream, ref_cfg)):
        path = str(tmp_path / f"{name}.lzjs")
        with mod.StreamingCompressor(path, cfg, chunk_lines=CHUNK_LINES) as sc:
            sc.feed(lines[:700])
        with mod.StreamingCompressor(path, cfg, chunk_lines=CHUNK_LINES, append=True) as sc:
            sc.feed(lines[700:])
        paths[name] = path
    blob = (tmp_path / "port.lzjs").read_bytes()
    assert blob == (tmp_path / "ref.lzjs").read_bytes()
    rd = stream.LZJSReader(paths["port"])
    assert rd.read_all() == lines
    rd.close()


@pytest.mark.parametrize("damage", ["footer", "torn_tail"])
def test_salvage_equals_reference(damage):
    lines = corpus()
    ref_cfg, _ = cfgs()
    blob = lzjs(rstream, lines, ref_cfg)
    dead = blob[:-12] + b"\x00" * 12 if damage == "footer" else blob[:len(blob) * 3 // 4]
    with pytest.raises(ValueError):
        stream.LZJSReader(io.BytesIO(dead))
    rd = stream.LZJSReader(io.BytesIO(dead), salvage=True)
    rrd = rstream.LZJSReader(io.BytesIO(dead), salvage=True)
    assert rd.salvage_report == rrd.salvage_report
    assert rd.index == rrd.index and rd.n_lines == rrd.n_lines
    got = rd.read_all()
    assert got == rrd.read_all() and got == lines[:len(got)] and got
    assert recover.fsck(io.BytesIO(dead)) == rrecover.fsck(io.BytesIO(dead))
