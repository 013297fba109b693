"""The port's batch codec against the JAX package's, byte for byte.

The port runs on ``device="cpu"`` here, where each kernel wrapper runs its
plain torch version. Its archives must equal the reference's: with the
reference's kernels off (numpy host path) on loggen corpora of all five
datasets, levels and column layouts; with the reference's Pallas kernels
on (interpret mode, slow, so two datasets); and the committed golden
LZJF fixtures. Each package must read the other's archives.
"""

import fixture_defs as fd
import jax
import numpy as np
import pytest

from repro.core import codec as rcodec
from repro.core import templates as rtemplates
from repro.core.ise import ISEConfig as RISEConfig
from repro.data import loggen as rloggen
from repro_torch.core import codec
from repro_torch.core.ise import ISEConfig
from repro_torch.core.templates import TemplateStore, extract_templates
from repro_torch.data import loggen

DATASETS = list(rloggen.DATASETS)
N_LINES = 2000
_LINES: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """The reference's 2,000-line compresses trace its jitted column
    transform at the (8, 2048) bucket. Left in JAX's caches, that trace
    would make a later test in the same worker that counts its own traces
    of that bucket (tests/test_coltypes.py::test_kernel_bucketed_no_retrace)
    count none, so the caches are dropped when this module is done."""
    yield
    jax.clear_caches()


def lines_of(ds: str, n: int = N_LINES, seed: int = 5) -> list[str]:
    key = (ds, n, seed)
    if key not in _LINES:
        _LINES[key] = list(rloggen.generate_lines(ds, n, seed=seed))
    return _LINES[key]


def cfgs(ds, level=3, typed=True, use_kernel=False, **kw):
    fmt = rloggen.DATASETS[ds]["format"]
    ref = rcodec.LogzipConfig(level=level, format=fmt, typed_columns=typed,
                              ise=RISEConfig(use_kernel=use_kernel), **kw)
    port = codec.LogzipConfig(level=level, format=fmt, typed_columns=typed, device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("typed", [True, False])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("ds", DATASETS)
def test_compress_equals_reference_host_path(ds, level, typed):
    lines = lines_of(ds)
    ref_cfg, port_cfg = cfgs(ds, level, typed)
    blob = codec.compress(lines, port_cfg)
    assert blob == rcodec.compress(lines, ref_cfg)
    assert codec.decompress(blob) == lines


@pytest.mark.parametrize("ds", ["HDFS", "Spark"])
def test_compress_equals_reference_kernel_path(ds):
    """The reference with its Pallas kernels on (interpret mode) writes the
    same bytes as the port's kernel path."""
    lines = lines_of(ds)
    ref_cfg, port_cfg = cfgs(ds, use_kernel=True)
    assert codec.compress(lines, port_cfg) == rcodec.compress(lines, ref_cfg)


def test_kernel_path_equals_host_path():
    """ISEConfig.use_kernel is on by default in the port; off, the numpy
    host path writes the same archive."""
    assert ISEConfig().use_kernel
    lines = lines_of("Android")
    _, port_cfg = cfgs("Android")
    off = codec.LogzipConfig(format=port_cfg.format, device="cpu",
                             ise=ISEConfig(use_kernel=False))
    assert codec.compress(lines, port_cfg) == codec.compress(lines, off)


@pytest.mark.parametrize("ext,typed,integrity", [
    ("lzjf", False, False), ("v2.lzjf", True, False), ("v3.lzjf", True, True)])
def test_golden_fixtures(ext, typed, integrity):
    ref_cfg = fd.fixture_cfg(typed, integrity)
    cfg = codec.LogzipConfig(
        level=ref_cfg.level, kernel=ref_cfg.kernel, format=ref_cfg.format,
        ise=ISEConfig(min_sample=ref_cfg.ise.min_sample, max_iters=ref_cfg.ise.max_iters,
                      seed=ref_cfg.ise.seed),
        typed_columns=typed, integrity=integrity, screens=ref_cfg.screens, device="cpu")
    with open(fd.fixture_path(ext), "rb") as f:
        golden = f.read()
    lines = fd.fixture_lines()
    assert codec.compress(lines, cfg) == golden
    assert codec.decompress(golden) == lines


@pytest.mark.parametrize("level,typed,integrity,kernel", [
    (1, True, True, "gzip"), (2, False, False, "bzip2"), (3, False, True, "lzma"),
    (3, True, True, "gzip"), (3, True, False, "none")])
def test_each_package_reads_the_others_archives(level, typed, integrity, kernel):
    lines = lines_of("Thunderbird", 600) + ["", "no header here", "x" * 300]
    ref_cfg, port_cfg = cfgs("Thunderbird", level, typed, integrity=integrity, kernel=kernel)
    assert codec.decompress(rcodec.compress(lines, ref_cfg)) == lines
    assert rcodec.decompress(codec.compress(lines, port_cfg)) == lines
    objs, meta = codec.open_container(rcodec.compress(lines, ref_cfg))
    assert "device" not in meta and meta == rcodec.open_container(
        codec.compress(lines, port_cfg))[1]


def test_template_store_carried_from_reference():
    """The carried state (paper §III-E): a store extracted by the JAX
    package, carried into the port, compresses new logs to the same bytes."""
    fmt = rloggen.DATASETS["HDFS"]["format"]
    ref_store = rtemplates.extract_templates(lines_of("HDFS", 1500, seed=1), fmt)
    store = TemplateStore.from_reference(ref_store.templates)
    assert store.templates == ref_store.templates and len(store) == len(ref_store)
    new = lines_of("HDFS", 800, seed=2)
    ref_cfg = rcodec.LogzipConfig(format=fmt, template_store=ref_store)
    cfg = codec.LogzipConfig(format=fmt, template_store=store, device="cpu")
    blob = codec.compress(new, cfg)
    assert blob == rcodec.compress(new, ref_cfg)
    assert codec.decompress(blob) == new and rcodec.decompress(blob) == new
    port_store = extract_templates(lines_of("HDFS", 1500, seed=1), fmt, device="cpu")
    assert port_store.templates == ref_store.templates
    with pytest.raises(TypeError):
        TemplateStore.from_reference([("a", 3)])


@pytest.mark.parametrize("ds", DATASETS)
def test_loggen_copy_yields_reference_bytes(ds):
    assert list(loggen.generate_lines(ds, 700, seed=9)) == lines_of(ds, 700, seed=9)
    assert loggen.DATASETS[ds]["format"] == rloggen.DATASETS[ds]["format"]


def test_loggen_workload_copy_yields_reference_bytes():
    spec = loggen.WorkloadSpec(n_templates=12, zipf_s=1.1, cardinality_ramp=0.2,
                               burstiness=0.3, malformed_rate=0.01)
    rspec = rloggen.WorkloadSpec(n_templates=12, zipf_s=1.1, cardinality_ramp=0.2,
                                 burstiness=0.3, malformed_rate=0.01)
    assert list(loggen.generate_workload(spec, 500, seed=4)) == \
        list(rloggen.generate_workload(rspec, 500, seed=4))


def test_file_api_and_stage_times(tmp_path):
    lines = lines_of("Spark", 500)
    src = tmp_path / "in.log"
    src.write_text("\n".join(lines), encoding="utf-8")
    ref_cfg, port_cfg = cfgs("Spark")
    info = codec.compress_file(str(src), str(tmp_path / "port.lzj"), port_cfg)
    rinfo = rcodec.compress_file(str(src), str(tmp_path / "ref.lzj"), ref_cfg)
    assert info == rinfo
    assert (tmp_path / "port.lzj").read_bytes() == (tmp_path / "ref.lzj").read_bytes()
    codec.decompress_file(str(tmp_path / "port.lzj"), str(tmp_path / "out.log"))
    assert (tmp_path / "out.log").read_text(encoding="utf-8") == src.read_text(encoding="utf-8")
    st, rst = {}, {}
    codec.compress(lines, port_cfg, stage_times=st)
    rcodec.compress(lines, ref_cfg, stage_times=rst)
    assert set(st) == set(rst) and all(v >= 0 for v in st.values())


def test_chunk_reader_matches_reference():
    lines = lines_of("HDFS", 600)
    ref_cfg, _ = cfgs("HDFS")
    blob = rcodec.compress(lines, ref_cfg)
    reader = codec.ChunkReader(*codec.open_container(blob))
    rreader = rcodec.ChunkReader(*rcodec.open_container(blob))
    assert reader.templates == rreader.templates
    np.testing.assert_array_equal(reader.events, rreader.events)
    assert [reader.line(i) for i in (0, 17, 599)] == [lines[i] for i in (0, 17, 599)]
    assert reader.header_column("Pid") == rreader.header_column("Pid")
