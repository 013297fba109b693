"""The port's compression baselines against the JAX package's, byte for byte.

``repro_torch.core.baselines`` is an exact copy of ``repro.core.baselines``
on the port's codec kernels and encoders: each baseline must give the
reference's bytes on a loggen corpus, and decompress to the lines.
"""

import pytest

from repro.core import baselines as rbaselines
from repro.data.loggen import generate_lines
from repro_torch.core import baselines

KERNELS = ["gzip", "bzip2", "lzma"]


@pytest.fixture(scope="module")
def corpora():
    return {name: list(generate_lines(name, 1500, seed=9)) for name in ("HDFS", "Spark")}


@pytest.mark.parametrize("dataset", ["HDFS", "Spark"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", ["kernel_baseline", "logarchive_like", "cowic_like"])
def test_baseline_bytes_equal_reference_and_round_trip(corpora, dataset, kernel, name):
    lines = corpora[dataset]
    blob = getattr(baselines, name)(lines, kernel)
    assert blob == getattr(rbaselines, name)(lines, kernel)
    assert getattr(baselines, f"{name}_decompress")(blob, kernel) == lines


@pytest.mark.parametrize("lines", [["one line"], ["a b", "", "c  d e", "a b"],
                                   ["x " * 40 + "tail"] * 3])
def test_baselines_round_trip_odd_inputs(lines):
    for name in ("kernel_baseline", "logarchive_like", "cowic_like"):
        blob = getattr(baselines, name)(lines)
        assert blob == getattr(rbaselines, name)(lines)
        assert getattr(baselines, f"{name}_decompress")(blob) == lines


def test_baseline_options_equal_reference(corpora):
    lines = corpora["HDFS"][:400]
    assert baselines.logarchive_like(lines, n_buckets=4, window=2) == \
        rbaselines.logarchive_like(lines, n_buckets=4, window=2)
    blob = baselines.cowic_like(lines, max_cols=6)
    assert blob == rbaselines.cowic_like(lines, max_cols=6)
    assert baselines.cowic_like_decompress(blob, max_cols=6) == lines
