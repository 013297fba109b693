"""The port's data pipeline against the JAX package's.

``repro_torch.data.pipeline`` copies ``repro.data.pipeline``: its shard
writers compress through the port's codec on ``cfg.device`` (here
``"cpu"``), and ``TokenBatcher`` yields ``torch.int32`` tensors on its
``device``. Each package writes the same corpus into a directory of its
own: every shard file, the LZJS container and both manifests must be
equal byte for byte, and the readers and batchers must give equal
tokens, state and events.

The ``PrefetchLoader`` cases hold readers with ``threading.Event``s, not
sleeps, and use straggler timeouts of seconds, so the order of events
does not depend on the load of the machine.
"""

import filecmp
import json
import os
import queue
import threading

import numpy as np
import pytest
import torch

from repro.core.codec import LogzipConfig as RLogzipConfig
from repro.core.ise import ISEConfig as RISEConfig
from repro.data import pipeline as rpipeline
from repro.data.loggen import DATASETS, generate_lines
from repro_torch.core.codec import LogzipConfig
from repro_torch.core.ise import ISEConfig
from repro_torch.data import pipeline
from repro_torch.data.pipeline import PrefetchLoader, TokenBatcher, read_shard

# the HDFS cases of tests/test_pipeline.py; Spark as examples/train_lm_on_logs.py
CASES = {"HDFS": (2400, 800, 100), "Spark": (3000, 1000, 300)}
TIMEOUT = 3.0  # straggler timeout of the PrefetchLoader cases, seconds


def _write(pkg, cfg_cls, ise_cls, dataset, root, **cfg_kw):
    n, shard_lines, min_sample = CASES[dataset]
    dirs = {}
    for kind, writer in (("files", pkg.write_logzip_shards), ("stream", pkg.write_logzip_stream)):
        d = os.path.join(root, kind)
        cfg = cfg_cls(level=3, format=DATASETS[dataset]["format"],
                      ise=ise_cls(min_sample=min_sample), **cfg_kw)
        manifest = writer(generate_lines(dataset, n, seed=5), d, shard_lines=shard_lines, cfg=cfg)
        dirs[kind] = (d, manifest)
    return dirs


@pytest.fixture(scope="module", params=list(CASES))
def written(request, tmp_path_factory):
    dataset = request.param
    root = tmp_path_factory.mktemp(f"pipeline-{dataset}")
    ref = _write(rpipeline, RLogzipConfig, RISEConfig, dataset, str(root / "ref"))
    port = _write(pipeline, LogzipConfig, ISEConfig, dataset, str(root / "port"), device="cpu")
    return dataset, ref, port


def test_shards_and_manifests_equal_reference(written):
    _, ref, port = written
    for kind in ("files", "stream"):
        (rd, rman), (pd, pman) = ref[kind], port[kind]
        assert pman == rman
        names = sorted(os.listdir(rd))
        assert sorted(os.listdir(pd)) == names
        match, mismatch, errors = filecmp.cmpfiles(rd, pd, names, shallow=False)
        assert (mismatch, errors) == ([], []) and len(match) == len(names)
    assert len(port["files"][1]["shards"]) == len(port["stream"][1]["shards"]) == 3
    assert port["stream"][1]["container"] == "corpus.lzjs"


@pytest.mark.parametrize("mode", ["bytes", "events"])
def test_read_shard_equals_reference(written, mode):
    _, ref, port = written
    for kind in ("files", "stream"):
        for shard in port[kind][1]["shards"]:
            got = read_shard(os.path.join(port[kind][0], shard["file"]), mode)
            want = rpipeline.read_shard(os.path.join(ref[kind][0], shard["file"]), mode)
            assert len(got) == len(want)
            if mode == "bytes":
                assert len(got) == shard["n_lines"]
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_stream_chunks_decode_the_file_shards(written):
    _, _, port = written
    for fs, ss in zip(port["files"][1]["shards"], port["stream"][1]["shards"]):
        a = read_shard(os.path.join(port["files"][0], fs["file"]), "bytes")
        b = read_shard(os.path.join(port["stream"][0], ss["file"]), "bytes")
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_stream_events_are_session_global(written):
    from repro_torch.core.stream import LZJSReader

    _, _, port = written
    rd = LZJSReader(os.path.join(port["stream"][0], "corpus.lzjs"))
    n = len(rd.templates)
    rd.close()
    for shard in port["stream"][1]["shards"]:
        ev = read_shard(os.path.join(port["stream"][0], shard["file"]), "events")[0]
        assert ev.dtype == np.int32 and ev.min() >= 0 and ev.max() < n
        assert 0 < len(ev) <= shard["n_lines"]  # lines the header regex parsed


@pytest.mark.parametrize("kind", ["files", "stream"])
@pytest.mark.parametrize("mode,batch,seq", [("bytes", 2, 96), ("events", 2, 32)])
def test_batcher_equals_reference_and_resumes(written, kind, mode, batch, seq):
    _, ref, port = written
    want = rpipeline.TokenBatcher(ref[kind][0], mode=mode, seed=3)
    got = TokenBatcher(port[kind][0], mode=mode, seed=3, device="cpu")
    state = None
    for i in range(10):
        if i == 5:
            state = got.state_dict()
            assert state == want.state_dict()
        w, g = want.next_batch(batch, seq), got.next_batch(batch, seq)
        for key in ("tokens", "labels"):
            assert g[key].dtype == torch.int32 and g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), w[key])
    assert json.loads(json.dumps(got.state_dict())) == want.state_dict()
    # a fresh batcher resumed at batch 5 gives batches 5-9 again, and so
    # does the reference's from the same state
    again = TokenBatcher(port[kind][0], mode=mode, seed=3, device="cpu")
    again.load_state_dict(state)
    rag = rpipeline.TokenBatcher(ref[kind][0], mode=mode, seed=3)
    rag.load_state_dict(state)
    for _ in range(5):
        g, w = again.next_batch(batch, seq), rag.next_batch(batch, seq)
        np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
    assert again.state_dict() == got.state_dict()


def test_batcher_crosses_epochs_like_reference(written):
    """Enough batches to wrap the corpus: the next epoch's permutation."""
    _, ref, port = written
    want = rpipeline.TokenBatcher(ref["files"][0], mode="events", seed=1)
    got = TokenBatcher(port["files"][0], mode="events", seed=1, device="cpu")
    while got.st.epoch < 2:
        np.testing.assert_array_equal(got.next_batch(4, 64)["labels"].numpy(),
                                      want.next_batch(4, 64)["labels"])
    assert got.state_dict() == want.state_dict()


def test_shard_order_is_the_seeded_permutation(written):
    _, _, port = written
    b = TokenBatcher(port["files"][0], seed=7, device="cpu")
    for epoch in range(3):
        np.testing.assert_array_equal(
            b._order(epoch), np.random.default_rng(7 + epoch).permutation(3))


# ------------------------------------------------------------ PrefetchLoader

@pytest.fixture(scope="module")
def shard_data(written):
    """path -> its decoded lines: the readers below answer from memory."""
    _, _, port = written
    d, manifest = port["files"]
    return {os.path.join(d, s["file"]): read_shard(os.path.join(d, s["file"])) for s in
            manifest["shards"]}


class Calls:
    """Counts reader calls per path (thread-safe)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.n: dict[str, int] = {}

    def next(self, path) -> int:
        with self.lock:
            self.n[path] = self.n.get(path, 0) + 1
            return self.n[path]


def _served(pl):
    out = list(pl)
    pl.close()
    return out


def test_prefetch_serves_each_shard_once(shard_data):
    paths = list(shard_data)
    pl = PrefetchLoader(paths, shard_data.__getitem__, depth=2, workers=2,
                        straggler_timeout=TIMEOUT)
    served = _served(pl)
    assert sorted(p for p, _ in served) == sorted(paths)
    assert all(v is shard_data[p] for p, v in served)
    assert pl.stats == {"served": 3, "straggler_requeues": 0}


def test_prefetch_straggler_is_requeued(shard_data):
    """The first attempt on one shard stalls until the test releases it;
    the timeout requeues the shard and a second attempt serves it."""
    paths = list(shard_data)
    slow, release, calls = paths[0], threading.Event(), Calls()

    def reader(path):
        if path == slow and calls.next(path) == 1:
            release.wait(60.0)
        return shard_data[path]

    pl = PrefetchLoader(paths, reader, depth=2, workers=2, straggler_timeout=TIMEOUT)
    try:
        served = _served(pl)
    finally:
        release.set()
    assert sorted(p for p, _ in served) == sorted(paths)
    assert pl.stats["straggler_requeues"] >= 1 and pl.stats["served"] == 3
    assert calls.n[slow] >= 2


def test_prefetch_lost_shard_is_recovered(shard_data):
    """An attempt that never returns while the loader runs: the retry
    delivers the shard, exactly once."""
    paths = list(shard_data)
    lost, never, calls = paths[1], threading.Event(), Calls()

    def reader(path):
        if path == lost and calls.next(path) == 1:
            never.wait(120.0)
        return shard_data[path]

    pl = PrefetchLoader(paths, reader, depth=2, workers=2, straggler_timeout=TIMEOUT)
    try:
        served = _served(pl)
    finally:
        never.set()
    assert sorted(p for p, _ in served) == sorted(paths)
    assert pl.stats["straggler_requeues"] >= 1


def test_prefetch_duplicate_paths_terminate(shard_data):
    paths = list(shard_data)
    pl = PrefetchLoader(paths + paths[:1] + paths[::-1], shard_data.__getitem__, depth=2,
                        workers=2, straggler_timeout=TIMEOUT)
    assert pl.paths == paths
    served = _served(pl)
    assert sorted(p for p, _ in served) == sorted(paths)


class SeenQueue(queue.Queue):
    """The loader's result queue, noting when the consumer comes back for
    the next item after taking an error: by then it has judged the error."""

    def __init__(self, maxsize):
        super().__init__(maxsize)
        self.last = None
        self.error_judged = threading.Event()

    def get(self, *a, **kw):
        if self.last is not None and self.last[0] == "error":
            self.error_judged.set()
        self.last = super().get(*a, **kw)
        return self.last


def test_prefetch_hang_then_raise_recovered_by_retry(shard_data):
    """The first attempt hangs past the timeout and raises once its retry
    has started; the retry returns only after the loader has judged that
    error, so the error is dropped (a retry was still running) and the
    retry serves the shard."""
    paths = list(shard_data)
    bad, go, retry_started, calls = paths[2], threading.Event(), threading.Event(), Calls()
    seen = SeenQueue(2)

    def reader(path):
        go.wait(60.0)
        if path == bad:
            if calls.next(path) == 1:
                retry_started.wait(60.0)
                raise OSError("socket timed out")
            retry_started.set()
            seen.error_judged.wait(60.0)
        return shard_data[path]

    pl = PrefetchLoader(paths, reader, depth=2, workers=2, straggler_timeout=TIMEOUT)
    pl.q = seen  # no reader has returned yet: nothing was put before this
    go.set()
    try:
        served = _served(pl)
    finally:
        retry_started.set()
        seen.error_judged.set()
    assert sorted(p for p, _ in served) == sorted(paths)
    assert pl.stats["straggler_requeues"] >= 1 and calls.n[bad] >= 2


def test_prefetch_error_without_retry_propagates(shard_data):
    paths = list(shard_data)

    def reader(path):
        if path == paths[0]:
            raise OSError("disk gone")
        return shard_data[path]

    pl = PrefetchLoader(paths, reader, depth=2, workers=2, straggler_timeout=TIMEOUT)
    with pytest.raises(OSError, match="disk gone"):
        _served(pl)


def test_prefetch_exhausted_retries_raise(shard_data):
    """Every attempt hangs: the bounded retries end in RuntimeError."""
    paths = list(shard_data)[:1]
    never = threading.Event()

    def reader(path):
        never.wait(120.0)
        return shard_data[path]

    pl = PrefetchLoader(paths, reader, depth=2, workers=2, straggler_timeout=TIMEOUT,
                        max_requeues=1)
    try:
        with pytest.raises(RuntimeError, match="lost"):
            list(pl)
    finally:
        never.set()
        pl.close()
    assert pl.stats["straggler_requeues"] == 1


# ------------------------------------------------------------------ devices

@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("entry", ["write_logzip_shards", "write_logzip_stream"])
def test_writers_default_to_the_card(tmp_path, entry):
    """cfg=None means LogzipConfig(level=3, kernel="gzip") on "cuda": it
    raises here, before any file is written."""
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pipeline, entry)(["a b c"], str(out))
    assert not out.exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_batcher_on_the_card_raises(written):
    _, _, port = written
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenBatcher(port["files"][0])
    with pytest.raises(ValueError):
        TokenBatcher(port["files"][0], device="meta")
