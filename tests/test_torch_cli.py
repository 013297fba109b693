"""The port's ``logzip`` CLI against the JAX package's.

``python -m repro_torch.launch.compress`` has the reference's eleven
verbs; ``pack``, ``stream``, ``agg``, ``compact`` and ``serve`` take
``--device`` (here ``cpu``). Over the cases of ``tests/test_cli.py``, and
the query, durability and compaction verbs on the same archives, each
package runs the same command in a directory of its own: the files it
writes must be equal byte for byte, and so must its standard output (with
that directory's path taken out; no verb prints a timing). ``serve`` runs
as a subprocess of each package under SIGTERM, with and without
``--retention``, and must drain, exit 0 and leave equal archives. With
no card, the default ``--device cuda`` fails.

Every subprocess has a time limit of its own (``communicate(timeout=)``,
``wait_ack(timeout=)``) and is killed in ``finally``.
"""

import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from repro.data.loggen import DATASETS, generate_lines
from repro.launch import compress as rcli
from repro_torch.core.stream import LZJSReader
from repro_torch.ingest.protocol import IngestClient
from repro_torch.launch import compress as cli

FMT = DATASETS["Spark"]["format"]
HDFS_FMT = DATASETS["HDFS"]["format"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
DEVICE_VERBS = ("pack", "stream", "agg", "compact", "serve")
WAIT = 60.0  # seconds any one wait on a subprocess or a socket may take
MAINS = {"ref": rcli.main, "port": cli.main}


def short_tmpdir(prefix: str) -> str:
    """A new directory in the temporary directory, named relative to the
    working directory where that is the shorter name: unix socket paths
    are capped at ~108 bytes."""
    d = tempfile.mkdtemp(prefix=prefix)
    return min(d, os.path.relpath(d), key=len)


@pytest.fixture(scope="module")
def log_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "in.log"
    p.write_text("\n".join(generate_lines("Spark", 1200, seed=13)), encoding="utf-8")
    return str(p)


def _argv(pkg, argv, root):
    argv = [a.replace("{d}", root) for a in argv]
    if pkg == "port" and argv[0] in DEVICE_VERBS:
        argv += ["--device", "cpu"]
    return argv


def _run(pkg, argv, root, monkeypatch, capsys):
    """Run one command of ``pkg``'s CLI in-process -> (stdout, stderr,
    exit code) with ``root`` taken out of both."""
    monkeypatch.setattr(sys, "argv", ["compress"] + _argv(pkg, argv, root))
    code = 0
    try:
        MAINS[pkg]()
    except SystemExit as e:
        code = e.code
    out, err = capsys.readouterr()
    return out.replace(root, "{d}"), err.replace(root, "{d}"), code


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def _both(commands, tmp_path, monkeypatch, capsys, setup=None):
    """Run ``commands`` (argv lists, ``{d}`` for the package's directory)
    on each package -> the port's outputs, asserted equal to the
    reference's, and the files each left."""
    got = {}
    for pkg in MAINS:
        root = str(tmp_path / pkg)
        os.mkdir(root)
        if setup:
            setup(root)
        outs = [_run(pkg, argv, root, monkeypatch, capsys) for argv in commands]
        got[pkg] = (outs, _files(root))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    return got["port"]


def _copy(log_file):
    return lambda root: shutil.copy(log_file, os.path.join(root, "in.log"))


# ---------------------------------------------------------------- the cases --

CASES = {
    "pack_unpack": [["pack", "{d}/in.log", "{d}/out.lzj", "--format", FMT],
                    ["unpack", "{d}/out.lzj", "{d}/back.log"]],
    "pack_chunked": [["pack", "{d}/in.log", "{d}/out.lzjm", "--format", FMT,
                      "--chunk-lines", "300", "--kernel", "bzip2"],
                     ["unpack", "{d}/out.lzjm", "{d}/back.log"]],
    "pack_level_1_lzma": [["pack", "{d}/in.log", "{d}/out.lzj", "--format", FMT,
                           "--level", "1", "--kernel", "lzma"],
                          ["unpack", "{d}/out.lzj", "{d}/back.log"]],
    "stream_unpack_range": [["stream", "{d}/in.log", "{d}/out.lzjs", "--format", FMT,
                             "--chunk-lines", "250"],
                            ["unpack", "{d}/out.lzjs", "{d}/back.log"],
                            ["unpack", "{d}/out.lzjs", "{d}/range.log", "--range", "300:400"]],
    "stream_append": [["stream", "{d}/in.log", "{d}/out.lzjs", "--format", FMT,
                       "--chunk-lines", "400"],
                      ["stream", "{d}/in.log", "{d}/out.lzjs", "--append",
                       "--chunk-lines", "400"],
                      ["unpack", "{d}/out.lzjs", "{d}/back.log"],
                      ["inspect", "{d}/out.lzjs"]],
    "inspect_three_magics": [["pack", "{d}/in.log", "{d}/a.lzj", "--format", FMT],
                             ["pack", "{d}/in.log", "{d}/a.lzjm", "--format", FMT,
                              "--chunk-lines", "300"],
                             ["stream", "{d}/in.log", "{d}/a.lzjs", "--format", FMT,
                              "--chunk-lines", "300"],
                             ["inspect", "{d}/a.lzj"], ["inspect", "{d}/a.lzjm"],
                             ["inspect", "{d}/a.lzjs", "--max-chunks", "2"]],
}


@pytest.mark.parametrize("name", list(CASES))
def test_cli_case_equals_reference(name, log_file, tmp_path, monkeypatch, capsys):
    outs, files = _both(CASES[name], tmp_path, monkeypatch, capsys, setup=_copy(log_file))
    assert all(code == 0 for _, _, code in outs)
    with open(log_file, "rb") as f:
        want = f.read()
    if "back.log" in files:
        assert files["back.log"] == (want + b"\n" + want if name == "stream_append" else want)
    if "range.log" in files:
        assert files["range.log"] == b"\n".join(want.split(b"\n")[300:700])
        assert "decoded 2/5 chunks" in outs[-1][0]


def test_pack_from_stdin_equals_reference(log_file, tmp_path, monkeypatch, capsys):
    with open(log_file, "rb") as f:
        data = f.read()

    def stdin(root):
        monkeypatch.setattr(sys, "stdin", type("S", (), {"buffer": io.BytesIO(data)})())

    _, files = _both([["pack", "-", "{d}/out.lzj", "--format", FMT, "--chunk-lines", "500"],
                      ["unpack", "{d}/out.lzj", "{d}/back.log"]],
                     tmp_path, monkeypatch, capsys, setup=stdin)
    assert files["back.log"] == data


QUERY_COMMANDS = [
    ["grep", "{d}/a.lzjs", "Starting"], ["grep", "{d}/a.lzjs", "task", "--count"],
    ["grep", "{d}/a.lzjs", r"stage \d+\.0", "--regex", "--json", "--limit", "5"],
    ["grep", "{d}/a.lzjs", "--range", "100:50", "--template", "0", "--stats"],
    ["grep", "{d}/a.lzjs", "Finished", "--explain"],
    ["agg", "{d}/a.lzjs", "--by-template"], ["agg", "{d}/a.lzjs", "--top", "Level", "--json"],
    ["agg", "{d}/a.lzjs", "--top-param", "0:0", "-k", "3"],
    ["agg", "{d}/a.lzjs", "--top", "Date", "--stats"],
    ["agg", "{d}/a.lzj", "--top", "Component"],
    ["extract", "{d}/a.lzjs", "--range", "10:5"],
    ["extract", "{d}/a.lzjs", "--template", "1", "--json"],
    ["fsck", "{d}/a.lzjs"], ["fsck", "{d}/a.lzjs", "--json"],
]


def test_query_verbs_equal_reference(log_file, tmp_path, monkeypatch, capsys):
    outs, _ = _both([["stream", "{d}/in.log", "{d}/a.lzjs", "--format", FMT,
                      "--chunk-lines", "300"],
                     ["pack", "{d}/in.log", "{d}/a.lzj", "--format", FMT]] + QUERY_COMMANDS,
                    tmp_path, monkeypatch, capsys, setup=_copy(log_file))
    assert all(code == 0 for _, _, code in outs)
    assert all(out for out, _, _ in outs)


@pytest.fixture(scope="module")
def hdfs_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "in.log"
    p.write_text("\n".join(generate_lines("HDFS", 1500, seed=42)), encoding="utf-8")
    return str(p)


def test_histogram_and_top_on_integer_fields_equal_reference(hdfs_file, tmp_path, monkeypatch,
                                                             capsys):
    outs, _ = _both([["stream", "{d}/in.log", "{d}/a.lzjs", "--format", HDFS_FMT,
                      "--chunk-lines", "400"],
                     ["agg", "{d}/a.lzjs", "--histogram", "Time", "--bucket", "30", "--stats"],
                     ["agg", "{d}/a.lzjs", "--histogram", "Pid", "--json"],
                     ["agg", "{d}/a.lzjs", "--top", "Pid", "-k", "4"]],
                    tmp_path, monkeypatch, capsys, setup=_copy(hdfs_file))
    assert all(code == 0 and out for out, _, code in outs)


def test_histogram_of_a_text_header_field_counts_the_lines(log_file, tmp_path, monkeypatch,
                                                           capsys):
    """Spark's Time (``10:00:01``) is a text column of the ParamDict at
    level 3. The port's ``agg --histogram`` buckets each line's first digit
    run, as a plain count over the lines does; the reference buckets
    ParaIDs there (ROADMAP C.2), so the two are not compared."""
    root = str(tmp_path)
    _copy(log_file)(root)
    _run("port", ["stream", "{d}/in.log", "{d}/a.lzjs", "--format", FMT], root, monkeypatch,
         capsys)
    out, _, code = _run("port", ["agg", "{d}/a.lzjs", "--histogram", "Time", "--bucket", "30",
                                 "--json"], root, monkeypatch, capsys)
    want = {}
    for line in open(log_file, encoding="utf-8").read().split("\n"):
        m = re.match(r"\S+ (\d+)\S* \S+ \S+: ", line)  # the lines the format parses
        if m:
            want[int(m.group(1)) // 30] = want.get(int(m.group(1)) // 30, 0) + 1
    got = {r["bucket"]: r["count"] for r in map(json.loads, out.splitlines())}
    assert code == 0 and got == want


def _damage(root):
    """Tear the last chunk of ``a.lzjs`` and flip a byte inside chunk 1."""
    path = os.path.join(root, "a.lzjs")
    rd = LZJSReader(path)
    off, last = rd.index[1]["offset"] + 40, rd.index[-1]
    rd.close()
    with open(path, "r+b") as f:
        f.seek(off)
        f.write(b"\xff" * 8)
        f.truncate(last["offset"] + last["length"] // 2)


def test_fsck_repair_and_salvage_equal_reference(log_file, tmp_path, monkeypatch, capsys):
    commands = [["stream", "{d}/in.log", "{d}/a.lzjs", "--format", FMT,
                 "--chunk-lines", "300"]]
    after = [["fsck", "{d}/a.lzjs", "--json"],
             ["unpack", "{d}/a.lzjs", "{d}/salvaged.log", "--salvage"],
             ["grep", "{d}/a.lzjs", "task", "--count", "--salvage"],
             ["agg", "{d}/a.lzjs", "--by-template", "--salvage"],
             ["repair", "{d}/a.lzjs"], ["fsck", "{d}/a.lzjs"], ["repair", "{d}/a.lzjs", "--json"],
             ["compact", "{d}/c.lzjs", "{d}/a.lzjs", "--json"],
             ["compact", "{d}/s.lzjs", "{d}/a.lzjs", "--strict"]]
    got = {}
    for pkg in MAINS:
        root = str(tmp_path / pkg)
        os.mkdir(root)
        _copy(log_file)(root)
        outs = [_run(pkg, argv, root, monkeypatch, capsys) for argv in commands]
        _damage(root)
        outs += [_run(pkg, argv, root, monkeypatch, capsys) for argv in after]
        got[pkg] = (outs, _files(root))
    assert got["port"] == got["ref"]
    codes = [code for _, _, code in got["port"][0]]
    assert codes == [0, 1, 0, 0, 0, 0, 1, 0, 0, 3]  # a quarantined chunk stays in fsck


def test_compact_verb_equals_reference(log_file, tmp_path, monkeypatch, capsys):
    outs, files = _both([["stream", "{d}/in.log", "{d}/a.lzjs", "--format", FMT,
                          "--chunk-lines", "300"],
                         ["stream", "{d}/in.log", "{d}/b.lzjs", "--format", FMT,
                          "--chunk-lines", "500"],
                         ["compact", "{d}/m.lzjs", "{d}/a.lzjs", "{d}/b.lzjs"],
                         ["compact", "{d}/n.lzjs", "{d}/a.lzjs", "{d}/b.lzjs", "--json",
                          "--no-fold", "--no-specialize", "--kernel", "gzip",
                          "--chunk-lines", "700"],
                         ["unpack", "{d}/m.lzjs", "{d}/back.log"]],
                        tmp_path, monkeypatch, capsys, setup=_copy(log_file))
    with open(log_file, "rb") as f:
        want = f.read()
    assert files["back.log"] == want + b"\n" + want
    assert "compacted 2 inputs" in outs[2][0]


# ------------------------------------------------------------ failures --

@pytest.mark.parametrize("argv", [
    ["pack", "{missing}", "{out}"],
    ["stream", "{missing}", "{out}", "--format", FMT],
    ["unpack", "{missing}", "{out}"],
    ["inspect", "{missing}"],
    ["grep", "{missing}", "ERROR"],
    ["agg", "{missing}", "--by-template"],
    ["extract", "{missing}"],
    ["fsck", "{missing}"],
    ["repair", "{missing}"],
    ["compact", "{out}", "{missing}"],
])
def test_missing_input_exits_2_as_reference(argv, tmp_path, monkeypatch, capsys):
    argv = [{"{missing}": "{d}/nope.lzjs", "{out}": "{d}/o"}.get(a, a) for a in argv]
    outs, _ = _both([argv], tmp_path, monkeypatch, capsys)
    _, err, code = outs[0]
    assert code == 2 and err.startswith("error: ") and err.count("\n") == 1


@pytest.mark.parametrize("argv", [
    ["unpack", "{d}/junk.bin", "{d}/o"],
    ["inspect", "{d}/junk.bin"],
    ["grep", "{d}/junk.bin", "ERROR"],
    ["agg", "{d}/junk.bin", "--by-template"],
    ["fsck", "{d}/junk.bin"],
    ["repair", "{d}/junk.bin"],
    ["stream", "{d}/in.log", "{d}/junk.bin", "--append"],
])
def test_bad_magic_exits_2_as_reference(argv, tmp_path, monkeypatch, capsys):
    def setup(root):
        with open(os.path.join(root, "junk.bin"), "wb") as f:
            f.write(b"definitely not a logzip archive\n" * 4)
        with open(os.path.join(root, "in.log"), "w") as f:
            f.write("one line")

    outs, files = _both([argv], tmp_path, monkeypatch, capsys, setup=setup)
    _, err, code = outs[0]
    assert code == 2 and err.startswith("error: ") and err.count("\n") == 1
    assert files["junk.bin"] == b"definitely not a logzip archive\n" * 4


# ------------------------------------------------------------- no card --

@pytest.mark.parametrize("verb", DEVICE_VERBS)
def test_default_device_raises_without_a_card(verb, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs the kernels")
    argv = {"pack": ["pack", "in.log", "o.lzj"], "stream": ["stream", "in.log", "o.lzjs"],
            "agg": ["agg", "a.lzjs", "--by-template"], "compact": ["compact", "o", "a.lzjs"],
            "serve": ["serve", str(tmp_path)]}[verb]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["compress"] + argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main()
    assert os.listdir(tmp_path) == []  # raised before any file or socket


def test_default_device_exits_non_zero_from_the_shell(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs the kernels")
    (tmp_path / "in.log").write_text("a b c\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.compress", "pack", "in.log", "o.lzj"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=WAIT)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "o.lzj").exists()


# --------------------------------------------------------- serve, SIGTERM --

@pytest.mark.parametrize("retention", [False, True])
def test_serve_drains_on_sigterm_as_reference(retention):
    """Each package's ``serve`` runs as a subprocess on a unix socket; a
    client sends 120 HDFS lines, waits for their ack, and SIGTERM drains
    the daemon: exit 0, ``drained`` printed, and equal archives (with
    ``--retention`` the sealed, compacted segment)."""
    lines = list(generate_lines("HDFS", 120, seed=5))
    roots = {pkg: short_tmpdir(f"lzc-{pkg}-") for pkg in MAINS}
    procs = {}
    try:
        for pkg, mod in (("ref", "repro"), ("port", "repro_torch")):
            argv = [sys.executable, "-m", f"{mod}.launch.compress", "serve", roots[pkg],
                    "--socket", os.path.join(roots[pkg], "d.sock"), "--chunk-lines", "64",
                    "--level", "2"]
            if retention:
                argv += ["--retention", "--rollup-after", "2"]
            if pkg == "port":
                argv += ["--device", "cpu"]
            procs[pkg] = subprocess.Popen(
                argv, env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        results = {}
        for pkg, proc in procs.items():
            spath = os.path.join(roots[pkg], "d.sock")
            deadline = time.monotonic() + WAIT
            while not os.path.exists(spath):
                assert proc.poll() is None, proc.communicate(timeout=WAIT)[1]
                assert time.monotonic() < deadline, "the daemon never bound its socket"
                time.sleep(0.05)
            with IngestClient(spath, "t", cfg={"format": HDFS_FMT, "level": 2}) as c:
                for ln in lines:
                    c.send(ln)
                acked = c.wait_ack(len(lines) - 1, timeout=WAIT)
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=WAIT)
            assert proc.returncode == 0, err
            assert "serving" in out and out.rstrip().endswith("drained")
            results[pkg] = (acked, _files(roots[pkg]))
        assert results["port"] == results["ref"]
        acked, files = results["port"]
        assert acked == len(lines)
        name = os.path.join("sealed", "t.00000.lzjs") if retention else "t.lzjs"
        assert set(files) == {name}
        rd = LZJSReader(os.path.join(roots["port"], name))
        try:
            assert rd.read_all() == lines
        finally:
            rd.close()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)
