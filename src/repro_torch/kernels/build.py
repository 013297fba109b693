"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for
``sm_90a`` into ``build/lib<name>-<hash>.so`` at the root of the
checkout, a shared library with a plain C interface that is loaded
through ``ctypes``. The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Nothing is
built when a module is imported: the first launch builds what it needs,
and ``build`` compiles several sources at once, one ``nvcc`` each, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("attention", "colcodec", "distinct_counts", "match_extract", "simcount",
           "tokenize_hash", "wildcard_match")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA kernels "
                       "cannot be built (device='cpu' runs their plain torch versions)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile each named source that has no up-to-date library, all
    ``nvcc`` processes running at once -> {name: compiler output} for the
    sources compiled (``-Xptxas=-v`` reports registers and spills).
    Raises ``RuntimeError`` with the compiler's output if any fails."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, lib) for n, lib in todo if not lib.exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = {}, []
    for name, lib, tmp, proc in procs:
        out = proc.communicate()[0].decode("utf-8", "replace")
        logs[name] = out
        if proc.returncode:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
