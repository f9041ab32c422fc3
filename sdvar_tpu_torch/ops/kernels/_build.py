"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``sdvar_tpu_torch/csrc/`` becomes one shared library with
a plain C interface, built for ``sm_90a`` on first use into
``<repo>/build/kernels/<name>-<hash>/`` (listed in ``.gitignore``). The hash
covers the source and the compiler flags, so an edited source is rebuilt
and an unchanged one is loaded from disk. Build errors raise with the
compiler's output; the ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library and returned by :func:`build_log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is built;
    returns (target, process or None)."""
    so = _target(name)
    if so.exists():
        return so, None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp)


def _finish(name: str, so: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    (so.parent / "build.log").write_text(out)
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file


def build(names: Iterable[str]) -> None:
    """Build the named sources, one nvcc process each, all started
    together."""
    names = list(names)
    with _lock:
        jobs = [(n, *_start(n)) for n in names]
        for name, so, job in jobs:
            _finish(name, so, job)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so, job = _start(name)
            _finish(name, so, job)
            lib = _libs[name] = ctypes.CDLL(str(so))
        return lib


def build_log(name: str) -> str:
    """The compiler's report for ``csrc/<name>.cu`` (empty before a build)."""
    log = _target(name).parent / "build.log"
    return log.read_text() if log.exists() else ""
