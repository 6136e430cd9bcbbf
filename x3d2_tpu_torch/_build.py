"""Kernel build and loader.

Each CUDA source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface and loaded with ``ctypes``. The build happens at first
use, into ``build/x3d2_tpu_torch/`` beside the package (listed in
``.gitignore``), and uses the sources in the repository and nothing else.
A library is named after the content hash of its source and of the
headers under ``csrc/`` (``*.cuh``), so an edited source or header is
rebuilt and an unchanged one is loaded as built. Sources that share a
header (``transeq_sweep.cu`` and ``transeq_sweep_w32.cu``, two block
geometries of one kernel template) are separate libraries, so
``build_all`` compiles them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "x3d2_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds spent compiling each source in this process (0 when loaded as
# built), for the chip smoke run's report
BUILD_SECONDS: dict[str, float] = {}
# nvcc's report (registers, shared memory, spills) per source
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def build_all(names) -> dict[str, Path]:
    """Compile every named ``csrc/<name>.cu`` that is not built yet, one
    ``nvcc`` per source, all started together; returns the library paths."""
    libs, procs = {}, {}
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    for name in names:
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(
            NVCC_FLAGS).encode()).hexdigest()[:16]
        libs[name] = lib = BUILD_DIR / f"lib{name}-{digest}.so"
        if lib.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        BUILD_LOG[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same content is
    already built; returns the library path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
