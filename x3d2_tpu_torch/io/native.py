"""ctypes bindings for the native C++ IO runtime (native/x3d2io.cpp).

Counterpart of x3d2_tpu.io.native, with the port's own copy of the
source. The shared library is built with g++ on first use into
``build/x3d2_tpu_torch/`` beside the CUDA libraries (_build.py), named
after the content hash of the source, the flags and this host's CPU
(``-march=native`` makes a build host-specific); each process builds into
a temporary file and renames it into place, so several processes may
build at the same moment. A failed build raises: nothing on the IO path
carries on in Python.

Entry points: strided float32 packing, VTK base64 encoding, and the
background writer that writes a temporary file and renames it atomically
(``async_write``, ``async_flush``; a job that failed to write raises at
the next flush). The pure-Python versions of x3d2_tpu (``*_plain``) are
the plain versions the tests hold the native ones against.
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import os
import platform
import struct
import subprocess
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR, PKG_DIR

SRC = PKG_DIR / "native" / "x3d2io.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]

_lib = None


def _host_id() -> bytes:
    """What -march=native compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as fh:
            keep = [ln for ln in fh if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(keep))).encode()
    except OSError:
        return platform.processor().encode() or platform.machine().encode()


def build() -> Path:
    """The library of native/x3d2io.cpp for this host, compiled with g++
    unless already built; raises RuntimeError if g++ fails."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _host_id()).hexdigest()[:16]
    lib = BUILD_DIR / f"libx3d2io-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        for fn in (lib.pack_strided_f32_from_f32,
                   lib.pack_strided_f32_from_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [i64] * 8
            fn.restype = None
        lib.vtk_base64_encode.argtypes = [ctypes.c_void_p, i64,
                                          ctypes.c_void_p]
        lib.vtk_base64_encode.restype = i64
        lib.async_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_void_p, i64]
        lib.async_write.restype = None
        lib.async_pending.restype = i64
        lib.async_failed.restype = i64
        lib.async_flush.restype = None
        _lib = lib
    return _lib


def _strided_shape(shape, stride):
    return tuple((n + s - 1) // s for n, s in zip(shape, stride))


def pack_strided(arr: np.ndarray, stride) -> np.ndarray:
    """arr[::sx, ::sy, ::sz] as float32 (arr float32 or float64)."""
    sx, sy, sz = (max(1, int(s)) for s in stride)
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in (np.float32, np.float64) or arr.ndim != 3:
        raise TypeError(f"pack_strided takes a 3-d float32 or float64 "
                        f"array, got {arr.dtype} {arr.shape}")
    nx, ny, nz = arr.shape
    out = np.empty(_strided_shape(arr.shape, (sx, sy, sz)), np.float32)
    lib = get_lib()
    fn = (lib.pack_strided_f32_from_f32 if arr.dtype == np.float32
          else lib.pack_strided_f32_from_f64)
    fn(arr.ctypes.data, out.ctypes.data, nx, ny, nz, sx, sy, sz, ny * nz, nz)
    return out


def vtk_b64(data: np.ndarray) -> str:
    """VTK appended-payload base64 (uint32 length header + raw data)."""
    raw = np.ascontiguousarray(data).tobytes()
    n = len(raw)
    out = ctypes.create_string_buffer(4 * ((n + 4 + 2) // 3) + 8)
    m = get_lib().vtk_base64_encode(raw, n, out)
    return out.raw[:m].decode()


def async_write(path: str, data):
    """Write `data` (bytes, or a writable buffer such as
    ``BytesIO.getbuffer()``) to `path` atomically (a temporary file, then
    a rename) off the main thread. The bytes are copied before this
    returns."""
    tmp = path + ".tmp"
    if isinstance(data, bytes):
        ptr, n = data, len(data)
    else:
        view = memoryview(data).cast("B")
        n = view.nbytes
        ptr = ctypes.addressof((ctypes.c_char * n).from_buffer(view)) \
            if n else None
    get_lib().async_write(tmp.encode(), path.encode(), ptr, n)


def async_flush():
    """Wait for every queued write; raises OSError if any failed."""
    lib = get_lib()
    lib.async_flush()
    failed = lib.async_failed()
    if failed:
        raise OSError(f"{failed} background write(s) failed (the files "
                      "were not written or not renamed into place)")


# ---------------------------------------------------------------------------
# the plain versions (x3d2_tpu.io.native's pure-Python fallbacks)
# ---------------------------------------------------------------------------

def pack_strided_plain(arr: np.ndarray, stride) -> np.ndarray:
    sx, sy, sz = (max(1, int(s)) for s in stride)
    return np.asarray(arr[::sx, ::sy, ::sz], np.float32)


def vtk_b64_plain(data: np.ndarray) -> str:
    raw = np.ascontiguousarray(data).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def write_atomic_plain(path: str, data: bytes):
    """The synchronous form of async_write."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)
