"""Build and load the CUDA kernels of ``csrc/ns_inverse.cu``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``vlgp_tpu_torch/_build/`` under a name that carries
a hash of the source, so an edited source is rebuilt and a stale library
is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["build", "load_library", "BUILD_SECONDS"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ns_inverse.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
# wall seconds spent in nvcc by this process (0.0 when the library was cached)
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the vlgp_tpu_torch CUDA kernels")
    return found


def build() -> pathlib.Path:
    """Compile the kernels unless a library for this exact source exists;
    returns the library's path."""
    global BUILD_SECONDS
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libns_inverse_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    tic = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    BUILD_SECONDS += time.perf_counter() - tic
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ns_gram.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.ns_gram.restype = i
        lib.ns_packed.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.ns_packed.restype = i
        lib.ns_error_string.argtypes = [i]
        lib.ns_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
