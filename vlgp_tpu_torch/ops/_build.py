"""Build and load the CUDA kernels of ``csrc/``.

Each source ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` (Hopper) into its own shared library with a plain C interface,
loaded with ``ctypes``; the sources share ``csrc/ns_common.cuh``.  All
missing libraries are built together, one ``nvcc`` process per source
started at once.  A library lands in ``vlgp_tpu_torch/_build/`` under a
name that carries a hash of every source and header in ``csrc/`` and of
the flags, so an edited file is rebuilt and a stale library is never
loaded.
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

__all__ = ["build", "load_library", "BUILD_SECONDS", "SOURCES"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("ns_inverse", "sweep", "spd_inverse", "graph_cond", "svd_loading", "lorenz",
           "mstep", "hstep", "hstep_stat", "estep")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_p, _i, _f, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# exported C functions of each library: (argument types, result type)
_SIGNATURES = {
    "ns_inverse": {
        "ns_gram": ([_p] * 6 + [_i] * 8 + [_p], _i),
        "ns_gram_pairs": ([_p] * 7 + [_i] * 17 + [_p], _i),
        "ns_pairs_smem": ([_i] * 4, _i),
        "ns_gram_stream": ([_p] * 6 + [_i] * 10 + [_p], _i),
        "ns_gram_smem": ([_i] * 3, _i),
        "ns_packed": ([_p] * 4 + [_i] * 5 + [_p], _i),
        "ns_packed_probe_skip": ([_p] * 5 + [_i] * 4 + [_p], _i),
    },
    "sweep": {
        "vlgp_sweep": ([_p] * 19 + [_i] * 8 + [_f, _f] + [_i] * 4 + [_p], _i),
    },
    "spd_inverse": {
        "spd_inverse": ([_p, _p, _i, _i, _p], _i),
    },
    "graph_cond": {
        "vlgp_cond_handle": ([_p, _p, _i, _p], _i),
        "vlgp_if_begin": ([_p, _p, _p, _i], _i),
        "vlgp_if_end": ([_p], _i),
    },
    "svd_loading": {
        "svd_loading": ([_p, _p, _i, _i, _i, _p], _i),
    },
    "lorenz": {
        "lorenz": ([_p, _i, _i, _d, _d, _d, _d, _p], _i),
    },
    "mstep": {
        "mstep_stats_plan": ([_i] * 6 + [_p, _p], _i),
        "mstep_stats": ([_p] * 8 + [_i] * 6 + [_p], _i),
        "mstep_reduce": ([_p, _i, _p, _p] + [_i] * 5 + [_p], _i),
        "mstep_update": ([_p, _i] + [_p] * 15 + [_i] * 4 + [_d] * 4 + [_i, _p], _i),
    },
    "hstep": {
        "hstep_search_scratch": ([_i, _i], _i),
        "hstep_search_cluster": ([_i] * 6 + [_p], _i),
        "hstep_search_resident": ([_i] * 3, _i),
        "hstep_search_rounds": ([_i] * 4, _i),
        "hstep_search": ([_p] * 7 + [_i] * 2 + [_d] * 2 + [_i] * 4 + [_d, _i, _i, _i, _p], _i),
    },
    "hstep_stat": {
        "hstep_stat_plan": ([_i] * 5, _i),
        "hstep_stat": ([_p] * 8 + [_i] * 5 + [_p], _i),
    },
    "estep": {
        "estep_project": ([_p] * 10 + [_i] * 8 + [_p], _i),
        "estep_step": ([_p] * 15 + [_i] * 6 + [_d] + [_i] * 5 + [_p], _i),
        "estep_smem": ([_i] * 9, _i),
        "estep_cluster_resident": ([_i] * 7, _i),
        "estep_cycles": ([_i, _p, _i], _i),
    },
}

_lock = threading.Lock()
_libs: dict = {}
# wall seconds spent in nvcc by this process (0.0 when the libraries were cached)
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build() -> dict:
    """Compile every source whose library for the current sources does not
    exist, all at once; returns {name: library path}."""
    global BUILD_SECONDS
    digest = _digest()
    paths = {name: _lib_path(name, digest) for name in SOURCES}
    todo = [name for name, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tic = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, paths[name])  # atomic: a concurrent loader never sees half a file
    BUILD_SECONDS += time.perf_counter() - tic
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(name: str = "ns_inverse") -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu`` once per
    process; the first call builds every missing library."""
    with _lock:
        if name not in _libs:
            for lib_name, path in build().items():
                if lib_name in _libs:
                    continue
                lib = ctypes.CDLL(str(path))
                for fn, (argtypes, restype) in _SIGNATURES[lib_name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                lib.ns_error_string.argtypes = [_i]
                lib.ns_error_string.restype = ctypes.c_char_p
                _libs[lib_name] = lib
        return _libs[name]
