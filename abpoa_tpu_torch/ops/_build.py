"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/<name>.cu`` into its own shared library
with a plain C interface, at first use, into ``build/abpoa_tpu_torch/``
at the root of the checkout (git-ignored); the libraries are loaded with
ctypes. ``build_all`` starts one ``nvcc`` per source, all at once. A
library's name carries a hash of its source, the shared headers and the
flags, so an edited source is rebuilt and a built one is reused. No
PyTorch headers are compiled, which keeps a build to seconds.
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

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "abpoa_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_vp = ctypes.c_void_p
_int = ctypes.c_int

# source -> {exported C function: argtypes}; each returns the cudaError_t
# of its launch (or copy) as an int
SOURCES = {
    "band_dp": {
        "band_dp_launch": [_vp] * 11 + [_int] * 8 + [_vp],
        "band_dp_topo_staged_launch": [_vp] * 2 + [ctypes.c_size_t]
                                      + [_vp] * 9 + [_int] * 22 + [_vp],
        "band_dp_topo_fetch": [_vp] * 4 + [_int] * 5 + [_vp],
    },
    "graph_update": {
        "graph_update_launch": [_vp] * 16 + [_int] * 11 + [_vp],
    },
    "fw_dp": {
        "fw_dp_launch": [_vp] * 22 + [_int] * 12 + [_vp],
    },
    "tile_dp": {
        "tile_dp_launch": [_vp] * 21 + [_int] * 12 + [_vp],
    },
    "topo": {
        "topo_launch": [_vp] * 10 + [_int] * 4 + [_vp],
    },
}

_lock = threading.Lock()
_libs: dict = {}
build_seconds = None   # wall seconds of this process's nvcc runs, if any


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "abpoa_tpu_torch cannot be built")
    return path


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for s in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every source (or `names`) that has no library for its
    current state yet: one nvcc per source, all started together.
    Returns {name: library path}."""
    global build_seconds
    names = list(SOURCES) if names is None else list(names)
    outs = {n: library_path(n) for n in names}
    todo = [n for n in names if not outs[n].exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = outs[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu:\n{log}")
        else:
            os.replace(tmp, outs[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    build_seconds = time.perf_counter() - t0
    return outs


def library(name: str):
    """The loaded library of csrc/<name>.cu (built on first call)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn_name, argtypes in SOURCES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
