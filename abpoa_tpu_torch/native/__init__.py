"""Native (C) host-side graph kernels, loaded via ctypes.

The C sources are compiled into one shared object on first use (~1 s),
into ``build/abpoa_tpu_torch/`` at the root of the checkout (git-ignored),
never into the package directory; the object's name carries a hash of
the sources and flags, so an edited source is rebuilt:
  hostgraph.c — CSR traversal kernels for the pure-Python POAGraph
  poagraph.c  — full native graph store (NativeGraph backend): storage,
                CIGAR/steps fusion, the device loop's replay, traversals,
                CSR export
  seedchain.c — minimizer sketching and anchor chaining
  dprow.c     — the oracle's whole-alignment DP row sweep

Set ABPOA_NO_NATIVE=1 to force the pure-Python fallbacks in graph.py
(used by the equivalence tests).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRCS = [_DIR / "hostgraph.c", _DIR / "poagraph.c", _DIR / "seedchain.c",
         _DIR / "dprow.c"]
_INCS = [_DIR / "dprow_impl.inc"]
# -fwrapv: the DP row kernels rely on int16/int32 wraparound matching
# numpy's (dtype arithmetic wraps; see dprow.c)
_CFLAGS = ["-O2", "-fwrapv", "-shared", "-fPIC"]
BUILD_DIR = _DIR.parent.parent / "build" / "abpoa_tpu_torch"

_lib = None

_vp = ctypes.c_void_p
_i32 = ctypes.c_int32
_i32p = ctypes.POINTER(ctypes.c_int32)


def _so_path() -> pathlib.Path:
    h = hashlib.sha256()
    for s in _SRCS + _INCS:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(_CFLAGS).encode())
    return BUILD_DIR / f"_hostgraph_{h.hexdigest()[:16]}.so"


def _build(so: pathlib.Path):
    # compile to a temp file and rename: concurrent importers must never
    # dlopen a half-written library
    cc = os.environ.get("CC", "cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp.{os.getpid()}.so")
    subprocess.run([cc, *_CFLAGS, "-o", str(tmp)]
                   + [str(s) for s in _SRCS], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def get_lib():
    """Returns the loaded library or None (disabled / build failed)."""
    global _lib
    if _lib is not None:
        return _lib or None
    if os.environ.get("ABPOA_NO_NATIVE"):
        _lib = False
        return None
    try:
        so = _so_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, nargs in (("topo_sort", 7), ("set_remain", 7),
                            ("msa_rank", 6)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [_i32] + [_i32p] * nargs
        lib.subgraph_reach.restype = ctypes.c_int
        lib.subgraph_reach.argtypes = [_i32, _i32, _i32] + [_i32p] * 4 \
            + [ctypes.POINTER(ctypes.c_uint8)]
        # poagraph store API
        sigs = {
            "pg_new": (_vp, []),
            "pg_free": (None, [_vp]),
            "pg_reset": (None, [_vp]),
            "pg_node_n": (_i32, [_vp]),
            "pg_add_node": (_i32, [_vp, _i32]),
            "pg_ensure_reads": (ctypes.c_int, [_vp, _i32]),
            "pg_add_edge": (_i32, [_vp] + [_i32] * 7),
            "pg_get_aligned_id": (_i32, [_vp, _i32, _i32]),
            "pg_add_aligned": (ctypes.c_int, [_vp, _i32, _i32]),
            "pg_add_graph_sequence": (ctypes.c_int,
                                      [_vp, _vp, _vp, _i32, _vp, _i32,
                                       _i32, _i32]),
            "pg_add_subgraph_alignment": (ctypes.c_int,
                                          [_vp, _i32, _i32, _vp, _vp,
                                           _i32, _vp, _vp, _vp, _i32,
                                           _vp, _i32, _i32, _i32, _i32]),
            "pg_fuse_steps": (ctypes.c_int,
                              [_vp, _vp, _i32, _vp, _i32, _i32, _i32,
                               _i32, _vp, _vp, _i32, _i32, _i32, _i32,
                               _i32, _i32]),
            "pg_replay_loop": (_i32, [_vp, _i32, _i32, _vp, _vp,
                                      ctypes.c_int64, _i32, _vp, _vp, _vp,
                                      _i32, _i32, _i32, _i32]),
            "pg_topo_sort": (ctypes.c_int, [_vp, _vp, _vp]),
            "pg_set_remain": (ctypes.c_int, [_vp, _vp]),
            "pg_msa_rank": (ctypes.c_int, [_vp, _vp]),
            "pg_rn": (_i32, [_vp]),
            "pg_counts": (None, [_vp, _vp, _vp, _vp]),
            "pg_export_csr": (None, [_vp] + [_vp] * 10),
            "pg_export_aux": (None, [_vp] + [_vp] * 5),
            "pg_node_base": (_i32, [_vp, _i32]),
            "pg_cons_hb": (ctypes.c_int, [_vp, _vp, _vp, _vp]),
            # seeding / chaining (seedchain.c)
            "sc_sketch": (ctypes.c_int64,
                          [_vp, _i32, _i32, _i32, _i32, _i32, _i32,
                           _vp, _vp]),
            "sc_collect_anchors": (ctypes.c_int64,
                                   [_vp, _vp, ctypes.c_int64, _vp, _vp,
                                    ctypes.c_int64, _i32, _i32, _vp,
                                    ctypes.c_int64]),
            "sc_dp_chaining": (ctypes.c_int64,
                               [_vp, ctypes.c_int64, _i32, _i32, _i32,
                                _i32, _vp]),
            # oracle whole-alignment row sweep (dprow.c np_dp_run):
            # 7 plane/qp + 4 band + 12 sweep pointers, then bits
            "np_dp_run": (ctypes.c_int64, [_vp] * 23 + [_i32]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
    except Exception:
        _lib = False
        return None
    return _lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def ptr(a: np.ndarray):
    """Raw data pointer for the pg_* (void*) API."""
    return ctypes.c_void_p(a.ctypes.data)


def topo_sort(n, out_flat, out_off, in_cnt, aligned_flat, aligned_off):
    lib = get_lib()
    i2n = np.empty(n, dtype=np.int32)
    n2i = np.empty(n, dtype=np.int32)
    rc = lib.topo_sort(n, _p(out_flat), _p(out_off), _p(in_cnt),
                       _p(aligned_flat), _p(aligned_off), _p(i2n), _p(n2i))
    if rc != 0:
        raise RuntimeError("Failed to set node index.")
    return i2n, n2i


def set_remain(n, out_flat, out_off, out_w_flat, in_flat, in_off, out_cnt):
    lib = get_lib()
    remain = np.zeros(n, dtype=np.int32)
    rc = lib.set_remain(n, _p(out_flat), _p(out_off), _p(out_w_flat),
                        _p(in_flat), _p(in_off), _p(out_cnt), _p(remain))
    if rc != 0:
        raise RuntimeError("Failed to set node remain.")
    return remain


def subgraph_reach(n, beg_index, end_index, out_flat, out_off, i2n, n2i):
    lib = get_lib()
    mask = np.zeros(n, dtype=np.uint8)
    lib.subgraph_reach(
        n, beg_index, end_index, _p(out_flat), _p(out_off),
        _p(i2n), _p(n2i),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return mask


def msa_rank(n, out_flat, out_off, in_cnt, aligned_flat, aligned_off):
    lib = get_lib()
    rank = np.empty(n, dtype=np.int32)
    rc = lib.msa_rank(n, _p(out_flat), _p(out_off), _p(in_cnt),
                      _p(aligned_flat), _p(aligned_off), _p(rank))
    if rc != 0:
        raise RuntimeError("Error in set_msa_rank.")
    return rank
