"""Native (C++) host-runtime components, loaded via ctypes.

The device compute path is JAX/XLA; scene build is host work, and the BVH
builder is its hot spot (reference: rustracer-core/src/bvh/mod.rs). The C++
builder here is compiled on demand with g++ into a cached shared object next
to the source. Everything degrades gracefully: if no compiler is available
the callers fall back to the pure-NumPy builder in accel/bvh.py.

Set RUSTRACER_TPU_NO_NATIVE=1 to force the Python fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_SO = os.path.join(_DIR, "_bvh_builder.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load():
    """Compile (if stale) and load the shared library; None on failure."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("RUSTRACER_TPU_NO_NATIVE"):
            _lib_failed = True
            return None
        try:
            stale = (not os.path.exists(_SO)
                     or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
            if stale:
                tmp = _SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)  # atomic vs concurrent builders
            lib = ctypes.CDLL(_SO)
            fn = lib.build_bvh_sah
            fn.restype = ctypes.c_int32
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_float),   # lo
                ctypes.POINTER(ctypes.c_float),   # hi
                ctypes.c_int32,                   # n
                ctypes.c_int32,                   # split_method
                ctypes.c_int32,                   # max_prims
                ctypes.POINTER(ctypes.c_float),   # nodes_lo out
                ctypes.POINTER(ctypes.c_float),   # nodes_hi out
                ctypes.POINTER(ctypes.c_int32),   # meta out
                ctypes.POINTER(ctypes.c_int32),   # prim_order out
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(lo, hi, split_method="sah", max_prims=4):
    """C++ twin of accel.bvh.build_bvh; returns None if native unavailable.

    Same contract: (nodes_lo, nodes_hi, meta, prim_order) with nodes in DFS
    preorder (child1 = idx+1, meta[:,0] = second-child offset for interiors /
    prim offset for leaves).
    """
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if n == 0:
        return None
    cap = 2 * n  # binary tree over n prims has <= 2n-1 nodes
    nodes_lo = np.empty((cap, 3), np.float32)
    nodes_hi = np.empty((cap, 3), np.float32)
    meta = np.empty((cap, 3), np.int32)
    prim_order = np.empty(n, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n_nodes = lib.build_bvh_sah(
        lo.ctypes.data_as(f32p), hi.ctypes.data_as(f32p),
        np.int32(n), np.int32(1 if split_method == "middle" else 0),
        np.int32(max_prims),
        nodes_lo.ctypes.data_as(f32p), nodes_hi.ctypes.data_as(f32p),
        meta.ctypes.data_as(i32p), prim_order.ctypes.data_as(i32p))
    if n_nodes <= 0:
        return None
    return (nodes_lo[:n_nodes].copy(), nodes_hi[:n_nodes].copy(),
            meta[:n_nodes].copy(), prim_order)
