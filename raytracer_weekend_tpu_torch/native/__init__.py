"""Host-side native code: the BVH builder (C++ via ctypes).

The port's copy of the JAX package's `native/bvh_builder.cpp`. The source
is compiled at first use by the host C++ compiler into
`build/torch_native/` at the repository root, named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one loads
at once:

    g++ -O3 -fPIC -std=c++17 -shared -o <lib> bvh_builder.cpp

A failed compile or load raises: nothing falls back to numpy.
`_build_bvh_numpy` (the same splits and layout as the C++ builder) is the
plain version the tests hold the library against. Nothing here runs at
import time. The pixel stream frames with the Python COBS codec
(`parallel.stream`), a small share of `stream_render`'s time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "torch_native"
SOURCES = ("bvh_builder.cpp",)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++, c++ or clang++) found: "
                       "the BVH builder needs one")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((_DIR / src).read_bytes())
    return BUILD_DIR / f"librtw_torch_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library for them exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.rtw_build_bvh.restype = ctypes.c_int32
        lib.rtw_build_bvh.argtypes = [fp, fp, ctypes.c_int32, ctypes.c_int32,
                                      fp, fp, ip, ip]
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# BVH build: flat DFS layout with skip links (see bvh_builder.cpp header)
# ---------------------------------------------------------------------------

def build_bvh(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int = 1):
    """Build a flattened BVH -> (node_bmin (M,3) f32, node_bmax (M,3) f32,
    prim (M,) i32, skip (M,) i32) as numpy arrays.

    prim[i] >= 0 marks a leaf holding that primitive; skip[i] is the next
    node index after i's subtree (the miss pointer of stackless traversal).
    """
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    n = bmin.shape[0]
    if n == 0:
        z3 = np.zeros((0, 3), np.float32)
        z = np.zeros((0,), np.int32)
        return z3, z3, z, z
    lib = load_library()
    cap = 2 * n
    out_bmin = np.empty((cap, 3), np.float32)
    out_bmax = np.empty((cap, 3), np.float32)
    out_prim = np.empty((cap,), np.int32)
    out_skip = np.empty((cap,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    count = lib.rtw_build_bvh(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp), n, leaf_size,
        out_bmin.ctypes.data_as(fp), out_bmax.ctypes.data_as(fp),
        out_prim.ctypes.data_as(ip), out_skip.ctypes.data_as(ip))
    return (out_bmin[:count].copy(), out_bmax[:count].copy(),
            out_prim[:count].copy(), out_skip[:count].copy())


def _build_bvh_numpy(bmin, bmax, leaf_size=1):
    """Plain version of `build_bvh`: the same layout and splits as the C++
    builder (the JAX package's numpy builder). For the tests."""
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    centroids = 0.5 * (bmin + bmax)

    nodes_bmin, nodes_bmax, prim = [], [], []

    def rec(ids):
        if len(ids) <= leaf_size:
            for i in ids:
                nodes_bmin.append(bmin[i])
                nodes_bmax.append(bmax[i])
                prim.append(i)
            return
        lo = bmin[ids].min(0)
        hi = bmax[ids].max(0)
        c = centroids[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        ids = ids[order]
        mid = len(ids) // 2
        nodes_bmin.append(lo)
        nodes_bmax.append(hi)
        prim.append(-1)
        rec(ids[:mid])
        rec(ids[mid:])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(np.arange(bmin.shape[0]))
    finally:
        sys.setrecursionlimit(old)

    prim_arr = np.asarray(prim, np.int32)
    n = len(prim_arr)
    size = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        if prim_arr[i] < 0:
            left = i + 1
            right = left + size[left]
            size[i] = 1 + size[left] + size[right]
    skip_arr = (np.arange(n) + size).astype(np.int32)
    return (np.asarray(nodes_bmin, np.float32).reshape(-1, 3),
            np.asarray(nodes_bmax, np.float32).reshape(-1, 3), prim_arr,
            skip_arr)

