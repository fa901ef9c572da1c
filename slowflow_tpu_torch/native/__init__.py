"""The seed-graph k-NN of the EPIC interpolation, in C++ on the host.

`geodesic.cpp` is a copy of the JAX package's source (a settled-array
Dijkstra per seed, OpenMP over seeds). It is compiled with g++ at first use
into `slowflow_tpu_torch/_build/` (ignored by git), keyed by a hash of the
source and flags, and loaded with ctypes. A failed build raises: there is no
fallback. `knn_python` is the plain version the tests hold it to.
"""
from __future__ import annotations

import ctypes
import hashlib
import heapq
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "geodesic.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"geodesic-{h.hexdigest()[:16]}" / "libgeodesic.so"


def build() -> Path:
    """Compile geodesic.cpp unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o",
                                   str(lib)], capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"{CXX} could not build {SRC.name}: "
                               f"{exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed to build {SRC.name} "
                               f"(rc {proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(lib, out)
    return out


def load():
    """The loaded Dijkstra library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.geodesic_knn_all.argtypes = [
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                np.ctypeslib.ndpointer(np.float32, flags="C"),
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                np.ctypeslib.ndpointer(np.float32, flags="C"),
            ]
            lib.geodesic_knn_all.restype = None
            _lib = lib
        return _lib


def _csr(indptr, indices, data):
    return (np.ascontiguousarray(indptr, np.int32),
            np.ascontiguousarray(indices, np.int32),
            np.ascontiguousarray(data, np.float32))


def knn_graph_all(indptr, indices, data, nmax: int):
    """The `nmax` nearest nodes of every node of a CSR graph by shortest
    path, the node itself first, with the C++ Dijkstra.

    Returns (best [ns, nmax] int32, dist [ns, nmax] float32); unfilled
    slots are -1 / +inf."""
    indptr, indices, data = _csr(indptr, indices, data)
    ns = len(indptr) - 1
    if len(indices) and (indices.min() < 0 or indices.max() >= ns):
        raise ValueError("knn_graph_all: column index out of range")
    best = np.empty((ns, nmax), np.int32)
    dist = np.empty((ns, nmax), np.float32)
    if ns > 0:
        load().geodesic_knn_all(ns, indptr, indices, data, nmax, best, dist)
    return best, dist


def knn_python(indptr, indices, data, nmax: int):
    """The plain version of `knn_graph_all`: the same settled-array Dijkstra
    with lazy deletion on a Python heap."""
    indptr, indices, data = _csr(indptr, indices, data)
    ns = len(indptr) - 1
    best = np.full((ns, nmax), -1, np.int32)
    dist = np.full((ns, nmax), np.inf, np.float32)
    for src in range(ns):
        tentative = np.full(ns, np.inf, np.float32)
        settled = np.zeros(ns, bool)
        pq = [(np.float32(0.0), src)]
        tentative[src] = 0.0
        found = 0
        while found < nmax and pq:
            d, u = heapq.heappop(pq)
            if settled[u]:
                continue
            settled[u] = True
            best[src, found] = u
            dist[src, found] = d
            found += 1
            for e in range(indptr[u], indptr[u + 1]):
                v = indices[e]
                cand = np.float32(d + data[e])
                if not settled[v] and cand < tentative[v]:
                    tentative[v] = cand
                    heapq.heappush(pq, (cand, v))
    return best, dist
