"""ctypes loader for the native clustering runtime (``native/cluster.cpp``):
average-linkage labels by the NN-chain algorithm and DBSCAN labels by BFS
over a precomputed distance matrix, the host half of the hierarchical and
dbscan variants.

The library is built at first use with ``g++ -O3 -fPIC -std=c++17 -Wall
-Wextra -shared`` (the flags of ``native/Makefile``) from the repository's
``native/cluster.cpp`` into ``_native/build/`` beside this file, named by a
digest of the source, under a lock and a 120 s limit; the build writes a
temporary file and renames it, so a concurrent process never loads half a
library. A ``None`` return from any function here means the library is
unavailable (no source, no compiler, a failed build or load): the callers
fall back to scipy and sklearn, which give the same partitions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

__all__ = ["load", "library_path", "avg_linkage_labels", "dbscan_labels"]

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "cluster.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
#: native/Makefile's CXXFLAGS, then its -shared
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
_BUILD_TIMEOUT_S = 120
_lock = threading.Lock()
#: the loaded library, or None once a build or load failed
_lib: dict = {}


def library_path() -> Optional[pathlib.Path]:
    """Where the library for the current source lives (built or not);
    None without the source."""
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libconsensus_cluster-{digest}.so"


def _build(path: pathlib.Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, timeout=_BUILD_TIMEOUT_S)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _configure(lib: ctypes.CDLL) -> None:
    lib.pc_avg_linkage_labels.restype = ctypes.c_int
    lib.pc_avg_linkage_labels.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32)]
    lib.pc_dbscan_labels.restype = ctypes.c_int
    lib.pc_dbscan_labels.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]


def load() -> Optional[ctypes.CDLL]:
    """The clustering library, built on first use; None if unavailable.
    Concurrent callers serialise on a lock, so a failed attempt is cached
    once and a half-built library is never opened."""
    if "lib" in _lib:
        return _lib["lib"]
    with _lock:
        if "lib" in _lib:
            return _lib["lib"]
        lib = None
        path = library_path()
        try:
            if path is not None:
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
                _configure(lib)
        except (OSError, subprocess.SubprocessError):
            lib = None
        _lib["lib"] = lib
        return lib


def _as_dist_ptr(dist: np.ndarray):
    d = np.ascontiguousarray(dist, dtype=np.float64)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"distance matrix must be square, got {d.shape}")
    return d, d.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def avg_linkage_labels(dist: np.ndarray,
                       threshold: float) -> Optional[np.ndarray]:
    """Average-linkage labels cut at ``threshold`` (scipy fcluster
    "distance" semantics); None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    d, ptr = _as_dist_ptr(dist)
    labels = np.empty(d.shape[0], dtype=np.int32)
    rc = lib.pc_avg_linkage_labels(
        ptr, d.shape[0], float(threshold),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise RuntimeError("pc_avg_linkage_labels failed")
    return labels


def dbscan_labels(dist: np.ndarray, eps: float,
                  min_samples: int) -> Optional[np.ndarray]:
    """DBSCAN labels (sklearn precomputed-metric semantics, noise = -1);
    None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    d, ptr = _as_dist_ptr(dist)
    labels = np.empty(d.shape[0], dtype=np.int32)
    rc = lib.pc_dbscan_labels(
        ptr, d.shape[0], float(eps), int(min_samples),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise RuntimeError("pc_dbscan_labels failed")
    return labels
