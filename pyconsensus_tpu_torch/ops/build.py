"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), all
sources at once, one ``nvcc`` process each. The library name carries a
digest of its source, so an edited source is rebuilt and an unchanged one
is loaded from ``csrc/build/`` as it is. Nothing is built when a module is
imported: the first wrapper that launches a kernel calls :func:`load`.

A kernel store (``serve/aotcache.py``) may be attached with
:func:`attach_store`. Where a library is missing, the store is asked for
it before ``nvcc`` starts: it verifies the stored bytes and installs them
under their own name. After a fresh build the libraries are persisted
into it. Each build, adoption and load is reported to the listeners of
:func:`add_listener` as ``(event, source, seconds)``, with the events
``nvcc``, ``store_adopt`` and ``library_load``
(``obs/compilemon.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "nvcc_path", "build_all", "load",
           "build_log", "build_seconds", "sources_digest", "lib_name",
           "attach_store", "attached_store", "add_listener",
           "remove_listener"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("storage_sweeps.cu", "resolve.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: C signature of every entry point: argtypes (pointers and the stream as
#: c_void_p, so ctypes never truncates them to 32 bits) and int return;
#: ``storage`` is 0 for float32, 1 for int8 sentinel, 2 for bfloat16
_SIGNATURES = {
    "storage_sweeps.cu": {
        # x, storage, R, E, m, a, w, k, n_splits, partial, out, stream
        "pyc_col_pass": (_P, _I, _LL, _LL, _P, _P, _P, _I, _I, _P, _P, _P),
        # R, E, storage, n_sm
        "pyc_col_tile_splits": (_LL, _LL, _I, _I),
        "pyc_row_tile_splits": (_LL, _LL, _I, _I),
        # x, storage, R, E, m, a, vt, k, n_splits, partial, t, stream
        "pyc_row_tile_pass": (_P, _I, _LL, _LL, _P, _P, _P, _I, _I, _P, _P,
                              _P),
        # x, storage, R, E, vt, k, n_splits, partial, t, stream
        "pyc_row_tile_absent": (_P, _I, _LL, _LL, _P, _I, _I, _P, _P, _P),
        # x, storage, R, E, rep, n_chunks, partial, out, stream
        "pyc_fill_stats": (_P, _I, _LL, _LL, _P, _LL, _P, _P, _P),
    },
    "resolve.cu": {
        # x, storage, R, E, C, n_sm, rep, fill, rep_sum, full_total, lo,
        # hi, raw, out, cert, pcol, stream
        "pyc_resolve_cols": (_P, _I, _LL, _LL, _I, _I, _P, _P, _P, _P, _F,
                             _F, _P, _P, _P, _P, _P),
    },
}

#: one thread of a process builds, installs or loads at a time (other
#: processes race only on atomic renames of identical bytes)
_LOCK = threading.RLock()
_LIBS: dict = {}
_LOG: dict = {}
_SECONDS: dict = {}
#: the attached kernel store (``serve.aotcache.AotCache``) or None
_STORE: list = [None]
_LISTENERS: list = []


def attach_store(store):
    """Attach the kernel store that :func:`build_all` adopts missing
    libraries from and persists fresh builds into (None detaches).
    Returns the store that was attached before."""
    with _LOCK:
        previous, _STORE[0] = _STORE[0], store
    return previous


def attached_store():
    """The attached kernel store, or None."""
    return _STORE[0]


def add_listener(fn) -> None:
    """Call ``fn(event, source, seconds)`` at every ``nvcc`` build,
    store adoption and library load of this process."""
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def remove_listener(fn) -> None:
    if fn in _LISTENERS:
        _LISTENERS.remove(fn)


def _emit(event: str, src: str, seconds: float) -> None:
    for fn in list(_LISTENERS):
        fn(event, src, float(seconds))


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``;
    raises ``RuntimeError`` when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}-{digest}.so"


def lib_name(src: str) -> str:
    """The file name of ``src``'s library: ``lib<stem>-<digest>.so``."""
    return _lib_path(src).name


def sources_digest() -> str:
    """One digest of every kernel library this checkout builds: the
    sources, the headers and the compiler flags, as the library names of
    :func:`_lib_path` carry them. Two processes with one digest load the
    same kernels."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(_lib_path(src).name.encode())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; with a kernel store attached, adopt
    missing libraries from it first and persist a fresh build into it.
    Returns ``{source: library path}``; raises ``RuntimeError`` with the
    compiler's output on a failure, or when a library is missing and
    there is no ``nvcc``."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = {src: _lib_path(src) for src in SOURCES}
        todo = [s for s in SOURCES if not out[s].exists()]
        store = _STORE[0]
        if todo and store is not None:
            t0 = time.perf_counter()
            adopted = store.adopt_libraries(todo)
            for src in adopted:     # the read and checks, shared evenly
                _emit("store_adopt", src,
                      (time.perf_counter() - t0) / len(adopted))
            todo = [s for s in SOURCES if not out[s].exists()]
        if not todo:
            return out
        _nvcc(todo, out)
        for src in todo:
            _emit("nvcc", src, _SECONDS[src])
        if store is not None:
            store.persist_libraries()
        return out


def _nvcc(todo: list, out: dict) -> None:
    """Run one ``nvcc`` per source of ``todo``, all at once, each into a
    temporary renamed onto its library path when it succeeds."""
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()

    def finish(src, proc):
        _LOG[src] = proc.communicate()[0]
        _SECONDS[src] = time.perf_counter() - t0

    for src in todo:
        tmp = out[src].with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        waiter = threading.Thread(target=finish, args=(src, proc))
        waiter.start()
        procs[src] = (tmp, proc, waiter)
    failed = []
    for src, (tmp, proc, waiter) in procs.items():
        waiter.join()  # consensus-lint: disable=CL802 — builds serialize under _LOCK by design; the waiter threads take no lock (finish only writes _LOG and _SECONDS)
        text = _LOG[src]
        if proc.returncode != 0:
            failed.append(f"--- {src} (exit {proc.returncode}) ---\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[src])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_log() -> dict:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the sources built by this process."""
    return dict(_LOG)


def build_seconds() -> dict:
    """Seconds from the start of the parallel build to the end of each
    source's ``nvcc``, for the sources built by this process."""
    return dict(_SECONDS)


def load(src: str) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            path = build_all()[src]
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES[src].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[src] = lib
            _emit("library_load", src, time.perf_counter() - t0)
        return lib
