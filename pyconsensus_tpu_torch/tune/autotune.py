"""Sweep, persist and replay the Hopper kernels' launch shapes
(``pyconsensus_tpu/tune/autotune.py``).

The knobs are the ones a launch chooses (``ops/cuda_kernels.py``, "launch
shape models"): the split counts of the row-tile and column-tile passes
(``row_tile_splits``, ``col_tile_splits``: how many ranges of the
reduction axis go to partials), which every storage sweep but the fill
statistics runs on, and the panel width of resolve's column kernel
(``resolve_block_cols``). The compile-time tile shapes stay constants.
Design rules, the reference's:

- **Legality is the kernels' own shape models.** The sweep spaces are
  ``cuda_kernels.split_candidates`` / ``resolve_block_candidates``, the
  built-in choice always among them, and the launch re-validates a
  provider's value: a stale or hand-edited entry can cost speed but can
  never launch an illegal shape.
- **Launch shapes never change results.** Each sweep runs every
  candidate on the same seeded inputs and asserts its outputs agree with
  the built-in shape's before a winner may persist (catch-snapped outputs
  bit for bit, the continuous sums within ``AGREE_RTOL`` of their largest
  magnitude, floored at 1: the kernel band of ``chip_smoke.py``), and
  every candidate's outputs, the built-in's too, with the kernel's plain
  PyTorch version within that band. A split count changes the order of
  float32 sums, never what is summed.
- **A winner must beat the noise.** On the card each candidate is timed
  with CUDA events in interleaved rounds (a host's rates have moved
  1.5-2.2x within one chip call), and a candidate replaces the built-in
  only when its interquartile range of those rounds lies wholly below the
  built-in's (:func:`_decide`). Otherwise the built-in persists: a tuned
  process then sums in the same order as an untuned one, so a fleet of
  workers with and without the cache file agrees bit for bit.
- **Deterministic off the card.** ``device="cpu"`` sweeps (the CPU tests,
  the CI smoke) still run every candidate, through the plain versions,
  but pick the built-in value (for the split counts, the built-in for
  ``NOMINAL_SMS``): CPU timings say nothing about the card.
- **Crash-safe, replay-stable persistence.** Winners go through
  ``io.atomic_write`` under the ``tune.cache_write`` fault site; a torn,
  corrupt or foreign-version file loads as empty (the fallbacks still
  serve), never trusted.
- **Import-time environment resolution.** ``PYCONSENSUS_AUTOTUNE_CACHE``
  is read once, at import, and the default provider is inert on a
  process mesh (``torch.distributed`` initialised over more than one
  rank): per-host cache files could otherwise launch different shapes on
  different ranks of one program.

Keys are ``<generation>/<kind>/i<itemsize>/<shape class>``. The
generation is ``tune.fingerprint.device_generation`` (the card's name
and ``sm_XY``, or ``"cpu"``), so an entry that the reference wrote (its
TPU generation, or ``"interpret"``) is never a hit here. The split kinds
depend on both R and E (``wave_splits`` reads both), so their class is
``p<R class>xp<E class>`` and they are probed at the requested shape;
resolve's width is keyed by the R class alone, as the reference's.
"""

from __future__ import annotations

import json
import os
import pathlib
import time

import numpy as np
import torch

from .. import io as pio
from .. import obs
from ..faults import plan as _faults
from ..ops import cuda_kernels as ck
from ..parallel.sharded import resolve_device
from .fingerprint import device_generation

__all__ = ["autotune_cov", "autotune_resolve", "autotune_pipeline_depth",
           "tuned_pipeline_depth", "depth_candidates", "default_provider",
           "install", "TuneCache", "cache_path", "shape_class",
           "split_class", "FALLBACK_TABLE", "AGREE_RTOL", "SPLIT_KINDS"]

_VERSION = 1

#: the cache location override, read once at import (a per-call read could
#: give two launches of one process different shapes)
_CACHE_PATH_ENV = os.environ.get("PYCONSENSUS_AUTOTUNE_CACHE", "")

#: the port's own default cache file, apart from the reference's
_DEFAULT_CACHE = "~/.cache/pyconsensus_tpu_torch/autotune.json"

#: the two tile passes' split kinds, which ``autotune_cov`` sweeps
SPLIT_KINDS = ("row_tile_splits", "col_tile_splits")

#: a candidate's continuous outputs against the built-in's, relative to
#: max(max |built-in|, 1): the kernel phase's band
AGREE_RTOL = 3e-5

#: deterministic fallback rows consulted when no cache entry exists, keyed
#: ``(kind, generation)`` with ``"*"`` for any generation. ``None`` (and a
#: missing row) means the built-in shape models of ``ops/cuda_kernels.py``,
#: which are the measured defaults; the table carries only the rows where
#: a generation wants something else. Depth 2 overlaps one result fetch
#: with the next dispatch, the reference's default everywhere.
FALLBACK_TABLE = {
    ("row_tile_splits", "*"): None,
    ("col_tile_splits", "*"): None,
    ("resolve_block_cols", "*"): None,
    ("pipeline_depth", "*"): 2,
}

#: storage encodings the kernels take, by the name the sweeps are given
#: ("" is the port's full storage, float32)
_STORAGE = {"": torch.float32, "float32": torch.float32,
            "bfloat16": torch.bfloat16, "int8": torch.int8}


def shape_class(n: int) -> str:
    """Power-of-two shape-class bucket (``"p4096"``): winners generalize
    across nearby sizes but not across decades, and the padded serving
    buckets land exactly on class boundaries."""
    p = 1
    while p < max(1, int(n)):
        p *= 2
    return f"p{p}"


def split_class(n_reporters: int, n_events: int) -> str:
    """The class of a split kind: both axes, since the built-in split
    count reads both (``"p16384xp131072"``)."""
    return f"{shape_class(n_reporters)}x{shape_class(n_events)}"


def _entry_key(kind: str, generation: str, itemsize: int, cls: str) -> str:
    return f"{generation}/{kind}/i{int(itemsize)}/{cls}"


def cache_path(path=None) -> pathlib.Path:
    """The autotune cache file: explicit ``path`` >
    ``PYCONSENSUS_AUTOTUNE_CACHE`` (resolved at import) >
    ``~/.cache/pyconsensus_tpu_torch/autotune.json``."""
    p = path or _CACHE_PATH_ENV or _DEFAULT_CACHE
    return pathlib.Path(p).expanduser()


def _sweeps_counter():
    return obs.counter(
        "pyconsensus_autotune_sweeps_total",
        "autotune sweeps executed (cache misses that measured candidates)",
        labels=("kind",))


def _hits_counter():
    return obs.counter(
        "pyconsensus_autotune_cache_hits_total",
        "autotune lookups served from the persisted cache",
        labels=("kind",))


def _configs_counter():
    return obs.counter(
        "pyconsensus_autotune_configs_total",
        "candidate block configurations evaluated by autotune sweeps",
        labels=("kind",))


def _fallback_counter():
    return obs.counter(
        "pyconsensus_autotune_fallback_total",
        "provider lookups that fell through to the fallback table or the "
        "in-kernel heuristic", labels=("kind",))


class TuneCache:
    """The persisted winner table — one JSON file, atomically replaced on
    every ``put`` (a crash leaves the old content or the new, never a torn
    file). A corrupt, torn or foreign-version file loads as EMPTY with a
    warning on stderr: the fallbacks still serve, and the next sweep's
    ``put`` rewrites a clean file."""

    def __init__(self, path=None) -> None:
        self.path = cache_path(path)
        self.entries: dict = {}
        self.load()

    def load(self) -> None:
        import sys

        self.entries = {}
        try:
            raw = json.loads(self.path.read_text())
        except FileNotFoundError:
            return
        except (ValueError, OSError) as exc:
            print(f"WARNING: autotune cache {self.path} unreadable "
                  f"({type(exc).__name__}: {exc}); treating as empty",
                  file=sys.stderr)
            return
        if isinstance(raw, dict) and raw.get("version") == _VERSION and \
                isinstance(raw.get("entries"), dict):
            self.entries = raw["entries"]
        else:
            version = raw.get("version") if isinstance(raw, dict) else None
            print(f"WARNING: autotune cache {self.path} has version "
                  f"{version!r} != {_VERSION}; ignoring it", file=sys.stderr)

    def get(self, key: str):
        entry = self.entries.get(key)
        return entry if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry
        payload = json.dumps({"version": _VERSION, "entries": self.entries},
                             indent=1, sort_keys=True)
        _faults.fire("tune.cache_write", path=self.path)

        def writer(tmp):
            pathlib.Path(tmp).write_text(payload)

        pio.atomic_write(self.path, writer)


# -- provider (launch-time lookup) ---------------------------------------------


def _fallback(kind: str, generation: str):
    row = FALLBACK_TABLE.get((kind, generation))
    if row is None:
        row = FALLBACK_TABLE.get((kind, "*"))
    return row


def _multiprocess() -> bool:
    """Whether this process is one rank of a process mesh."""
    import torch.distributed as dist

    return bool(dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def default_provider(path=None, device=None):
    """The provider ``ops/cuda_kernels.py`` lazily installs at its first
    launch on a card: persisted winner first (counted as a cache hit),
    then :data:`FALLBACK_TABLE`, then None (the built-in shape models).
    Resolves the cache file and the generation of ``device`` (None: the
    card) ONCE, so the provider is a pure dict lookup for the process's
    lifetime.

    On a process mesh the provider is inert (always falls back): per-host
    cache files could launch different shapes on different ranks."""
    if _multiprocess():
        def inert(kind, **ctx):
            _fallback_counter().inc(kind=kind)
            return _fallback(kind, "multiprocess")
        return inert

    cache = TuneCache(path)
    generation = device_generation(device)
    hits, fallbacks = _hits_counter(), _fallback_counter()

    def provider(kind, **ctx):
        if kind in SPLIT_KINDS:
            cls = split_class(ctx["n_reporters"], ctx["n_events"])
        elif kind == "resolve_block_cols":
            cls = shape_class(ctx["n_reporters"])
        else:
            return None
        entry = cache.get(_entry_key(kind, generation, ctx["itemsize"], cls))
        if entry is not None:
            hits.inc(kind=kind)
            return entry.get("value")
        fallbacks.inc(kind=kind)
        return _fallback(kind, generation)

    return provider


def install(path=None, device=None):
    """Build the default provider from ``path`` (or the default cache) for
    ``device`` and install it into ``ops/cuda_kernels.py`` — the explicit
    form of the lazy launch-time autoload. Returns the provider."""
    provider = default_provider(path, device)
    ck.set_tune_provider(provider)
    return provider


# -- sweeps --------------------------------------------------------------------


def _itemsize(storage_dtype: str) -> int:
    if storage_dtype not in _STORAGE:
        raise ValueError(f"storage_dtype must be one of {sorted(_STORAGE)}, "
                         f"got {storage_dtype!r}")
    return torch.empty((), dtype=_STORAGE[storage_dtype]).element_size()


def _synth_storage(R: int, E: int, storage_dtype: str, na_frac: float,
                   seed: int, dev: torch.device) -> torch.Tensor:
    """Seeded lattice values {0, 0.5, 1} with absences, drawn on ``dev`` in
    row blocks into the requested storage (int8 sentinel, or float with
    NaN absent)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = _STORAGE[storage_dtype]
    x = torch.empty((R, E), dtype=dt, device=dev)
    rows = max(1, (1 << 26) // max(1, E))
    for r0 in range(0, R, rows):
        r1 = min(R, r0 + rows)
        twice = torch.randint(0, 3, (r1 - r0, E), generator=g, device=dev)
        na = torch.rand((r1 - r0, E), generator=g, device=dev) < na_frac
        if dt == torch.int8:
            x[r0:r1] = twice.masked_fill_(na, -1)
        else:
            x[r0:r1] = (twice * 0.5).masked_fill_(na, float("nan"))
    return x


def _probe(R: int, E: int, storage_dtype: str, na_frac: float, seed: int,
           dev: torch.device, x=None):
    """``(x, rep, fill, mu, v)`` for a sweep: ``x`` as given (it must be
    (R, E) storage of ``storage_dtype`` on ``dev``) or drawn; the uniform
    reputation, a lattice fill and a seeded centre and vector."""
    if x is None:
        x = _synth_storage(R, E, storage_dtype, na_frac, seed, dev)
    elif (tuple(x.shape) != (R, E) or x.dtype != _STORAGE[storage_dtype]
          or x.device.type != dev.type):
        raise ValueError(f"x must be ({R}, {E}) {_STORAGE[storage_dtype]} "
                         f"storage on {dev}, got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    rep = torch.full((R,), 1.0 / R, dtype=torch.float32, device=dev)
    fill = torch.randint(0, 3, (E,), generator=g, device=dev) * 0.5
    mu = torch.rand(E, generator=g, device=dev)
    v = torch.randn(E, generator=g, device=dev)
    return x, rep, fill.to(torch.float32), mu, v


def _host(out) -> tuple:
    return tuple(o.detach().to("cpu", torch.float64).numpy() for o in out)


def _interleaved_ms(runs: dict, repeats: int, dev: torch.device) -> dict:
    """Milliseconds of each candidate's ``run()`` in every round, each
    call between two CUDA events, the candidates taken in turn in
    ``repeats`` rounds (after one untimed call each), so a drift of the
    host's or the card's pace falls on every candidate alike."""
    samples = {c: [] for c in runs}
    with torch.cuda.device(dev):
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        for _ in range(max(1, repeats)):
            for c, fn in runs.items():
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                samples[c].append(a.elapsed_time(b))
    return samples


def _decide(samples: dict, builtin) -> tuple:
    """``(pick, timings)`` from each candidate's round times: ``timings``
    maps a candidate to its median, first and third quartile (ms). A
    candidate wins only when its third quartile lies below the built-in's
    first, so the rounds' spread cannot crown it; of several such, the
    lowest median. Otherwise the built-in stays."""
    timings = {c: tuple(float(q) for q in np.percentile(s, (50, 25, 75)))
               for c, s in samples.items()}
    floor = timings[builtin][1]
    clear = [c for c in samples if c != builtin and timings[c][2] < floor]
    pick = min(clear, key=lambda c: (timings[c][0], c)) if clear else builtin
    return pick, timings


def _band(a, b, msg: str) -> None:
    """``b`` within ``AGREE_RTOL`` of max(max |a|, 1) of ``a``."""
    finite = np.abs(a[np.isfinite(a)])
    scale = max(float(finite.max()) if finite.size else 0.0, 1.0)
    np.testing.assert_allclose(b, a, rtol=0, atol=AGREE_RTOL * scale,
                               equal_nan=True, err_msg=msg)


def _agreeing_winner(results: dict, candidates, builtin, pick, kind: str,
                     exact=(), plain=None):
    """Assert every candidate's outputs agree with the built-in shape's,
    and with ``plain`` (the plain PyTorch version's outputs) when given,
    then return the picked winner. ``results`` maps a candidate to a tuple
    of host arrays; against the built-in those at the indices ``exact``
    (catch-snapped outcomes, counts) must be bit-identical, the rest
    within ``AGREE_RTOL`` of max(max |built-in|, 1); against the plain
    version every output is held to that band, as the kernel phase holds
    each kernel."""
    base = results[builtin]
    for c in candidates:
        for i, b in enumerate(results[c]):
            if c != builtin:
                msg = (f"autotune {kind}: candidate {c} output {i} "
                       f"disagrees with the built-in {builtin} — launch "
                       f"shapes must never change results")
                if i in exact:
                    np.testing.assert_array_equal(b, base[i], err_msg=msg)
                else:
                    _band(base[i], b, msg)
            if plain is not None:
                _band(plain[i], b, f"autotune {kind}: candidate {c} output "
                      f"{i} disagrees with the plain version")
    return pick


def _n_sm(dev: torch.device) -> int:
    return ck.NOMINAL_SMS if dev.type == "cpu" else \
        ck._sm_count(dev.index if dev.index is not None else 0)


def _sweep(kind, candidates, builtin, run, dev, repeats, exact=(),
           plain=None):
    """Run every candidate, check they agree with the built-in and with
    ``plain()``, time them on the card and return ``(pick, timings or
    None)`` (:func:`_decide`)."""
    results = {}
    for c in candidates:
        _configs_counter().inc(kind=kind)
        results[c] = _host(run(c))
    _agreeing_winner(results, candidates, builtin, None, kind, exact,
                     None if plain is None else _host(plain()))
    if dev.type == "cpu":
        return builtin, None
    return _decide(_interleaved_ms({c: (lambda c=c: run(c))
                                    for c in candidates}, repeats, dev),
                   builtin)


def _entry(kind, pick, candidates, builtin, dev, probe, timings, **extra):
    """The persisted record of a sweep: the value, and on the card each
    candidate's median round time (``timings_ms``), its interquartile
    range (``iqr_ms``) and the candidate of the lowest median
    (``fastest``), which stays unpersisted when it does not clear the
    built-in's spread."""
    entry = {"value": int(pick), "kind": kind, "builtin": int(builtin),
             "candidates": [int(c) for c in candidates],
             "mode": "deterministic" if dev.type == "cpu" else "timed",
             "probe_shape": [int(n) for n in probe], **extra}
    if timings is not None:
        entry["timings_ms"] = {str(c): round(t[0], 4)
                               for c, t in timings.items()}
        entry["iqr_ms"] = {str(c): [round(t[1], 4), round(t[2], 4)]
                           for c, t in timings.items()}
        entry["fastest"] = int(min(timings, key=lambda c: (timings[c][0],
                                                           c)))
    return entry


def autotune_resolve(n_reporters: int, n_events: int = 512,
                     storage_dtype: str = "", *, device=None, path=None,
                     force: bool = False, repeats: int = 5,
                     na_frac: float = 0.05, seed: int = 0, x=None) -> dict:
    """Sweep resolve's column-panel width for this reporter shape class,
    probed at (``n_reporters``, ``n_events``) (on ``x`` when given), and
    persist the winner. Returns the cache entry (``{"value": C, ...}``);
    a cache hit (same key, ``force=False``) skips the sweep. ``device``
    None is the card; ``"cpu"`` sweeps deterministically."""
    dev = resolve_device(device)
    itemsize = _itemsize(storage_dtype)
    kind = "resolve_block_cols"
    key = _entry_key(kind, device_generation(dev), itemsize,
                     shape_class(n_reporters))
    cache = TuneCache(path)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            _hits_counter().inc(kind=kind)
            return hit
    candidates = ck.resolve_block_candidates(n_reporters, itemsize)
    if not candidates:
        raise ValueError(f"R={n_reporters} has no legal resolve panel width "
                         f"at itemsize {itemsize}; the plain back half "
                         f"serves this shape")
    _sweeps_counter().inc(kind=kind)
    x, rep, fill, _, _ = _probe(n_reporters, n_events, storage_dtype,
                                na_frac, seed, dev, x)
    total = rep.sum()
    rows = ck.row_tile_splits(n_reporters, n_events, itemsize, _n_sm(dev))

    def run(C):
        # the row half at its built-in split count, whatever provider is
        # installed
        return ck.resolve_certainty_fused(x, rep, fill, total, 0.1,
                                          block_cols=C, row_splits=rows)

    builtin = ck.resolve_block_cols(n_reporters, itemsize)
    # outcomes and absent counts exact; means, certainty, participation
    # within the band
    pick, timings = _sweep(
        kind, candidates, builtin, run, dev, repeats, exact=(1, 5),
        plain=lambda: ck.resolve_certainty_fused_plain(x, rep, fill, total,
                                                       0.1))
    entry = _entry(kind, pick, candidates, builtin, dev,
                   (n_reporters, n_events), timings,
                   storage_dtype=storage_dtype or "float32")
    cache.put(key, entry)
    return entry


def autotune_cov(n_events: int, n_reporters: int = 256,
                 storage_dtype: str = "", *, device=None, path=None,
                 force: bool = False, repeats: int = 5,
                 na_frac: float = 0.05, seed: int = 0, x=None) -> dict:
    """Sweep the split counts of the two tile passes at (``n_reporters``,
    ``n_events``) (on ``x`` when given) and persist one winner for each
    (``row_tile_splits``, ``col_tile_splits``). A candidate runs the
    covariance sweep ``apply_weighted_cov`` — both passes, the main
    path's B.1 — with that count forced on its pass and the other pass's
    built-in count on the other, through the wrapper's explicit overrides
    (so no installed provider takes part). Returns ``{kind: entry}``; a
    cache hit skips that kind's sweep."""
    dev = resolve_device(device)
    itemsize = _itemsize(storage_dtype)
    generation = device_generation(dev)
    cache = TuneCache(path)
    out, probe = {}, None
    for kind in SPLIT_KINDS:
        key = _entry_key(kind, generation, itemsize,
                         split_class(n_reporters, n_events))
        hit = None if force else cache.get(key)
        if hit is not None:
            _hits_counter().inc(kind=kind)
            out[kind] = hit
            continue
        candidates = ck.split_candidates(kind, n_reporters, n_events,
                                         itemsize)
        if not candidates:
            raise ValueError(f"{n_reporters} x {n_events} has no legal "
                             f"{kind} at itemsize {itemsize}")
        _sweeps_counter().inc(kind=kind)
        if probe is None:
            probe = _probe(n_reporters, n_events, storage_dtype, na_frac,
                           seed, dev, x)
        xs, rep, fill, mu, v = probe
        shape = (n_reporters, n_events, itemsize, _n_sm(dev))
        fixed = {"row_splits": ck.row_tile_splits(*shape),
                 "col_splits": ck.col_tile_splits(*shape)}
        arg = "row_splits" if kind == "row_tile_splits" else "col_splits"
        builtin = fixed[arg]

        def run(s, arg=arg):
            return (ck.apply_weighted_cov(xs, mu, rep, v, fill,
                                          **{**fixed, arg: s}),)

        pick, timings = _sweep(
            kind, candidates, builtin, run, dev, repeats,
            plain=lambda: (ck.apply_weighted_cov_plain(xs, mu, rep, v,
                                                       fill),))
        entry = _entry(kind, pick, candidates, builtin, dev,
                       (n_reporters, n_events), timings,
                       storage_dtype=storage_dtype or "float32")
        cache.put(key, entry)
        out[kind] = entry
    return out


def depth_candidates(max_depth: int = 4) -> tuple:
    """The dispatch pipeline-depth sweep space: 1 (synchronous) through
    ``max_depth`` in-flight dispatches. Depth is a host dispatch-loop
    knob, never a launch shape, so every candidate is legal — the sweep
    ranks them and asserts that depth changes no result."""
    return tuple(range(1, max(1, int(max_depth)) + 1))


def _default_itemsize() -> int:
    return torch.empty((), dtype=torch.get_default_dtype()).element_size()


def tuned_pipeline_depth(n_events: int, path=None, device=None) -> int:
    """The dispatch pipeline depth for this event shape class on
    ``device`` (None: the card): persisted winner first (a cache hit),
    then :data:`FALLBACK_TABLE` (2 everywhere). ``ServeConfig.
    pipeline_depth = 0`` resolves through here. A rank of a process mesh
    takes the fallback: per-host winner files must not pace one fleet's
    rings apart."""
    if _multiprocess():
        _fallback_counter().inc(kind="pipeline_depth")
        return int(_fallback("pipeline_depth", "multiprocess") or 2)
    generation = device_generation(device)
    key = _entry_key("pipeline_depth", generation, _default_itemsize(),
                     shape_class(n_events))
    entry = TuneCache(path).get(key)
    value = entry.get("value") if entry is not None else None
    if isinstance(value, int) and not isinstance(value, bool) and value > 0:
        _hits_counter().inc(kind="pipeline_depth")
        return value
    _fallback_counter().inc(kind="pipeline_depth")
    return int(_fallback("pipeline_depth", generation) or 2)


def autotune_pipeline_depth(n_reporters: int = 32, n_events: int = 256, *,
                            device=None, path=None, force: bool = False,
                            repeats: int = 3, dispatches: int = 8,
                            seed: int = 0) -> dict:
    """Sweep the dispatch pipeline depth for this event shape class and
    persist the winner (keyed generation / the default dtype's itemsize /
    E class). The depth paces one route alone: the padded ``bucket`` ring
    of the ``Microbatcher`` (``bucket_cuda``, direct and session
    dispatches fetch each result before the next). So each candidate is
    a ``ConsensusService`` at that depth on ``device``, fed ``dispatches``
    full batches (``max_batch`` lanes each) of seeded
    ``n_reporters x n_events`` requests at once, through the service's own
    routing; the requests carry one scaled event, which the routing rule
    (``serve.cuda.cuda_bucket_eligible``) keeps off ``bucket_cuda`` on
    every device, and the sweep fails unless every one was served on the
    ``bucket`` route. Every candidate's results must equal depth 1's bit
    for bit (depth changes WHEN results are fetched, never what they
    are). On the CPU the fallback (2) is picked; on the card each
    candidate's wall time from the first submit to the last result, in
    interleaved rounds, decides as :func:`_decide` does against the
    fallback."""
    from dataclasses import replace

    from ..serve import ConsensusService, ServeConfig

    dev = resolve_device(device)
    generation = device_generation(dev)
    kind = "pipeline_depth"
    key = _entry_key(kind, generation, _default_itemsize(),
                     shape_class(n_events))
    cache = TuneCache(path)
    if not force:
        hit = cache.get(key)
        if hit is not None:
            _hits_counter().inc(kind=kind)
            return hit
    candidates = depth_candidates()
    fallback = int(_fallback(kind, generation) or 2)
    _sweeps_counter().inc(kind=kind)
    cfg = ServeConfig()
    rng = np.random.default_rng(seed)
    bounds = [None] * (n_events - 1) + [{"scaled": True, "min": 0.0,
                                         "max": 10.0}]
    requests = []
    for _ in range(max(1, dispatches) * cfg.max_batch):
        m = rng.choice([0.0, 1.0], size=(n_reporters, n_events))
        m[:, -1] = rng.uniform(0.0, 10.0, n_reporters)
        m[0, 0] = np.nan                    # exercise the fill
        requests.append(m)
    services = {d: ConsensusService(replace(cfg, pipeline_depth=d),
                                    device=dev) for d in candidates}

    def served():
        return obs.value("pyconsensus_serve_requests_total", path="bucket",
                         outcome="ok") or 0

    def run(d):
        futures = [services[d].submit(reports=m, event_bounds=bounds)
                   for m in requests]
        out = [f.result(600) for f in futures]
        return [r["events"]["outcomes_final"] for r in out] + \
            [r["agents"]["smooth_rep"] for r in out]

    try:
        results, timings, rounds = {}, None, 1
        n0 = served()
        for d in candidates:
            _configs_counter().inc(kind=kind)
            results[d] = tuple(np.asarray(a) for a in run(d))
        pick = _agreeing_winner(results, candidates, candidates[0],
                                fallback, kind,
                                exact=range(2 * len(requests)))
        if dev.type != "cpu":
            samples = {d: [] for d in candidates}
            for _ in range(max(1, repeats)):
                for d in candidates:
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    run(d)
                    samples[d].append((time.perf_counter() - t0) * 1e3)
            rounds += max(1, repeats)
            pick, timings = _decide(samples, fallback)
        if served() - n0 != rounds * len(candidates) * len(requests):
            raise RuntimeError("autotune pipeline_depth: a request left the "
                               "bucket ring route; the sweep would time a "
                               "route that reads no depth")
    finally:
        for svc in services.values():
            svc.close()
    entry = _entry(kind, pick, candidates, fallback, dev,
                   (n_reporters, n_events), timings, route="bucket",
                   requests=int(len(requests)))
    cache.put(key, entry)
    return entry
