"""Algorithm-variant sweep (``pyconsensus_tpu/sweep.py``): resolve one
reports matrix under several ``algorithm=`` variants.

The device variants (``JIT_ALGORITHMS``) are dispatched first, each
through ``Oracle.resolve_raw`` with its result left on the device, so the
card works through their queued kernels back to back; the hybrid
variants (host clustering) then run while that queue drains, and only
afterwards are the device results fetched.

>>> from pyconsensus_tpu_torch.sweep import compare_algorithms
>>> res = compare_algorithms(reports, max_iterations=3)
>>> res["sztorc"]["events"]["outcomes_final"]
>>> disagreement_matrix(res)          # which variants disagree where
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from . import obs
from .models.pipeline import HYBRID_ALGORITHMS, JIT_ALGORITHMS
from .oracle import ALGORITHMS, Oracle, _host, assemble_result

__all__ = ["compare_algorithms", "disagreement_matrix"]


def compare_algorithms(reports, algorithms: Optional[Sequence[str]] = None,
                       event_bounds=None, reputation=None,
                       **oracle_kwargs) -> Dict[str, dict]:
    """Resolve ``reports`` under every algorithm in ``algorithms``
    (default: all seven, sorted), returning ``{algorithm: result dict}``.
    ``oracle_kwargs`` pass through to :class:`Oracle` (``device`` among
    them; ``backend`` is forced to ``"torch"``). The device variants'
    results come from ``resolve_raw``, without the fallback chain, as in
    the reference."""
    algorithms = tuple(algorithms if algorithms is not None else
                       sorted(ALGORITHMS))
    for a in algorithms:
        if a not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {a!r}; "
                             f"choose from {sorted(ALGORITHMS)}")
    oracle_kwargs.pop("backend", None)
    oracle_kwargs.pop("algorithm", None)

    def make(a):
        return Oracle(reports=reports, event_bounds=event_bounds,
                      reputation=reputation, algorithm=a, backend="torch",
                      **oracle_kwargs)

    with obs.span("sweep.compare_algorithms",
                  algorithms=",".join(algorithms)):
        raw: Dict[str, dict] = {}
        with obs.span("sweep.dispatch_jit"):
            for a in algorithms:
                if a in JIT_ALGORITHMS:
                    raw[a] = make(a).resolve_raw()
        results: Dict[str, dict] = {}
        for a in algorithms:
            if a in HYBRID_ALGORITHMS:
                results[a] = make(a).consensus()
        with obs.span("sweep.fetch_jit"):
            for a, r in raw.items():
                results[a] = assemble_result(
                    {k: _host(v) for k, v in r.items()})
    return {a: results[a] for a in algorithms}


def disagreement_matrix(results: Dict[str, dict]) -> np.ndarray:
    """(n, n) count of events whose final outcomes differ between each
    pair of variants of a :func:`compare_algorithms` result."""
    names = list(results)
    outs = [np.asarray(results[a]["events"]["outcomes_final"])
            for a in names]
    n = len(names)
    m = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            m[i, j] = int(np.sum(outs[i] != outs[j]))
    return m
