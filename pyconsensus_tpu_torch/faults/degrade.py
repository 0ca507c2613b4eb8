"""Graceful degradation: row quarantine and the fallback chain
(``pyconsensus_tpu/faults/degrade.py``).

**Row quarantine.** NaN is the legal non-participation marker; a row
holding ±Inf is replaced by an all-NaN row (the reporter is not heard this
round), its index is reported to the caller in ``quarantined_rows`` and
counted in ``pyconsensus_quarantined_rows_total``. One ``np.isfinite``
pass gives ``has_na`` as well, so a clean matrix pays no extra pass.

**Fallback chain.** A power-family PCA that fails to converge, or
numerically degenerate inputs, can leave non-finite values in the
*outputs*. Detection is host-side on the fetched result
(:func:`result_nonfinite`, O(R + E), no extra device sync), and recovery
walks the reference's chain, re-resolving with strictly more
conservative numerics at each rung::

    power-fused (the Hopper kernels)  ->  eigh-gram (exact)  ->  numpy

The torch rungs run on the resolution's own device; the numpy rung runs
on the host. Each hop emits ``pyconsensus_fallbacks_total{from,to,
reason}``, where a hop off the torch backend reads ``torch:<method>``
(``jax:<method>`` in the JAX package). If the numpy rung's outputs are
non-finite too, the failure is genuine: :class:`ConvergenceError`
(PYC202, a power-family start) or :class:`NumericsError` (PYC201, an
exact start) is raised rather than a poisoned result returned. Only a
non-finite result enters the chain: a kernel build or launch error, or a
missing card, propagates to the caller and starts no rung.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import obs
from .errors import ConvergenceError, NumericsError

__all__ = ["quarantine_nonfinite", "result_nonfinite", "record_fallback",
           "fallback_steps", "raise_exhausted", "POWER_METHODS"]

#: pca methods whose failure mode is iterative non-convergence — the
#: chain's entry rungs (and the ConvergenceError classification)
POWER_METHODS = ("power-fused", "power")

#: result keys checked for non-finite values, the O(R) reputation first
_CHECK_KEYS = ("smooth_rep", "this_rep", "outcomes_final", "certainty")


def quarantine_nonfinite(reports: np.ndarray
                         ) -> Tuple[np.ndarray, Optional[np.ndarray], bool]:
    """Replace rows holding a non-finite value that is not NaN with
    all-NaN rows. Returns ``(reports, quarantined_row_indices-or-None,
    has_na)``; the input is copied only when a row is quarantined."""
    finite = np.isfinite(reports)
    if finite.all():
        return reports, None, False
    poisoned = ~finite & ~np.isnan(reports)
    rows = poisoned.any(axis=1)
    if not rows.any():
        return reports, None, True
    out = np.array(reports, copy=True)
    out[rows] = np.nan
    idx = np.nonzero(rows)[0]
    obs.counter(
        "pyconsensus_quarantined_rows_total",
        "report rows quarantined (set to full non-participation) for "
        "carrying non-finite non-NaN values").inc(int(idx.size))
    return out, idx, True


def result_nonfinite(raw: dict) -> bool:
    """Whether a host result dict carries non-finite values in its
    decision outputs. O(R + E)."""
    for key in _CHECK_KEYS:
        v = raw.get(key)
        if v is not None and not np.isfinite(
                np.asarray(v, dtype=np.float64)).all():
            return True
    return False


def record_fallback(frm: str, to: str, reason: str) -> None:
    obs.counter(
        "pyconsensus_fallbacks_total",
        "graceful-degradation fallback hops (power-fused -> eigh-gram -> "
        "numpy)",
        labels=("from", "to", "reason")).inc(
            **{"from": frm, "to": to, "reason": reason})


def fallback_steps(pca_method: str, backend: str):
    """The ordered ``(from_label, to_label, params_update)`` hops to try
    after a non-finite result. ``params_update`` is a dict of
    ConsensusParams field overrides; the special key ``"backend"``
    switches the whole execution path to the numpy pipeline. The numpy
    backend has no rung below it."""
    steps = []
    if backend == "torch" and pca_method in POWER_METHODS:
        steps.append((pca_method, "eigh-gram",
                      {"pca_method": "eigh-gram", "fused_resolution": False,
                       "allow_fused": False}))
    if backend == "torch":
        frm = "eigh-gram" if pca_method in POWER_METHODS else pca_method
        steps.append((f"torch:{frm}", "numpy", {"backend": "numpy"}))
    return steps


def raise_exhausted(pca_method: str, algorithm: str) -> None:
    """Every rung failed: classify and raise (never return poison)."""
    if pca_method in POWER_METHODS:
        raise ConvergenceError(
            f"power-family PCA ({pca_method!r}) produced non-finite "
            f"scores and every fallback rung (eigh-gram, numpy) stayed "
            f"non-finite — the {algorithm!r} resolution has no convergent "
            f"route for this input",
            pca_method=pca_method, algorithm=algorithm)
    raise NumericsError(
        f"non-finite values in the {algorithm!r} resolution outputs "
        f"survived the whole fallback chain — refusing to return a "
        f"poisoned result",
        pca_method=pca_method, algorithm=algorithm)
