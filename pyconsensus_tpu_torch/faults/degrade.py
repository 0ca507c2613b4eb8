"""Row quarantine for host report matrices, and the non-finite check of
a fetched result.

NaN is the legal non-participation marker; a row holding ±Inf is
replaced by an all-NaN row (the reporter is not heard this round) and
its index is reported to the caller in ``quarantined_rows``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["quarantine_nonfinite", "result_nonfinite"]

#: result keys checked for non-finite values, the O(R) reputation first
_CHECK_KEYS = ("smooth_rep", "this_rep", "outcomes_final", "certainty")


def quarantine_nonfinite(reports: np.ndarray
                         ) -> Tuple[np.ndarray, Optional[np.ndarray], bool]:
    """Replace rows holding a non-finite value that is not NaN with
    all-NaN rows. Returns ``(reports, quarantined_row_indices-or-None,
    has_na)``; the input is copied only when a row is quarantined. One
    ``np.isfinite`` pass gives ``has_na`` as well."""
    finite = np.isfinite(reports)
    if finite.all():
        return reports, None, False
    poisoned = ~finite & ~np.isnan(reports)
    rows = poisoned.any(axis=1)
    if not rows.any():
        return reports, None, True
    out = np.array(reports, copy=True)
    out[rows] = np.nan
    return out, np.nonzero(rows)[0], True


def result_nonfinite(raw: dict) -> bool:
    """Whether a host result dict carries non-finite values in its
    decision outputs. O(R + E)."""
    for key in _CHECK_KEYS:
        v = raw.get(key)
        if v is not None and not np.isfinite(
                np.asarray(v, dtype=np.float64)).all():
            return True
    return False
