"""Carry state from the JAX package into the port.

:func:`params_from_reference` takes ``pyconsensus_tpu``'s
``ConsensusParams._asdict()`` (a plain dict, so this module never imports
the JAX package); :func:`inputs_from_reference` takes its numpy inputs,
pre-encoded int8 sentinel storage included, and places them as tensors.
The two packages then compute on the same things.
"""

from __future__ import annotations

import numpy as np

from .faults.errors import InputError
from .models.pipeline import ConsensusParams
from .parallel.sharded import _place_reports, _place_reputation, \
    resolve_device

__all__ = ["params_from_reference", "inputs_from_reference"]


def params_from_reference(d: dict) -> ConsensusParams:
    """The port's ``ConsensusParams`` from the reference's ``_asdict()``;
    refuses a field the port does not know."""
    unknown = sorted(set(d) - set(ConsensusParams._fields))
    if unknown:
        raise InputError(f"unknown ConsensusParams fields: {unknown}",
                         fields=unknown)
    return ConsensusParams(**dict(d))


def inputs_from_reference(reports, reputation=None, device=None):
    """``(reports, reputation)`` as tensors on ``device`` (``None`` = the
    card). int8 reports are taken as sentinel storage and keep their
    dtype; float reports become float32 with NaN kept. A float64
    reputation stays float64; ``None`` stays ``None`` (the front door
    then uses the uniform float32 reputation)."""
    dev = resolve_device(device)
    reports = np.asarray(reports)
    if reports.ndim != 2:
        raise InputError(f"reports must be 2-D, got shape {reports.shape}")
    x = _place_reports(reports, dev)
    rep = (None if reputation is None
           else _place_reputation(np.asarray(reputation), reports.shape[0],
                                  dev))
    return x, rep
