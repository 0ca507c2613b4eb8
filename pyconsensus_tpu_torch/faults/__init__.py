"""pyconsensus_tpu_torch.faults — deterministic fault injection,
structured errors, graceful degradation, and retry
(``pyconsensus_tpu/faults`` on torch).

Quick use::

    from pyconsensus_tpu_torch import Oracle, faults

    plan = faults.FaultPlan(seed=7, rules=[
        {"site": "oracle.raw_result", "kind": "nan_storm",
         "occurrences": [0], "args": {"fraction": 1.0}}])
    with faults.armed(plan):
        result = Oracle(reports, device="cpu").consensus()
    print(plan.fired)             # [(site, occurrence, kind), ...]

Rules of engagement:

- **host-side only.** ``fire``/``corrupt`` sites live in host code on
  host values (the front doors' report matrices, the fetched result),
  never between kernel launches.
- **zero overhead disarmed.** Both hooks test one module global against
  ``None`` and return; no counters, no PRNG, no allocation.
- **deterministic.** Activation and payloads are pure functions of
  (plan seed, site name, occurrence index), the same as in the JAX
  package: one plan poisons the same cells in both.
"""

from __future__ import annotations

from .degrade import (POWER_METHODS, fallback_steps, quarantine_nonfinite,
                      raise_exhausted, record_fallback, result_nonfinite)
from .errors import (ERROR_CODES, AotCacheCorruptionError,
                     CheckpointCorruptionError, ConsensusError,
                     ConvergenceError, FailoverInProgressError,
                     HandshakeError, InputError, NumericsError,
                     PlacementError, ServiceOverloadError,
                     SnapshotCorruptionError, TransportError,
                     WorkerLostError)
from .plan import (FAULT_SITES, FaultPlan, FaultRule, SimulatedCrash,
                   active_plan, arm, armed, corrupt, disarm, fire)
from .retry import retry, retry_call

__all__ = [
    "FAULT_SITES", "FaultPlan", "FaultRule", "SimulatedCrash",
    "arm", "disarm", "armed", "active_plan", "fire", "corrupt",
    "ConsensusError", "InputError", "NumericsError", "ConvergenceError",
    "CheckpointCorruptionError", "AotCacheCorruptionError",
    "SnapshotCorruptionError", "ServiceOverloadError",
    "WorkerLostError", "FailoverInProgressError", "PlacementError",
    "TransportError", "HandshakeError",
    "ERROR_CODES",
    "retry", "retry_call",
    "quarantine_nonfinite", "result_nonfinite", "record_fallback",
    "fallback_steps", "raise_exhausted", "POWER_METHODS",
]
