"""consensus-lint for the PyTorch/CUDA port: static analysis of the
port's own host code, with runtime witnesses.

- **Generic AST rules** (:mod:`.rules`): mutable defaults, bare except,
  unused imports (CL201-203), and the scan machinery every layer shares.
- **Layer 4, host concurrency** (:mod:`.concurrency`, CL801-805): an
  interprocedural lock-order graph with attribute-resolved lock
  identities, blocking calls under a held lock (the card's waits and
  the ``nvcc`` subprocess waits among them), guarded-by inference and
  fault-site catalog drift. Runtime mirror: :mod:`.witness`.
- **Layer 5, distributed protocol** (:mod:`.protocol`, CL901-905):
  durability ordering (journal/commit/ship before ack), RPC surface
  drift, error taxonomy, idempotency and retry scope. Runtime mirror:
  :mod:`.protocol_witness`.
- **Layer 6, bit determinism** (:mod:`.determinism`, CL1001-1005):
  order, completion and host-nondeterminism taint into digests,
  journals and artifacts over :mod:`.dataflow`'s fixpoint, float-fold
  hazards, and the float-atomics source rule over the Python and the
  CUDA sources. Runtime mirror: :mod:`.determinism_witness`.

Findings carry rule IDs, file:line and severity; a checked-in baseline
(``baseline.json``, :mod:`.baseline`) records accepted findings, and is
empty. CLI: ``python -m pyconsensus_tpu_torch.analysis`` or the
``consensus-lint-torch`` console script. Nothing here imports torch
except CL805's read of ``faults.plan.FAULT_SITES``.
"""

from .baseline import load_baseline, match_baseline, save_baseline
from .concurrency import (CONCURRENCY_RULES, analyze_concurrency,
                          lock_order_edges)
from .determinism import (DETERMINISM_RULES, STATIC_DETERMINISM_RULES,
                          analyze_determinism, cuda_float_atomics)
from .findings import Finding, fingerprints
from .protocol import PROTOCOL_RULES, analyze_protocol, happens_before
from .rules import RULES, lint_file, lint_paths
from .witness import (LockWitness, WitnessViolation, load_witness,
                      static_lock_graph, witnessed)

__all__ = [
    "Finding", "fingerprints", "RULES", "lint_file", "lint_paths",
    "CONCURRENCY_RULES", "analyze_concurrency", "lock_order_edges",
    "PROTOCOL_RULES", "analyze_protocol", "happens_before",
    "DETERMINISM_RULES", "STATIC_DETERMINISM_RULES",
    "analyze_determinism", "cuda_float_atomics",
    "LockWitness", "WitnessViolation", "load_witness",
    "static_lock_graph", "witnessed",
    "load_baseline", "save_baseline", "match_baseline",
]
