"""Named market sessions: incremental report ingestion with staged
sufficient statistics (``pyconsensus_tpu/serve/session.py``).

A voting period is not one matrix arriving at once: ballots for a FIXED
reporter roster trickle in per event block, and the resolution is
demanded on a schedule. A :class:`MarketSession` is one such period:
``append`` stages an event block AND folds it into the sufficient
statistics at once (``parallel.streaming._pass1_panel``'s G/M/S,
weighted by the round's starting reputation), so ``resolve`` pays only
the scoring (an R x R eigh off the Gram accumulator) and one outcome pass
over the staged blocks — never a re-ingestion of the panel. The
arithmetic is that of the reference's ``streaming_consensus`` over the
same block split (``gram_top_components``, ``gram_dirfix``,
``_pass2_panel``, ``assemble_light_result``).

Reputation carries across rounds through an optional
:class:`~pyconsensus_tpu_torch.ledger.ReputationLedger`
(``record_round``). ``resolve`` closes the round: the staged state
clears and the next round's appends accumulate against the carried
reputation.

Scope: the statistics path serves ``algorithm="sztorc"`` with
``max_iterations=1``; other configurations assemble the staged blocks and
resolve through the port's ``Oracle``.

The statistics and the staged blocks live on the session's ``device``
(None: the card). A block on the {0, 0.5, 1, NaN} lattice is staged as
int8 sentinel storage on the device (its decode is exact), any other
block as host float64. Sessions launch none of the port's kernels.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..faults import CheckpointCorruptionError, InputError
from ..faults import plan as _faults
from ..ledger import ReputationLedger
from ..models.pipeline import encode_reports, lattice_exact
from ..ops import numpy_kernels as nk
from ..ops import torch_kernels as tk
from ..oracle import parse_event_bounds
from ..parallel.sharded import resolve_device
from ..parallel.streaming import (_pass1_panel, _pass2_panel,
                                  assemble_light_result, gram_dirfix,
                                  gram_top_components)
from .incremental import (INCREMENTAL_REFRESH_DEFAULT,
                          incremental_executable, incremental_params,
                          kernel_path_counter)

__all__ = ["MarketSession", "SessionStore", "share_of"]


def share_of(reputation, seats) -> float:
    """Fraction of a reputation vector's mass held by ``seats`` (0.0 when
    the vector carries no positive mass)."""
    rep = np.asarray(reputation, dtype=np.float64)
    total = float(rep.sum())
    if total <= 0.0:
        return 0.0
    return float(rep[list(seats)].sum() / total)


class MarketSession:
    """One market round of incremental ballots for a fixed reporter set.

    Parameters
    ----------
    name : str
        Session identity (the ``session=`` handle in serve requests).
    n_reporters : int
        Fixed roster size; every appended block has this many rows.
    reputation : (R,) array or None
        Starting reputation (uniform if None); replaced by the carried
        ``smooth_rep`` after each ``resolve``.
    ledger : ReputationLedger or None
        Optional backing ledger: each resolve is recorded as a round.
    alpha, catch_tolerance, convergence_tolerance :
        The Oracle knobs the statistics path honors.
    incremental : bool
        The ``bucket_incremental`` tier: the dominant eigenpair is
        maintained across rounds by warm-started power iteration, with an
        exact resolve every ``refresh_every`` rounds.
    refresh_every : int
        The exact-refresh cadence K (>= 1; 1 = every resolve exact).
    executable_provider : callable or None
        ``(n_reporters, params) -> executable`` resolving the warm
        kernel (a ``ConsensusService`` injects its executable cache).
    encoded_staging : bool
        Stage lattice-exact blocks as int8 sentinel storage on the
        device (default True); False keeps every block as host float64.
    device : the device of the statistics and the staged blocks (None:
        the card; ``"cpu"`` on request).
    dtype : the accumulation dtype (None: the default dtype).
    """

    def __init__(self, name: str, n_reporters: int, reputation=None,
                 ledger: Optional[ReputationLedger] = None,
                 alpha: float = 0.1, catch_tolerance: float = 0.1,
                 convergence_tolerance: float = 1e-6,
                 incremental: bool = False,
                 refresh_every: int = INCREMENTAL_REFRESH_DEFAULT,
                 executable_provider=None,
                 encoded_staging: bool = True, device=None,
                 dtype: Optional[torch.dtype] = None) -> None:
        self.name = str(name)
        self.n_reporters = int(n_reporters)
        if self.n_reporters < 1:
            raise InputError("a session needs at least one reporter")
        if ledger is not None and ledger.n_reporters != self.n_reporters:
            raise InputError(
                f"ledger carries {ledger.n_reporters} reporters, session "
                f"declares {self.n_reporters}")
        self.device = resolve_device(device)
        self.dtype = dtype or torch.get_default_dtype()
        if reputation is None and ledger is not None:
            # ledger-carried state enters verbatim: resolve() carries
            # smooth_rep forward un-renormalized, so a resumed session
            # starts from the bits the uninterrupted one holds
            self.reputation = np.asarray(ledger.reputation,
                                         dtype=np.float64)
        else:
            if reputation is None:
                reputation = np.full(self.n_reporters,
                                     1.0 / self.n_reporters)
            rep = np.asarray(reputation, dtype=np.float64)
            if rep.shape != (self.n_reporters,):
                raise InputError(f"reputation shape {rep.shape} does "
                                 f"not match {self.n_reporters} "
                                 f"reporters")
            self.reputation = nk.normalize(rep)
        self.ledger = ledger
        self.alpha = float(alpha)
        self.catch_tolerance = float(catch_tolerance)
        self.convergence_tolerance = float(convergence_tolerance)
        self.incremental = bool(incremental)
        self.encoded_staging = bool(encoded_staging)
        self.refresh_every = int(refresh_every)
        if self.refresh_every < 1:
            raise InputError(
                f"incremental refresh cadence must be >= 1 (the exact "
                f"resolve every K rounds is the staleness-bound "
                f"contract), got {self.refresh_every}",
                refresh_every=self.refresh_every)
        self._executable_provider = executable_provider
        #: the carried warm eigenstate: the previous round's principal
        #: component (None until the first exact resolve) and how many
        #: warm resolves have run since the last exact anchor
        self._warm_u = None
        self._rounds_since_exact = 0
        #: how the latest resolve was served ("incremental",
        #: "incremental_exact", "stats" or "direct")
        self.last_resolve_path = None
        self.rounds_resolved = 0
        if reputation is None and ledger is not None:
            self._restore_warm_state(ledger)
        self._lock = threading.RLock()
        self._reset_round()

    def _reset_round(self) -> None:
        R = self.n_reporters
        kw = {"dtype": self.dtype, "device": self.device}
        self._blocks: list = []        # staged (R, e) blocks
        self._bounds: list = []        # per-block event_bounds lists
        self._G = torch.zeros((R, R), **kw)
        self._M = torch.zeros((R, R), **kw)
        self._S = torch.zeros((R, R), **kw)
        #: the reputation the round's statistics are pinned to
        self._round_rep = torch.as_tensor(self.reputation, **kw)

    def _restore_warm_state(self, ledger: ReputationLedger) -> None:
        """Adopt the warm eigenstate a round commit stored in the ledger's
        aux state (absent: the next stats resolve is an exact anchor)."""
        u = ledger.aux.get("incremental_warm_u")
        if u is None:
            return
        u = np.asarray(u, dtype=np.float64)
        if u.shape != (self.n_reporters,) or not np.isfinite(u).all():
            raise CheckpointCorruptionError(
                f"session {self.name!r}: ledger aux field "
                f"'incremental_warm_u' has shape {u.shape} (expected "
                f"({self.n_reporters},)) or non-finite entries",
                field="incremental_warm_u", session=self.name)
        self._warm_u = u
        age = ledger.aux.get("incremental_rounds_since_exact")
        if age is not None:
            self._rounds_since_exact = int(np.asarray(age).reshape(-1)[0])

    def _sync_ledger_aux(self) -> None:
        """Carry the warm eigenstate into the ledger's aux state, so the
        round commit stores it with the reputation."""
        if self._warm_u is not None:
            self.ledger.aux["incremental_warm_u"] = np.asarray(
                self._warm_u, dtype=np.float64)
            self.ledger.aux["incremental_rounds_since_exact"] = \
                np.asarray([self._rounds_since_exact], dtype=np.int64)
        else:
            self.ledger.aux.pop("incremental_warm_u", None)
            self.ledger.aux.pop("incremental_rounds_since_exact", None)

    # -- ingestion ------------------------------------------------------

    @property
    def n_events(self) -> int:
        return sum(b.shape[1] for b in self._blocks)

    def _admit(self, block):
        """The append path's fault-injection site
        (``serve.session_append``), fired once per acknowledged block."""
        return _faults.corrupt("serve.session_append", block)

    def append(self, reports_block, event_bounds=None) -> int:
        """Stage one event block (R x e, NaN = non-report) and fold it
        into the round's statistics. Returns the staged event count."""
        block = np.asarray(reports_block, dtype=np.float64)
        if block.ndim == 1:
            block = block[:, None]
        if block.ndim != 2 or block.shape[0] != self.n_reporters:
            raise InputError(
                f"appended block must be ({self.n_reporters}, e), got "
                f"{block.shape}", shape=tuple(block.shape))
        e = block.shape[1]
        scaled, mins, maxs = parse_event_bounds(event_bounds, e)
        block = self._admit(block)
        with self._lock, obs.span("serve.session_append",
                                  session=self.name, events=e):
            dev, dtype = self.device, self.dtype
            staged, panel = self._stage_block(block)
            dG, dM, dS = _pass1_panel(
                panel, self._round_rep, self._round_rep,
                torch.as_tensor(scaled, device=dev),
                torch.as_tensor(mins, dtype=dtype, device=dev),
                torch.as_tensor(maxs, dtype=dtype, device=dev),
                torch.ones(e, dtype=torch.bool, device=dev),
                self.catch_tolerance, True)
            self._G = self._G + dG
            self._M = self._M + dM
            self._S = self._S + dS
            self._blocks.append(staged)
            self._bounds.append(
                list(event_bounds) if event_bounds is not None
                else [None] * e)
            total = self.n_events
        obs.counter(
            "pyconsensus_serve_session_appends_total",
            "event blocks appended to market sessions").inc()
        return total

    def _stage_block(self, block: np.ndarray):
        """``(staged, panel)``: the form kept in ``_blocks`` and the
        device panel the statistics fold reads. A lattice-exact block is
        encoded to int8 sentinel storage on the device and staged there;
        any other block stays host float64."""
        if self.encoded_staging and lattice_exact(block):
            enc = encode_reports(torch.as_tensor(block, device=self.device))
            return enc, self._panel(enc)
        return block, self._panel(block)

    def _panel(self, block) -> torch.Tensor:
        """A staged block as the float panel on the device: the int8
        sentinel decode (exact at any float dtype), or a placement."""
        if isinstance(block, torch.Tensor) and block.dtype == torch.int8:
            return torch.where(block < 0,
                               torch.tensor(float("nan"), dtype=self.dtype,
                                            device=block.device),
                               block.to(self.dtype) * 0.5)
        return torch.as_tensor(block).to(device=self.device,
                                         dtype=self.dtype)

    @staticmethod
    def _staged_host(block) -> np.ndarray:
        """A staged block back on the host as float64 (exact for encoded
        blocks)."""
        if isinstance(block, torch.Tensor):
            enc = block.cpu().numpy()
            return np.where(enc < 0, np.nan, enc.astype(np.float64) * 0.5)
        return np.asarray(block, dtype=np.float64)

    def state(self) -> dict:
        """A consistent operator snapshot (one lock hold): rounds
        resolved, the current round's staged counts, a copy of the
        carried reputation and the incremental state."""
        with self._lock:
            return {"session": self.name,
                    "rounds_resolved": int(self.rounds_resolved),
                    "staged_blocks": len(self._blocks),
                    "staged_events": self.n_events,
                    "reputation": np.array(self.reputation, copy=True),
                    "incremental": {
                        "enabled": self.incremental,
                        "refresh_every": self.refresh_every,
                        "rounds_since_exact": self._rounds_since_exact,
                        "has_warm_start": self._warm_u is not None,
                        "warm_u": (None if self._warm_u is None
                                   else np.array(self._warm_u,
                                                 copy=True)),
                        "next_resolve_warm": self._would_warm(),
                        "last_resolve_path": self.last_resolve_path}}

    def _would_warm(self) -> bool:
        """Whether the next stats-path resolve rides the warm kernel (the
        cadence rule)."""
        return (self.incremental and self._warm_u is not None
                and self._rounds_since_exact + 1 < self.refresh_every)

    def reputation_share(self, seats) -> float:
        """Fraction of the carried reputation held by ``seats``."""
        with self._lock:
            rep = np.array(self.reputation, copy=True)
        return share_of(rep, seats)

    # -- resolution -----------------------------------------------------

    def _assembled(self):
        reports = np.concatenate(
            [self._staged_host(b) for b in self._blocks], axis=1)
        bounds = [b for chunk in self._bounds for b in chunk]
        if all(b is None for b in bounds):
            bounds = None
        return reports, bounds

    def resolve(self, algorithm: str = "sztorc", max_iterations: int = 1,
                **oracle_kwargs) -> dict:
        """Resolve the staged round and carry the reputation forward.
        Returns the flat light result dict (host values). The round's
        staged state clears."""
        with self._lock:
            if not self._blocks:
                raise InputError(
                    f"session {self.name!r} has no staged reports")
            with obs.span("serve.session_resolve", session=self.name,
                          events=self.n_events, algorithm=algorithm):
                if (algorithm == "sztorc" and max_iterations == 1
                        and not oracle_kwargs):
                    result = self._resolve_stats(
                        use_warm=self._would_warm())
                else:
                    result = self._resolve_direct(algorithm,
                                                  max_iterations,
                                                  oracle_kwargs)
                    # a direct resolve leaves no eigenstate to warm from
                    self._warm_u = None
                    self._rounds_since_exact = 0
                    self.last_resolve_path = "direct"
            self.reputation = np.asarray(result["smooth_rep"],
                                         dtype=np.float64)
            self.rounds_resolved += 1
            if self.ledger is not None:
                self._sync_ledger_aux()
                self.ledger.record_round(result)
            self._reset_round()
        return result

    def peek_resolve(self) -> dict:
        """EXACT resolve of the staged round with no state change: the
        reference a warm resolve's drift is measured against."""
        with self._lock:
            if not self._blocks:
                raise InputError(
                    f"session {self.name!r} has no staged reports")
            return self._resolve_stats(use_warm=False, peek=True)

    def _resolve_stats(self, use_warm: bool = False,
                       peek: bool = False) -> dict:
        """The statistics path: score off the accumulated G/M/S, then one
        outcome pass over the staged blocks. ``use_warm`` rides the
        ``bucket_incremental`` kernel; ``peek`` mutates nothing."""
        rep0 = self._round_rep
        dtype, dev = self.dtype, self.device
        tol = self.catch_tolerance
        R = self.n_reporters

        new_warm = None
        if use_warm and not peek:
            p = incremental_params(self.alpha, self.catch_tolerance,
                                   self.convergence_tolerance)
            provider = self._executable_provider
            fn = (provider(R, p) if provider is not None
                  else incremental_executable(p))
            out = fn(self._G, self._M, self._S, rep0,
                     torch.as_tensor(self._warm_u, dtype=dtype, device=dev),
                     p)
            this_rep = out["this_rep"]
            smooth_rep = out["smooth_rep"]
            u_over_nAu = out["u_over_nAu"]
            delta = float(out["delta"])
            converged = delta <= self.convergence_tolerance
            new_warm = out["u"].cpu().numpy().astype(np.float64)
            kernel_path_counter().inc(path="incremental")
            obs.counter(
                "pyconsensus_incremental_resolves_total",
                "incremental-tier session resolves by mode (warm = the "
                "marginal warm-started kernel, exact = the anchoring "
                "eigh refresh)", labels=("mode",)).inc(mode="warm")
            obs.histogram(
                "pyconsensus_incremental_power_iters",
                "warm-started power sweeps per marginal resolve (the "
                "O(update) eigensolve cost)",
                buckets=obs.ITERATION_BUCKETS).observe(int(out["sweeps"]))
        else:
            scores_k, _, U, nAu = gram_top_components(self._G, self._M,
                                                      rep0, 1)
            u_over_nAu = U[:, 0] / torch.where(
                nAu[0] == 0.0, torch.ones_like(nAu[0]), nAu[0])
            adj = gram_dirfix(scores_k[:, 0], rep0, self._S)
            this_rep = tk.row_reward_weighted(adj, rep0)
            smooth_rep = tk.smooth(this_rep, rep0, self.alpha)
            delta = float(torch.max(torch.abs(smooth_rep - rep0)))
            converged = delta <= self.convergence_tolerance
            if self.incremental and not peek:
                new_warm = U[:, 0].cpu().numpy().astype(np.float64)
                if self._warm_u is not None:
                    # the staleness the anchor corrected
                    wn = float(np.linalg.norm(self._warm_u))
                    if wn > 0.0:
                        obs.histogram(
                            "pyconsensus_incremental_drift",
                            "warm-eigenstate staleness corrected at each "
                            "exact refresh: 1 - |<u_warm, u_exact>|",
                            buckets=obs.MAGNITUDE_BUCKETS).observe(
                                1.0 - abs(float(
                                    new_warm @ (self._warm_u / wn))))
                obs.counter(
                    "pyconsensus_incremental_resolves_total",
                    "incremental-tier session resolves by mode (warm = "
                    "the marginal warm-started kernel, exact = the "
                    "anchoring eigh refresh)", labels=("mode",)).inc(
                        mode="exact")

        E = self.n_events
        outcomes_raw = np.zeros(E)
        outcomes_adjusted = np.zeros(E)
        outcomes_final = np.zeros(E)
        certainty = np.zeros(E)
        pcols = np.zeros(E)
        first_loading = np.zeros(E)
        prow = np.zeros(R)
        na_count = np.zeros(R)
        start = 0
        for block, bounds in zip(self._blocks, self._bounds):
            e = block.shape[1]
            scaled, mins, maxs = parse_event_bounds(
                None if all(b is None for b in bounds) else bounds, e)
            parts = _pass2_panel(
                self._panel(block), rep0, rep0, smooth_rep, u_over_nAu,
                torch.as_tensor(scaled, device=dev),
                torch.as_tensor(mins, dtype=dtype, device=dev),
                torch.as_tensor(maxs, dtype=dtype, device=dev), tol)
            raw, adjd, fin, cert, pc, pr, nc, ld = (
                t.cpu().numpy() for t in parts)
            stop = start + e
            outcomes_raw[start:stop] = raw
            outcomes_adjusted[start:stop] = adjd
            outcomes_final[start:stop] = fin
            certainty[start:stop] = cert
            pcols[start:stop] = 1.0 - pc
            first_loading[start:stop] = ld
            prow += pr
            na_count += nc
            start = stop
        first_loading = nk.canon_sign(first_loading)
        if not peek:
            if use_warm:
                self._warm_u = new_warm
                self._rounds_since_exact += 1
                self.last_resolve_path = "incremental"
            elif self.incremental:
                self._warm_u = new_warm
                self._rounds_since_exact = 0
                self.last_resolve_path = "incremental_exact"
            else:
                self.last_resolve_path = "stats"
        return assemble_light_result(
            rep0.cpu().numpy().astype(float), this_rep, smooth_rep,
            na_count, outcomes_raw, outcomes_adjusted, outcomes_final,
            1, converged, certainty, pcols, prow,
            {"first_loading": first_loading})

    def _resolve_direct(self, algorithm, max_iterations, kwargs) -> dict:
        """The non-statistics path: assemble the staged panel and run the
        port's ``Oracle`` on the session's device (``backend=`` in the
        kwargs is honored), the flat light-shaped pieces on the host."""
        from ..oracle import Oracle

        kwargs = dict(kwargs)
        backend = kwargs.pop("backend", "torch")
        reports, bounds = self._assembled()
        oracle = Oracle(reports=reports, event_bounds=bounds,
                        reputation=np.asarray(self.reputation),
                        algorithm=algorithm, max_iterations=max_iterations,
                        alpha=self.alpha,
                        catch_tolerance=self.catch_tolerance,
                        convergence_tolerance=self.convergence_tolerance,
                        backend=backend,
                        device=self.device if backend == "torch" else None,
                        **kwargs)
        return {k: np.asarray(v) for k, v in oracle._fetch_raw().items()
                if k not in ("original", "rescaled", "filled")}


class SessionStore:
    """Thread-safe registry of named sessions (the service's
    ``session=`` namespace)."""

    def __init__(self) -> None:
        self._sessions: dict = {}
        self._lock = threading.Lock()

    def create(self, name: str, n_reporters: int, **kwargs
               ) -> MarketSession:
        with self._lock:
            if name in self._sessions:
                raise InputError(f"session {name!r} already exists")
            session = MarketSession(name, n_reporters, **kwargs)
            self._sessions[name] = session
            # delta-counted: the gauge is the live total across stores
            obs.gauge("pyconsensus_serve_sessions",
                      "live market sessions").inc(1)
            return session

    def get(self, name: str) -> MarketSession:
        with self._lock:
            try:
                return self._sessions[name]
            except KeyError:
                raise InputError(f"unknown session {name!r}") from None

    def remove(self, name: str) -> None:
        with self._lock:
            if self._sessions.pop(name, None) is not None:
                obs.gauge("pyconsensus_serve_sessions",
                          "live market sessions").inc(-1)

    def names(self) -> list:
        with self._lock:
            return sorted(self._sessions)
