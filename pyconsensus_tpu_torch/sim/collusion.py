"""Monte-Carlo collusion simulator (``pyconsensus_tpu/sim/collusion.py``;
BASELINE.json config 5).

The whole (liar_fraction × variance × trial) sweep is one batched torch
computation on the device: report generation is a pure function of
``(key, liar_fraction, variance)`` (the JAX package's draws, bit for bit:
``ops/prng.py``), every trial's resolution is a lane of
:func:`~pyconsensus_tpu_torch.sim._batched.iterate`, and only scalar
metrics per trial leave the device. A lane gives the same bits whatever
batch it rides in, so a chunked or resumed sweep reproduces a monolithic
one bit for bit, and so does a sweep over a mesh (``mesh=``), whose
devices each take a contiguous group of the trials.

Threat model (the reference's):

- **truth**: each event has a random binary ground truth.
- **honest reporters** report the truth with per-entry flip probability
  ``variance`` (the noise knob).
- **liars** (each reporter independently with probability ``liar_fraction``):
  - ``collude=True``: all liars report the *shared anti-truth* — the
    coordinated attack PCA is supposed to catch;
  - ``collude=False``: each liar reports uniform random noise.

Metrics per trial: fraction of events resolved correctly / captured by the
lie / left ambiguous (0.5), the liars' share of post-resolution reputation,
and convergence of the iterative loop. The draws are in the working dtype
(``torch.get_default_dtype()``), as the reference draws in its default
float dtype: float64 uniforms under float64, float32 under float32.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..models.pipeline import JIT_ALGORITHMS, ConsensusParams
from ..ops import prng
from ..parallel.mesh import mesh_devices, refuse_process_mesh
from ..parallel.sharded import resolve_device
from . import _batched

__all__ = ["CollusionSimulator", "RoundsSimulator", "simulate_grid",
           "generate_reports", "flat_grid"]

#: elements of (lanes, R, E) one batched computation holds at a time; the
#: lanes beyond run in the next group (the same bits: lanes are
#: independent)
_LANE_GROUP_ELEMS = 1 << 27


def _working_dtype() -> torch.dtype:
    return torch.get_default_dtype()


def _synth_reports(k_truth, k_noise, k_lie, liar, variance,
                   n_reporters: int, n_events: int, collude: bool):
    """Shared threat-model body: given a liar mask, build one round's
    ``(reports, truth)`` — fresh truth, honest noise-flips at probability
    ``variance``, liars reporting the shared anti-truth (collude) or
    uniform noise. Keys ``(..., 2)``; the leading dimensions are lanes."""
    dtype = _working_dtype()
    variance = torch.as_tensor(variance, dtype=dtype, device=k_truth.device)
    truth = prng.bernoulli_torch(k_truth, 0.5, (n_events,), dtype).to(dtype)
    flip = prng.bernoulli_torch(k_noise, torch.clamp(variance, 0.0, 0.5),
                                (n_reporters, n_events), dtype)
    honest = torch.abs(truth[..., None, :] - flip.to(dtype))
    if collude:
        lie = (1.0 - truth)[..., None, :].expand_as(honest)
    else:
        lie = prng.bernoulli_torch(k_lie, 0.5, (n_reporters, n_events),
                                   dtype).to(dtype)
    return torch.where(liar[..., :, None], lie, honest), truth


def _as_key(key, device) -> torch.Tensor:
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64)
    return torch.as_tensor(np.asarray(key).astype(np.int64),
                           device=resolve_device(device))


def generate_reports(key, liar_fraction, variance, n_reporters: int,
                     n_events: int, collude: bool = True, device=None):
    """Pure synthetic-report generator: ``(reports, truth, liar_mask)`` as a
    function of the PRNG key and the two sweep knobs, the reference's bits.
    ``key`` is ``ops.prng.key(seed)`` (or ``fold_in`` of it): a ``(..., 2)``
    tensor computes on its device, an array on ``device`` (None: the card).
    Leading key dimensions are lanes, each with its own ``liar_fraction``
    and ``variance`` (or one shared). Public so tests and users can replay
    any trial's exact matrix through :class:`Oracle`."""
    key = _as_key(key, device)
    dtype = _working_dtype()
    ks = prng.split_torch(key, 4)
    k_truth, k_liar, k_noise, k_lie = (ks[..., i, :] for i in range(4))
    lf = torch.as_tensor(liar_fraction, dtype=dtype, device=key.device)
    liar = prng.bernoulli_torch(k_liar, lf, (n_reporters,), dtype)
    reports, truth = _synth_reports(k_truth, k_noise, k_lie, liar, variance,
                                    n_reporters, n_events, collude)
    return reports, truth, liar


def _rate(hit: torch.Tensor, dtype) -> torch.Tensor:
    """``mean(hit)`` over the last axis: the count times ``1 / n``, as XLA
    compiles the reference's ``jnp.mean`` (a division by a constant
    becomes a product with its reciprocal; ``3 / 10`` and ``3 * (1 /
    10)`` differ in the last bit)."""
    return _batched.fsum(hit.to(dtype), -1) * (1.0 / hit.shape[-1])


def _trial_metrics(keys, liar_fraction, variance, *, n_reporters: int,
                   n_events: int, collude: bool, p: ConsensusParams):
    """One oracle resolution per lane on synthetic reports; returns
    per-lane scalars only."""
    dtype = _working_dtype()
    reports, truth, liar = generate_reports(keys, liar_fraction, variance,
                                            n_reporters, n_events, collude)
    # dense binary reports: rescale and the fill are identities, so the
    # trial goes straight into the redistribution loop
    rep0 = torch.full((keys.shape[0], n_reporters), 1.0 / n_reporters,
                      dtype=dtype, device=keys.device)
    rep, converged, iters = _batched.iterate(reports, rep0, p)
    outcomes = _batched.resolve_binary(reports, rep, p.catch_tolerance)
    liar_f = liar.to(dtype)
    return {
        "correct_rate": _rate(outcomes == truth, dtype),
        "capture_rate": _rate(outcomes == 1.0 - truth, dtype),
        "ambiguous_rate": _rate(outcomes == 0.5, dtype),
        "liar_rep_share": _batched.fsum(rep * liar_f, -1),
        "liar_fraction_realized": _rate(liar, dtype),
        "converged": converged,
        "iterations": iters,
    }


def flat_grid(liar_fractions, variances, n_trials: int):
    """The flattened (liar_fraction × variance × trial) sweep grid in the
    canonical layout (trial-major: flat index ``i = (l*V + v)*T + t``) —
    the single definition shared by :meth:`CollusionSimulator.run` and the
    checkpointed sweep runner, so a chunked/resumed sweep reproduces a
    monolithic one bit-for-bit."""
    lf = np.asarray(liar_fractions, dtype=np.float64)
    var = np.asarray(variances, dtype=np.float64)
    L, V, T = len(lf), len(var), int(n_trials)
    if L < 1 or V < 1 or T < 1:
        raise ValueError("liar_fractions, variances, and n_trials must "
                         "all be non-empty/positive")
    grid_lf = np.repeat(lf, V * T)
    grid_var = np.tile(np.repeat(var, T), L)
    return lf, var, grid_lf, grid_var


def _fold_keys(seed: int, indices, device=None) -> torch.Tensor:
    """Per-trial PRNG keys: ``fold_in(key(seed), flat_index)`` — a pure
    function of the GLOBAL flat index, so any slice of the grid can be
    computed independently (the checkpointed runner's correctness
    contract). ``(N, 2)`` int64 words on ``device`` (None: the card)."""
    dev = resolve_device(device)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=dev)
    return prng.fold_in_torch(prng.key_torch(seed, dev), idx)


class CollusionSimulator:
    """Batched Monte-Carlo collusion sweeps on the device.

    Parameters
    ----------
    n_reporters, n_events : trial matrix shape.
    collude : shared-lie attack vs independent random liars.
    algorithm, max_iterations, alpha, catch_tolerance, pca_method,
    power_iters, num_clusters, dbscan_eps, dbscan_min_samples : consensus
        knobs, as on :class:`~pyconsensus_tpu_torch.Oracle`.
        ``pca_method="power"`` is the default here, as in the reference;
        ``"eigh-cov"``, ``"eigh-gram"`` and ``"auto"`` (by shape) solve
        each lane's eigenproblem by one float64 LAPACK call on the host.
        ``algorithm`` is one of ``JIT_ALGORITHMS`` (sztorc,
        fixed-variance, ica, k-means, dbscan-jit); the hybrid ones raise
        ``ValueError``.
    mesh : a mesh (``parallel.mesh.make_mesh``: an event mesh or a batch
        x event grid) whose every device takes a contiguous group of the
        flat trials, as the reference shards its trial axis over every
        mesh device (pure data parallelism); the groups run in order on
        the caller's thread and join in order. ``make_mesh(batch=n,
        event=1)`` is the reference's layout. A mesh that spans processes
        raises (``ROADMAP.md`` §A.10).
    device : where the sweep runs without a mesh (None: the card;
        ``"cpu"`` on request); with a mesh, None or the mesh's device
        type.

    Determinism: a lane gives the same bits alone or inside any batch
    (``_batched``'s module docstring), so the same seed replays bit for
    bit at any chunk width and over any mesh, uneven splits included
    (stronger than the reference's cross-topology ulp band).
    """

    def __init__(self, n_reporters: int = 20, n_events: int = 10,
                 collude: bool = True, algorithm: str = "sztorc",
                 max_iterations: int = 1, alpha: float = 0.1,
                 catch_tolerance: float = 0.1, pca_method: str = "power",
                 power_iters: int = 64, num_clusters: int = 2,
                 dbscan_eps: float = 0.5, dbscan_min_samples: int = 2,
                 mesh=None, device=None):
        if algorithm not in JIT_ALGORITHMS:
            raise ValueError(
                f"simulator requires a jit-compatible algorithm "
                f"{JIT_ALGORITHMS}, got {algorithm!r}")
        self.n_reporters = int(n_reporters)
        self.n_events = int(n_events)
        self.collude = bool(collude)
        self.params = ConsensusParams(
            algorithm=algorithm, alpha=float(alpha),
            catch_tolerance=float(catch_tolerance),
            max_iterations=int(max_iterations), pca_method=pca_method,
            power_iters=int(power_iters), num_clusters=int(num_clusters),
            dbscan_eps=float(dbscan_eps),
            dbscan_min_samples=int(dbscan_min_samples),
            any_scaled=False, has_na=False)
        _batched.pca_method_for(self.n_reporters, self.n_events, pca_method)
        self.mesh = mesh
        if mesh is None:
            self.devices = (resolve_device(device),)
        else:
            refuse_process_mesh(mesh, "the simulator's trial axis")
            self.devices = mesh_devices(mesh)
            if (device is not None
                    and torch.device(device).type != self.devices[0].type):
                raise ValueError(f"device={device!r} is not the mesh's "
                                 f"device type ({self.devices[0].type})")
        self.device = self.devices[0]
        self._batched = self._trial_fn()

    def _trial_fn(self):
        """Subclass hook: the batched trial function ``(keys (N, 2), lf
        (N,), var (N,)) -> metrics of (N, ...) tensors``."""
        return functools.partial(_trial_metrics, n_reporters=self.n_reporters,
                                 n_events=self.n_events, collude=self.collude,
                                 p=self.params)

    def _dispatch(self, seed: int, indices, grid_lf, grid_var) -> dict:
        """Run the batched computation over the trials at GLOBAL flat
        ``indices`` and return host metric arrays — the one dispatch
        point shared by :meth:`run` and the checkpointed chunk runner, so
        ``mesh=`` applies to both. With a mesh, each device takes a
        contiguous group of the trials, the groups run in order on the
        caller's thread and join in order. Lanes at the same flat index
        carry the same key, and a lane does not depend on the batch, so
        any chunking and any mesh give the same bits."""
        indices = np.asarray(indices)
        grid_lf, grid_var = np.asarray(grid_lf), np.asarray(grid_var)
        N = indices.shape[0]
        groups = np.array_split(np.arange(N), len(self.devices))
        with obs.span("sim.dispatch", trials=int(N),
                      algorithm=self.params.algorithm,
                      meshed=self.mesh is not None):
            parts = [self._run_group(seed, indices[g], grid_lf[g],
                                     grid_var[g], dev)
                     for dev, g in zip(self.devices, groups) if len(g)]
            host = {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        obs.counter(
            "pyconsensus_sim_trials_total",
            "Monte-Carlo trials resolved by the batched simulator",
            labels=("algorithm",)).inc(N, algorithm=self.params.algorithm)
        return host

    def _run_group(self, seed: int, indices, grid_lf, grid_var,
                   device) -> dict:
        """The trials at ``indices`` on ``device``, in lane groups of at
        most ``_LANE_GROUP_ELEMS`` elements; host metric arrays (the
        host copy is the group's completion barrier)."""
        dtype = _working_dtype()
        per_lane = self.n_reporters * self.n_events
        group = max(1, _LANE_GROUP_ELEMS // per_lane)
        parts = []
        for s in range(0, indices.shape[0], group):
            keys = _fold_keys(seed, indices[s:s + group], device)
            lf = torch.as_tensor(grid_lf[s:s + group], dtype=dtype,
                                 device=device)
            var = torch.as_tensor(grid_var[s:s + group], dtype=dtype,
                                  device=device)
            parts.append(self._batched(keys, lf, var))
        return {k: torch.cat([p[k] for p in parts]).cpu().numpy()
                for k in parts[0]}

    def run(self, liar_fractions: Sequence[float],
            variances: Sequence[float], n_trials: int, seed: int = 0) -> dict:
        """Sweep the (liar_fraction × variance × seed) grid in one batched
        call. Returns a dict of host arrays shaped (L, V, T) per metric —
        (L, V, T, ...) for metrics with trailing per-trial axes, e.g. the
        per-round trajectories of :class:`RoundsSimulator` — plus ``"mean"``:
        per-cell averages over the trial axis."""
        lf, var, grid_lf, grid_var = flat_grid(liar_fractions, variances,
                                               n_trials)
        L, V, T = len(lf), len(var), int(n_trials)
        host = self._dispatch(seed, np.arange(L * V * T), grid_lf, grid_var)
        result = {k: v.reshape((L, V, T) + v.shape[1:])
                  for k, v in host.items()}
        result["mean"] = {k: v.mean(axis=2) for k, v in result.items()}
        result["liar_fractions"] = lf
        result["variances"] = var
        self._annotate(result)
        return result

    def _annotate(self, result: dict) -> None:
        """Subclass hook: add extra metadata keys to a finished sweep."""


def simulate_grid(liar_fractions=(0.0, 0.1, 0.2, 0.3, 0.4),
                  variances=(0.0, 0.1, 0.2), n_trials: int = 100,
                  seed: int = 0, **kwargs) -> dict:
    """Convenience one-call sweep (the reference's script entry point)."""
    return CollusionSimulator(**kwargs).run(liar_fractions, variances,
                                            n_trials, seed)


def _trial_rounds(keys, liar_fraction, variance, *, n_rounds: int,
                  n_reporters: int, n_events: int, collude: bool,
                  p: ConsensusParams):
    """One multi-round trial per lane: reputation carries from round to
    round (the ledger's semantics, on the device: the reference's
    ``lax.scan`` over rounds is a loop here) with a fixed liar set and
    fresh truth and noise each round. Returns per-round metric
    trajectories (N, n_rounds)."""
    dtype = _working_dtype()
    ks = prng.split_torch(keys, 2)
    k_liar, k_rounds = ks[:, 0], ks[:, 1]
    lf = torch.as_tensor(liar_fraction, dtype=dtype, device=keys.device)
    liar = prng.bernoulli_torch(k_liar, lf, (n_reporters,), dtype)
    liar_f = liar.to(dtype)
    rep = torch.full((keys.shape[0], n_reporters), 1.0 / n_reporters,
                     dtype=dtype, device=keys.device)
    round_keys = prng.split_torch(k_rounds, n_rounds)
    traj = {"correct_rate": [], "capture_rate": [], "liar_rep_share": []}
    for r in range(n_rounds):
        kr = prng.split_torch(round_keys[:, r], 3)
        reports, truth = _synth_reports(kr[:, 0], kr[:, 1], kr[:, 2], liar,
                                        variance, n_reporters, n_events,
                                        collude)
        rep, _, _ = _batched.iterate(reports, rep, p)
        outcomes = _batched.resolve_binary(reports, rep, p.catch_tolerance)
        traj["correct_rate"].append(_rate(outcomes == truth, dtype))
        traj["capture_rate"].append(_rate(outcomes == 1.0 - truth, dtype))
        traj["liar_rep_share"].append(_batched.fsum(rep * liar_f, -1))
    return {k: torch.stack(v, dim=1) for k, v in traj.items()}


class RoundsSimulator(CollusionSimulator):
    """Multi-round variant of :class:`CollusionSimulator`: each trial runs
    ``n_rounds`` oracle resolutions with the reputation vector carried
    between rounds (fixed liar set, fresh events each round), and the
    whole (liar_fraction x variance x trial) grid is still one batched
    computation a round. The repeated-game experiment: does sustained
    collusion get ground down?"""

    def __init__(self, n_rounds: int = 10, **kwargs):
        if int(n_rounds) < 1:
            raise ValueError("n_rounds must be >= 1")
        self.n_rounds = int(n_rounds)   # before super().__init__ → _trial_fn
        super().__init__(**kwargs)

    def _trial_fn(self):
        return functools.partial(_trial_rounds, n_rounds=self.n_rounds,
                                 n_reporters=self.n_reporters,
                                 n_events=self.n_events,
                                 collude=self.collude, p=self.params)

    def _annotate(self, result: dict) -> None:
        result["n_rounds"] = self.n_rounds
