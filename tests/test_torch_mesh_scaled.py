"""The fused event mesh at the reference's scope, against the JAX package
on the CPU: bfloat16 storage, ``matvec_dtype="bfloat16"`` and a minority
of scaled events (at most E // 8) on ``sharded_consensus(...,
mesh=make_mesh(devices=["cpu"] * n))``.

Each shard rescales its own float32 block, gathers the scaled columns it
owns, casts to the storage dtype and runs the kernels' plain versions;
after resolve it re-resolves its scaled columns by the exact weighted
median (the gather-median tail) and corrects its ``prow`` part before the
fold. The reference is ``pyconsensus_tpu.parallel.fused_sharded
.fused_sharded_consensus`` on ``make_mesh(batch=1, event=n)`` of the
8-device CPU platform with its bounds placed, as
``tests/test_torch_mesh.py`` calls it, the Pallas kernels in interpret
mode. Both get the same float32 numpy reports, whose scaled columns lie
on [0, 4]: a span of a power of two, which rescales exactly in float32
and float64, so both sides cast the same values to bfloat16.

Outcomes of the binary events, ``na_row`` and ``iterations`` must be
equal; the scaled events' outcomes within ``MEDIAN_TIE_ATOL`` (1e-9) in
[0, 1] and of the span; the continuous keys within ``ATOL`` (5e-6), and
``first_loading`` within 1e-3 after aligning its sign
(``tests/test_torch_mesh.py``'s bands).
"""

import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu.ops.numpy_kernels import MEDIAN_TIE_ATOL
from pyconsensus_tpu_torch import ConsensusParams, sharded_consensus
from pyconsensus_tpu_torch.oracle import parse_event_bounds
from pyconsensus_tpu_torch.parallel import ShardedOracle
from pyconsensus_tpu_torch.parallel.mesh import (make_mesh,
                                                 place_event_shards,
                                                 scatter_bounds,
                                                 shard_counts)
from pyconsensus_tpu_torch.parallel.sharded import resolve_params
from test_torch_mesh import ATOL, BASE, reference

EXACT = ("na_row", "iterations", "convergence")
SPAN = 4.0


def scaled_inputs(seed, R, E, n_scaled):
    """Collusion reports with NaN absences; ``n_scaled`` columns (the
    last one always among them) hold values on [0, 4]. Returns
    ``(reports float32, reputation, event_bounds, scaled mask)``."""
    rng = np.random.default_rng(seed)
    reports, _ = collusion_reports(rng, R, E, liars=max(2, R // 5),
                                   na_frac=0.1)
    cols = sorted({E - 1, *rng.choice(E - 1, n_scaled - 1,
                                      replace=False).tolist()})
    bounds = [None] * E
    for c in cols:
        vals = rng.random(R) * SPAN
        reports[:, c] = np.where(np.isnan(reports[:, c]), np.nan, vals)
        bounds[c] = {"scaled": True, "min": 0.0, "max": SPAN}
    rep = rng.random(R) + 0.05
    scaled = np.zeros(E, bool)
    scaled[cols] = True
    return reports.astype(np.float32), rep / rep.sum(), bounds, scaled


def assert_scaled_matches(out, ref, scaled, atol=ATOL,
                          median_atol=MEDIAN_TIE_ATOL):
    assert set(ref) <= set(out)
    for key, a in ref.items():
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(out[key], dtype=np.float64)
        if key in ("outcomes_adjusted", "outcomes_final"):
            np.testing.assert_array_equal(b[~scaled], a[~scaled],
                                          err_msg=key)
            span = SPAN if key == "outcomes_final" else 1.0
            np.testing.assert_allclose(b[scaled] / span, a[scaled] / span,
                                       atol=median_atol, rtol=0,
                                       err_msg=key)
        elif key in EXACT:
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif key == "first_loading":
            sign = np.sign(np.dot(a, b)) or 1.0
            np.testing.assert_allclose(b * sign, a, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=key)


def run_port(reports, rep, bounds, storage, matvec, mi, **where):
    p = ConsensusParams(**BASE, max_iterations=mi, storage_dtype=storage,
                        matvec_dtype=matvec)
    return sharded_consensus(reports, reputation=rep, event_bounds=bounds,
                             params=p, **where)


CASES = [(n, storage, matvec)
         for n in (2, 4, 8)
         for storage in ("bfloat16", "")
         for matvec in ("", "bfloat16")]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_fused_mesh_matches_reference(case):
    """1-5 scaled of 40 events (E // 8 = 5), on bfloat16 or float32
    storage, with and without the bfloat16 sweeps; one or three
    iterations."""
    n, storage, matvec = CASES[case]
    E, mi = 40, 1 + 2 * (case % 2)
    reports, rep, bounds, scaled = scaled_inputs(case, 24, E, 1 + case % 5)
    resolved = resolve_params(
        ConsensusParams(**BASE, storage_dtype=storage, matvec_dtype=matvec,
                        any_scaled=True, n_scaled=int(scaled.sum())),
        24, E, torch.device("cpu"), n_event=n)
    assert resolved.fused_resolution
    out = run_port(reports, rep, bounds, storage, matvec, mi,
                   mesh=make_mesh(devices=["cpu"] * n))
    ref = reference(reports, rep, n, storage, mi, matvec, bounds)
    assert out["outcomes_final"].shape == (E,)
    assert_scaled_matches(out, ref, scaled)


@pytest.mark.parametrize("E", [40, 61])
@pytest.mark.parametrize("storage", ["bfloat16", ""])
def test_fused_mesh_matches_one_device(storage, E):
    """The mesh against the port's own single-device fused path on the
    same inputs: the scaled columns fall on different shards, every
    outcome equal, the rest within float32 rounding of the kernels'
    sums."""
    n_sc = E // 8
    reports, rep, bounds, scaled = scaled_inputs(E, 24, E, n_sc)
    one = run_port(reports, rep, bounds, storage, "", 3, device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    placed = place_event_shards(reports, mesh)
    assert sum(shard_counts(scaled, placed)) == n_sc
    out = run_port(placed, rep, bounds, storage, "", 3)
    assert set(out) == set(one)
    ref = {k: v.numpy() for k, v in one.items()
           if isinstance(v, torch.Tensor)}
    assert_scaled_matches(out, ref, scaled, median_atol=0.0)


def test_scaled_bounds_pad_as_binary_events():
    """Each shard's bounds: its own slice, and the pad columns binary on
    [0, 1], which rescale leaves as they are."""
    E = 61
    reports = np.zeros((3, E), np.float32)
    scaled = np.zeros(E, bool)
    scaled[[0, 20, 60]] = True
    mins = np.where(scaled, -5.0, 0.0)
    maxs = np.where(scaled, 15.0, 1.0)
    placed = place_event_shards(reports, make_mesh(devices=["cpu"] * 4))
    assert shard_counts(scaled, placed) == (1, 1, 0, 1)
    for (sc, lo, hi), o, w, shard in zip(
            scatter_bounds(scaled, mins, maxs, placed), placed.offsets,
            placed.widths, placed.shards):
        assert sc.shape == lo.shape == hi.shape == (shard.shape[1],)
        np.testing.assert_array_equal(sc[:w].numpy(), scaled[o:o + w])
        np.testing.assert_array_equal(lo[:w].numpy(), mins[o:o + w])
        np.testing.assert_array_equal(hi[:w].numpy(), maxs[o:o + w])
        assert not sc[w:].any() and not lo[w:].any()
        assert bool((hi[w:] == 1.0).all())


def test_gate_on_the_mesh():
    """The mesh's fused gate is the reference's: sztorc, the power
    family, ``0 < n_scaled <= E // 8``, bfloat16 and the bfloat16 sweeps
    taken; beyond E // 8 the plain mesh core serves."""
    cpu = torch.device("cpu")
    p = ConsensusParams(**BASE, storage_dtype="bfloat16",
                        matvec_dtype="bfloat16", any_scaled=True)
    assert resolve_params(p._replace(n_scaled=5), 24, 40, cpu,
                          n_event=4).fused_resolution
    plain = resolve_params(p._replace(n_scaled=6), 24, 40, cpu, n_event=4)
    assert not plain.fused_resolution and plain.n_scaled == 0
    assert plain.median_block == 0
    fused = resolve_params(p._replace(pca_method="power-fused",
                                      algorithm="fixed-variance"),
                           24, 40, cpu, n_event=4)
    assert not fused.fused_resolution and fused.pca_method == "power"


@pytest.mark.parametrize("scaled_events", [0, 3])
def test_placed_bfloat16_oracle(scaled_events):
    """``ShardedOracle.place()`` casts bfloat16 storage once on each shard
    when no event is scaled and keeps the float32 shards when some are;
    either way the placed resolution equals the one placed per call."""
    E = 40
    if scaled_events:
        reports, rep, bounds, _ = scaled_inputs(5, 24, E, scaled_events)
    else:
        rng = np.random.default_rng(5)
        reports, _ = collusion_reports(rng, 24, E, liars=4, na_frac=0.1)
        rep, bounds = rng.random(24) + 0.05, None
    kw = dict(reports=reports.astype(np.float64), reputation=rep,
              event_bounds=bounds, storage_dtype="bfloat16",
              pca_method="power", power_tol=-1.0, power_iters=64,
              mesh=make_mesh(devices=["cpu"] * 4))
    oracle = ShardedOracle(**kw).place()
    placed = oracle._placed[0]
    assert placed.dtype == (torch.float32 if scaled_events
                            else torch.bfloat16)
    a = oracle.consensus()
    b = ShardedOracle(**kw).consensus()
    for group in ("agents", "events"):
        for key, v in b[group].items():
            np.testing.assert_array_equal(a[group][key], v, err_msg=key)


def test_parse_event_bounds_matches_reference():
    """The port parses the same (scaled, mins, maxs) the reference does."""
    from pyconsensus_tpu.oracle import parse_event_bounds as ref_parse

    _, _, bounds, _ = scaled_inputs(1, 4, 40, 5)
    for a, b in zip(parse_event_bounds(bounds, 40), ref_parse(bounds, 40)):
        np.testing.assert_array_equal(a, b)
