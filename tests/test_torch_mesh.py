"""The port's event-sharded mesh path against the JAX package on the CPU.

``sharded_consensus(..., mesh=make_mesh(devices=["cpu"] * n))`` runs the
sztorc pipeline over n shards of one controller, through the kernels'
plain versions: per shard ``storage_matvec``, ``storage_rows_matmat`` and
``resolve_certainty_fused``, the power loop and every (R,)/(E,) step once.
The reference is ``pyconsensus_tpu.parallel.fused_sharded
.fused_sharded_consensus`` on ``make_mesh(batch=1, event=n)`` of the
8-device CPU platform, placed as ``tests/test_fused_sharded.py`` does,
with the Pallas kernels in interpret mode. Both get the same numpy
inputs and a float64 reputation.

Catch-snapped outcomes, ``na_row``, ``iterations`` and ``convergence``
must be equal. The other keys must agree within 5e-6, the reference's
own mesh-vs-single band (``tests/test_fused_sharded.py:70``), and
``first_loading`` within 1e-3 after aligning its sign by the dot product
(columns of equal magnitude may flip the canonical sign). Power iteration
runs a fixed sweep count (``power_tol=-1``): the reference's mesh draws
its start vector and exit floor in float64 under the x64 test
configuration, the port in float32 as on one device.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.oracle import parse_event_bounds as ref_parse_event_bounds
from pyconsensus_tpu.parallel import make_mesh as ref_make_mesh
from pyconsensus_tpu.parallel import sharded_consensus as ref_sharded_consensus
from pyconsensus_tpu.parallel.fused_sharded import fused_sharded_consensus
from pyconsensus_tpu.parallel.sharded import _place_inputs
from pyconsensus_tpu_torch import (ConsensusParams, encode_reports_host,
                                   sharded_consensus)
from pyconsensus_tpu_torch.parallel.mesh import (effective_median_block,
                                                 fold, gather, make_mesh,
                                                 place_event_shards, scatter)
from pyconsensus_tpu_torch.parallel.sharded import resolve_params

EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence")
ATOL = 5e-6
BASE = dict(algorithm="sztorc", pca_method="power", power_iters=64,
            power_tol=-1.0)


def make_inputs(seed, R, E, na_frac=0.1, uniform=False):
    rng = np.random.default_rng(seed)
    reports, _ = collusion_reports(rng, R, E, liars=max(2, R // 5),
                                   na_frac=na_frac)
    rep = (np.full(R, 1.0 / R) if uniform
           else (rng.random(R) + 0.05))
    return reports, rep / rep.sum()


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@contextlib.contextmanager
def fresh_compiles():
    """JAX's persistent compilation cache off for the block: the
    reference's mesh programs, bfloat16 storage above all, crash the CPU
    runtime now and then when their executables are loaded from that
    cache (a segfault in 2 of 8 runs of one such call, none in 8 runs
    that compiled afresh), so each compiles anew. The numbers are the
    same either way."""
    from jax._src import compilation_cache

    prev = jax.config.jax_enable_compilation_cache
    compilation_cache.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
        compilation_cache.reset_cache()


def reference(reports, rep, n, storage, max_iterations, matvec="",
              bounds=None):
    E = reports.shape[1]
    scaled, mins, maxs = ref_parse_event_bounds(bounds, E)
    p = RefParams(**BASE, max_iterations=max_iterations,
                  storage_dtype=storage, matvec_dtype=matvec,
                  any_scaled=bool(scaled.any()), n_scaled=int(scaled.sum()),
                  has_na=True, fused_resolution=True)
    mesh = ref_make_mesh(batch=1, event=n)
    with fresh_compiles():
        placed = _place_inputs(mesh, reports, rep, scaled, mins, maxs)
        out = fused_sharded_consensus(placed[0], placed[1], mesh, p,
                                      *(placed[2:] if scaled.any() else ()))
        return {k: np.asarray(v) for k, v in out.items()}


def port(reports, rep, n, storage, max_iterations, matvec="", **kw):
    p = ConsensusParams(**BASE, max_iterations=max_iterations,
                        storage_dtype=storage, matvec_dtype=matvec)
    return sharded_consensus(reports, reputation=rep, params=p,
                             mesh=cpu_mesh(n), **kw)


def assert_matches(out, ref, atol=ATOL):
    """Key by key; ``first_loading`` sign-aligned within 1e-3."""
    assert set(ref) <= set(out)
    for key, a in ref.items():
        b = np.asarray(out[key])
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif key == "first_loading":
            sign = np.sign(np.dot(a, b)) or 1.0
            np.testing.assert_allclose(b * sign, a, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=atol, err_msg=key)


@pytest.mark.parametrize("max_iterations", [1, 5])
@pytest.mark.parametrize("storage", ["int8", ""])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_matches_reference(n, storage, max_iterations):
    """E = 61 divides no shard count and gives no 16-multiple widths;
    non-uniform reputation."""
    reports, rep = make_inputs(n * 7 + max_iterations, 24, 61)
    ref = reference(reports, rep, n, storage, max_iterations)
    out = port(reports, rep, n, storage, max_iterations)
    assert out["smooth_rep"].dtype == torch.float64
    assert out["outcomes_adjusted"].shape == (61,)
    assert_matches(out, ref)


@pytest.mark.parametrize("case", ["dense", "divisible_uniform"])
def test_mesh_matches_reference_shapes(case):
    """A dense matrix (no absences) and a width that divides the mesh,
    under a uniform reputation; pre-encoded int8 storage."""
    na = 0.0 if case == "dense" else 0.15
    reports, rep = make_inputs(3, 24, 64, na_frac=na, uniform=True)
    ref = reference(reports, rep, 4, "int8", 1)
    out = port(encode_reports_host(reports), rep, 4, "int8", 1)
    assert_matches(out, ref)
    if case == "dense":
        # pcol = sum(rep) - tw in the kernels' float32
        assert float(out["percent_na"]) == pytest.approx(0.0, abs=ATOL)
        assert not bool(out["na_row"].any())


@pytest.mark.parametrize("E", [61, 3])
@pytest.mark.parametrize("max_iterations", [1, 4])
def test_mesh_matches_single_device(E, max_iterations):
    """The mesh against the port's own single-device path: exact keys
    equal, the rest within float32 rounding of the kernels' sums. At
    E = 3 one of four shards holds no real event."""
    reports, rep = make_inputs(E + max_iterations, 23, E)
    p = ConsensusParams(**BASE, max_iterations=max_iterations,
                        storage_dtype="int8")
    single = sharded_consensus(reports, reputation=rep, params=p,
                               device="cpu")
    mesh = sharded_consensus(reports, reputation=rep, params=p,
                             mesh=cpu_mesh(4))
    assert set(mesh) == set(single)
    assert_matches(mesh, {k: np.asarray(v) for k, v in single.items()
                          if k != "quarantined_rows"}, atol=1e-6)


def test_one_shard_routes_to_the_single_device_path():
    """``n_event == 1`` takes the single-device pipeline: the same bits,
    placed or not."""
    reports, rep = make_inputs(5, 24, 40)
    p = ConsensusParams(**BASE, storage_dtype="int8")
    single = sharded_consensus(reports, reputation=rep, params=p,
                               device="cpu")
    mesh1 = cpu_mesh(1)
    placed = place_event_shards(reports, mesh1)
    assert placed.shards[0].shape == (24, 40)           # no pad on one shard
    for out in (sharded_consensus(reports, reputation=rep, params=p,
                                  mesh=mesh1),
                sharded_consensus(placed, reputation=rep, params=p)):
        for key, v in single.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(out[key], v), key


def test_placed_shards_give_the_same_bits():
    """Shards placed once give what placing per call gives."""
    reports, rep = make_inputs(6, 24, 61)
    p = ConsensusParams(**BASE, storage_dtype="int8", max_iterations=3)
    placed = place_event_shards(encode_reports_host(reports), cpu_mesh(4))
    a = sharded_consensus(placed, reputation=rep, params=p)
    b = sharded_consensus(reports, reputation=rep, params=p,
                          mesh=cpu_mesh(4))
    for key, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[key]), key


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_placement_pads_each_shard_to_16_bytes(dtype):
    """16 columns a shard whatever the placed dtype: float reports that
    ``storage_dtype="int8"`` encodes per call keep 16-byte int8 rows."""
    E = 61
    x = np.arange(5 * E).reshape(5, E).astype(dtype)
    placed = place_event_shards(x, cpu_mesh(4))
    assert placed.widths == (16, 15, 15, 15)
    assert placed.offsets == (0, 16, 31, 46)
    assert placed.shape == (5, E)
    for shard, o, w in zip(placed.shards, placed.offsets, placed.widths):
        assert shard.shape[1] % 16 == 0 and shard.is_contiguous()
        np.testing.assert_array_equal(shard[:, :w].numpy(), x[:, o:o + w])
        assert not shard[:, w:].any()                # present zeros
    v = torch.arange(E, dtype=torch.float64)
    pieces = scatter(v, placed)
    assert all(not p[w:].any() for p, w in zip(pieces, placed.widths))
    assert torch.equal(gather(pieces, placed), v)
    parts = [torch.full((3,), 0.1 * (i + 1)) for i in range(4)]
    expect = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(fold(parts, torch.device("cpu")), expect)


def test_effective_median_block():
    assert effective_median_block(1024, None) == 1024
    assert effective_median_block(1024, cpu_mesh(1)) == 1024
    assert effective_median_block(1024, cpu_mesh(2)) == 0


@pytest.mark.parametrize("case", ["batch", "fixed-variance", "ica", "scaled",
                                  "auto_small_r", "k-means", "bfloat16",
                                  "matvec"])
def test_mesh_refusals_name_the_roadmap(case):
    """A batch x event mesh still raises naming ``ROADMAP.md`` §A.10.
    What else this test once refused resolves on the mesh now, in parity
    with the reference's mesh on the same inputs: the plain mesh core
    (fixed-variance, ica, k-means, and the Gram eigh that "auto" picks at
    R <= 4096) against ``sharded_consensus`` on its mesh within 1e-9 in
    float64; a scaled minority (1 of 40 <= E // 8, the shard-local
    gather-median tail), bfloat16 storage and ``matvec_dtype="bfloat16"``
    on the fused mesh against ``fused_sharded_consensus`` (exact keys
    equal, the rest within ``ATOL``)."""
    reports, rep = make_inputs(1, 24, 40)
    if case == "batch":
        with pytest.raises(NotImplementedError, match="ROADMAP.md §A.10"):
            make_mesh(batch=2, devices=["cpu"] * 4)
        return
    if case in ("scaled", "bfloat16", "matvec"):
        bounds = None
        if case == "scaled":
            bounds = [{"scaled": True, "min": 0, "max": 2}] + [None] * 39
            reports[:, 0] *= 2.0
        storage = "bfloat16" if case == "bfloat16" else ""
        matvec = "bfloat16" if case == "matvec" else ""
        ref = reference(reports.astype(np.float32), rep, 4, storage, 1,
                        matvec, bounds)
        out = port(reports.astype(np.float32), rep, 4, storage, 1,
                   event_bounds=bounds, matvec=matvec)
        assert_matches(out, ref)
        return
    algorithm = "sztorc" if case == "auto_small_r" else case
    pca = "auto" if case == "auto_small_r" else "power"
    p = ConsensusParams(**{**BASE, "algorithm": algorithm,
                           "pca_method": pca})
    resolved = resolve_params(p._replace(any_scaled=False), 24, 40,
                              torch.device("cpu"), n_event=4)
    assert not resolved.fused_resolution and resolved.median_block == 0
    out = sharded_consensus(reports.astype(np.float32), reputation=rep,
                            params=p, mesh=cpu_mesh(4))
    ref = ref_sharded_consensus(reports.astype(np.float32), reputation=rep,
                                mesh=ref_make_mesh(batch=1, event=4),
                                params=RefParams(**p._asdict()))
    assert set(out) == set(ref)
    for key, a in ref.items():
        a, b = np.asarray(a), np.asarray(out[key])
        if key in EXACT_KEYS + ("quarantined_rows",):
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            if key == "first_loading":
                a, b = np.abs(a), np.abs(b)
            np.testing.assert_allclose(b, a, atol=1e-9, rtol=0, err_msg=key)


def test_auto_on_a_mesh_beyond_gram_reach_is_fused_power():
    p = resolve_params(ConsensusParams(storage_dtype="int8",
                                       any_scaled=False),
                       10_000, 100_000, torch.device("cpu"), n_event=4)
    assert p.pca_method == "power-fused" and p.fused_resolution


def test_mesh_argument_checks():
    reports, _ = make_inputs(1, 24, 40)
    with pytest.raises(ValueError, match="either device= or mesh="):
        sharded_consensus(reports, params=ConsensusParams(**BASE),
                          device="cpu", mesh=cpu_mesh(2))
    placed = place_event_shards(reports, cpu_mesh(2))
    with pytest.raises(ValueError, match="placed on"):
        sharded_consensus(placed, params=ConsensusParams(**BASE),
                          mesh=cpu_mesh(4))
    with pytest.raises(TypeError):
        sharded_consensus(reports, params=ConsensusParams(**BASE),
                          mesh=object())
    with pytest.raises(ValueError):
        make_mesh(event=3, devices=["cpu"] * 2)


def test_default_mesh_is_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh works")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
