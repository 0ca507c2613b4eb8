"""The port's fused sztorc slice against the JAX package on the CPU.

``pyconsensus_tpu_torch.sharded_consensus(..., device="cpu")`` runs the
whole main path through the kernels' plain versions; the reference is
``pyconsensus_tpu.models.pipeline._consensus_core_fused`` with the Pallas
kernels in interpret mode. Both get the same numpy inputs. Key by key, as
in ``tests/test_int8_storage.py``: catch-snapped outcomes, ``na_row``,
``iterations`` and ``convergence`` bit-exact, ``|first_loading|`` and
the rest within atol 1e-5. Power iteration runs a fixed sweep count
(``power_tol=-1``) so both sides stop at the same sweep. The reputation
dtype is stated per case: float64 (the x64 conftest's default) or
float32.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.models.pipeline import _consensus_core_fused
from pyconsensus_tpu_torch import (ConsensusParams, decode_reports,
                                   encode_reports, encode_reports_host,
                                   lattice_exact, sharded_consensus)
from pyconsensus_tpu_torch.convert import (inputs_from_reference,
                                           params_from_reference)
from pyconsensus_tpu_torch.faults.errors import InputError
from pyconsensus_tpu_torch.parallel.sharded import resolve_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence")
BASE = dict(algorithm="sztorc", pca_method="power", power_iters=64,
            power_tol=-1.0)


def make_reports(seed, R, E, na_frac=0.1):
    rng = np.random.default_rng(seed)
    truth = rng.choice([0.0, 1.0], size=E)
    reports = np.tile(truth, (R, 1))
    liars = max(2, R // 5)
    flips = rng.random((R - liars, E)) < 0.1
    reports[:R - liars] = np.abs(reports[:R - liars] - flips)
    reports[R - liars:] = 1.0 - truth
    reports[rng.random((R, E)) < na_frac] = np.nan
    return reports


def reference(reports, rep, storage, max_iterations):
    E = reports.shape[1]
    p = RefParams(**BASE, max_iterations=max_iterations,
                  storage_dtype=storage, any_scaled=False, has_na=True,
                  fused_resolution=True)
    out = _consensus_core_fused(jnp.asarray(reports), jnp.asarray(rep),
                                jnp.zeros(E, dtype=bool), jnp.zeros(E),
                                jnp.ones(E), p)
    return {k: np.asarray(v) for k, v in out.items()}


def port(reports, rep, storage, max_iterations):
    p = ConsensusParams(**BASE, max_iterations=max_iterations,
                        storage_dtype=storage)
    out = sharded_consensus(reports, reputation=rep, params=p, device="cpu")
    return out


def assert_matches(out, ref):
    assert set(ref) <= set(out)
    for key, a in ref.items():
        b = np.asarray(out[key].cpu() if isinstance(out[key], torch.Tensor)
                       else out[key])
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif key == "first_loading":
            np.testing.assert_allclose(np.abs(b), np.abs(a), atol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("rep_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("storage", ["int8", ""])
@pytest.mark.parametrize("max_iterations", [1, 4])
@pytest.mark.parametrize("R,E", [(24, 12), (23, 12)])
def test_slice_matches_reference(R, E, max_iterations, storage, rep_dtype):
    reports = make_reports(R * 31 + E + max_iterations, R, E)
    rep = np.random.default_rng(R).random(R).astype(rep_dtype)
    ref = reference(reports.astype(rep_dtype), rep, storage, max_iterations)
    out = port(reports.astype(np.float32), rep, storage, max_iterations)
    assert out["smooth_rep"].dtype == torch.from_numpy(rep).dtype
    assert_matches(out, ref)


@pytest.mark.parametrize("max_iterations", [1, 4])
def test_slice_matches_reference_wide(max_iterations):
    """R = 64, E = 300, int8, float32 reputation."""
    reports = make_reports(5 + max_iterations, 64, 300, na_frac=0.02)
    rep = np.full(64, 1.0 / 64, np.float32)
    ref = reference(reports.astype(np.float32), rep, "int8", max_iterations)
    out = port(encode_reports_host(reports), rep, "int8", max_iterations)
    assert_matches(out, ref)


@pytest.mark.parametrize("max_iterations", [1, 3])
def test_pre_encoded_bit_identical(max_iterations):
    """Pre-encoded int8 input gives the same bits as encoding per
    resolution (the reference's ``_fill_stats`` contract)."""
    reports = make_reports(9, 24, 40)
    a = port(reports.astype(np.float32), None, "int8", max_iterations)
    b = port(encode_reports_host(reports), None, "int8", max_iterations)
    for key, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[key]), key


def test_result_dict_shape_and_quarantine():
    reports = make_reports(3, 24, 12).astype(np.float32)
    reports[5, 3] = np.inf
    out = port(reports, None, "", 1)
    np.testing.assert_array_equal(out["quarantined_rows"], [5])
    assert bool(out["na_row"][5])
    for key in ("outcomes_raw", "certainty", "participation_columns"):
        assert out[key].shape == (12,)
    assert out["smooth_rep"].shape == (24,)


def test_encode_decode_and_lattice():
    reports = make_reports(4, 24, 12)
    reports[0, 0] = 0.5
    host = encode_reports_host(reports)
    dev = encode_reports(torch.from_numpy(reports.astype(np.float32)))
    np.testing.assert_array_equal(dev.numpy(), host)
    back = decode_reports(host)
    np.testing.assert_array_equal(np.isnan(back), np.isnan(reports))
    assert lattice_exact(reports)
    assert not lattice_exact(np.array([[0.3]]))
    assert not lattice_exact(np.array([[-0.0]]))


def test_params_round_trip_from_reference():
    ref = RefParams(max_iterations=3, power_tol=1e-5, storage_dtype="int8",
                    pca_method="power-fused")
    p = params_from_reference(ref._asdict())
    assert p._asdict() == ref._asdict()
    assert params_from_reference(RefParams()._asdict()) == ConsensusParams()
    with pytest.raises(InputError):
        params_from_reference({**ref._asdict(), "bogus": 1})


def test_inputs_from_reference_places_storage():
    reports = make_reports(2, 24, 12)
    x, rep = inputs_from_reference(encode_reports_host(reports),
                                   np.full(24, 1 / 24), device="cpu")
    assert x.dtype == torch.int8 and rep.dtype == torch.float64
    x, rep = inputs_from_reference(reports, None, device="cpu")
    assert x.dtype == torch.float32 and rep is None


def assert_plain_parity(algorithm, pca_method, max_components=5, R=24,
                        E=40):
    """The front door's plain core (``device="cpu"``, float32 storage, a
    float64 reputation) against the reference's light XLA core on the same
    inputs (the reference's fixed-variance takes no float32 reputation
    under x64): exact keys equal, the rest within 1e-7."""
    from pyconsensus_tpu.models.pipeline import consensus_light_jit

    reports = make_reports(R * 7 + E, R, E).astype(np.float32)
    rep = np.random.default_rng(R).random(R) + 0.5
    p = ConsensusParams(algorithm=algorithm, pca_method=pca_method,
                        max_components=max_components)
    out = sharded_consensus(reports, reputation=rep, params=p, device="cpu")
    ref_p = RefParams(algorithm=algorithm, pca_method=pca_method,
                      max_components=max_components, any_scaled=False,
                      has_na=True)
    ref = consensus_light_jit(jnp.asarray(reports), jnp.asarray(rep),
                              jnp.zeros(E, dtype=bool),
                              jnp.zeros(E, np.float32),
                              jnp.ones(E, np.float32), ref_p)
    for key, a in ref.items():
        a = np.asarray(a)
        b = out[key].cpu().numpy()
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(b, a, err_msg=key)
        else:
            if key == "first_loading":
                a, b = np.abs(a), np.abs(b)
            np.testing.assert_allclose(b, a, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("case", ["scaled", "algorithm", "auto_small_r",
                                  "mesh", "bfloat16"])
def test_refusals_name_the_roadmap(case):
    """What the port does not cover raises naming its roadmap item;
    ``"auto"`` at R <= 4096 resolves to the Gram eigh on the plain core
    and serves, as k-means does (both against the reference's light XLA
    core). A scaled minority on the fused path (the gather-median tail)
    and bfloat16 storage serve too: those cases hold the port to the
    reference's fused path (exact keys equal, the rest within 1e-5, the
    scaled event's outcome within 1e-5 of the span)."""
    reports = make_reports(1, 24, 12).astype(np.float32)
    p = ConsensusParams(**BASE)
    kw = {}
    match = "ROADMAP"
    if case in ("scaled", "bfloat16"):
        E = 12
        scaled = np.zeros(E, bool)
        mins, maxs = np.zeros(E, np.float32), np.ones(E, np.float32)
        storage = ""
        if case == "scaled":        # 1 of 12 <= E // 8: the fused path
            kw["event_bounds"] = [{"scaled": True, "min": 0, "max": 2}] + \
                [None] * 11
            scaled[0], maxs[0] = True, 2.0
            reports[:, 0] *= 2.0
        else:
            storage = "bfloat16"
        p = p._replace(storage_dtype=storage)
        out = sharded_consensus(reports, params=p, device="cpu", **kw)
        ref_p = RefParams(**BASE, storage_dtype=storage,
                          any_scaled=bool(scaled.any()),
                          n_scaled=int(scaled.sum()), has_na=True,
                          fused_resolution=True)
        ref = _consensus_core_fused(jnp.asarray(reports),
                                    jnp.asarray(np.full(24, 1 / 24,
                                                        np.float32)),
                                    jnp.asarray(scaled), jnp.asarray(mins),
                                    jnp.asarray(maxs), ref_p)
        ref = {k: np.asarray(v) for k, v in ref.items()}
        for key in ("outcomes_adjusted", "outcomes_final"):
            np.testing.assert_allclose(out[key][scaled].numpy() / 2.0,
                                       ref[key][scaled] / 2.0, atol=1e-5)
            out[key] = out[key][~scaled]
            ref[key] = ref[key][~scaled]
        assert_matches(out, ref)
        return
    if case == "algorithm":
        # k-means serves on the plain core since §A.6 landed
        assert_plain_parity("k-means", "auto")
        return
    elif case == "auto_small_r":
        resolved = resolve_params(p._replace(pca_method="auto",
                                             any_scaled=False),
                                  24, 40, torch.device("cpu"))
        assert resolved.pca_method == "eigh-gram"
        assert not resolved.fused_resolution
        assert_plain_parity("sztorc", "auto")
        return
    else:                           # fixed-variance on an event mesh
        from pyconsensus_tpu_torch.parallel.mesh import make_mesh

        p = p._replace(algorithm="fixed-variance")
        kw["mesh"] = make_mesh(devices=["cpu"] * 2)
        match = "ROADMAP.md §A.10"
    if "mesh" not in kw:
        kw["device"] = "cpu"
    with pytest.raises(NotImplementedError, match=match):
        sharded_consensus(reports, params=p, **kw)


def test_a_card_that_is_not_sm90_is_refused(monkeypatch):
    """The port runs nothing on a card without its kernels: the front
    door, the plain core's PCA pick and ``require_hopper`` refuse an
    sm_80 card rather than run the plain versions there."""
    from pyconsensus_tpu_torch.ops import torch_kernels as tk
    from pyconsensus_tpu_torch.ops.cuda_kernels import require_hopper

    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    card = torch.device("cuda", 0)
    p = ConsensusParams(pca_method="eigh-gram", any_scaled=False)
    for call in (lambda: require_hopper(card),
                 lambda: resolve_params(p, 24, 40, card),
                 lambda: tk.resolve_pca_method(24, 40, "eigh-gram", card)):
        with pytest.raises(NotImplementedError, match="not sm_90"):
            call()
    require_hopper(torch.device("cpu"))


@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
def test_auto_opens_the_multi_component_fused_path_at_north_star(algorithm):
    """At R = 10,000 and E = 100,000, "auto" resolves to orthogonal
    iteration and the fused path opens, on int8 and on float32 storage."""
    for storage in ("int8", ""):
        p = resolve_params(ConsensusParams(algorithm=algorithm,
                                           storage_dtype=storage,
                                           any_scaled=False),
                           10_000, 100_000, torch.device("cpu"))
        assert p.pca_method == "power" and p.fused_resolution


@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
@pytest.mark.parametrize("R,E,method", [(4096, 100_000, "eigh-gram"),
                                        (10_000, 1024, "eigh-cov")])
def test_auto_eigh_refusals_name_the_roadmap(algorithm, R, E, method):
    """"auto" picks an exact eigh at R <= 4096 (Gram) or E <= 1024
    (covariance), as does an explicit request at any shape: the fused
    gate closes and the plain core serves, in parity with the
    reference."""
    cpu = torch.device("cpu")
    p = ConsensusParams(algorithm=algorithm, any_scaled=False)
    for q in (resolve_params(p, R, E, cpu),
              resolve_params(p._replace(pca_method=method), 10_000, 100_000,
                             cpu)):
        assert q.pca_method == method and not q.fused_resolution
    assert_plain_parity(algorithm, method)


@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
def test_components_beyond_the_block_kernels_raise(algorithm):
    """Beyond k <= 8 the one-pass block kernel's gate refuses, so its
    wrapper would raise on the card and the orthogonal iteration takes
    the separable arm instead. On an event mesh, which has no plain core
    yet, the call raises naming the roadmap; an exact eigh method takes
    the plain core at any component count."""
    from pyconsensus_tpu_torch.ops.cuda_kernels import cov_block_kernel_fits

    for k in (9, 12, 41):
        assert not cov_block_kernel_fits(100_000, k, 1)
    p = ConsensusParams(algorithm=algorithm, pca_method="power",
                        max_components=12, storage_dtype="int8",
                        any_scaled=False)
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A.10"):
        resolve_params(p, 10_000, 100_000, cpu, n_event=4)
    q = resolve_params(p._replace(pca_method="eigh-gram", storage_dtype=""),
                       10_000, 100_000, cpu)
    assert q.pca_method == "eigh-gram" and not q.fused_resolution
    assert_plain_parity(algorithm, "eigh-gram", max_components=12)


@pytest.mark.parametrize("algorithm", ["fixed-variance", "ica"])
def test_components_beyond_the_block_kernel_open_the_fused_path(algorithm):
    """Nothing raises beyond the one-pass block kernel's k <= 8 any more:
    the separable arm and the grouped (k + 1)-row direction fix take any
    component count at any width (the reference's ``_MULTI_FUSED_MAX_E``
    ceiling is not carried), on both storages."""
    p = ConsensusParams(algorithm=algorithm, pca_method="power",
                        any_scaled=False)
    cpu = torch.device("cpu")
    for storage in ("int8", ""):
        for k in (7, 8, 12, 40):
            assert resolve_params(p._replace(max_components=k,
                                             storage_dtype=storage),
                                  10_000, 100_000, cpu).fused_resolution


def test_fill_stats_kernel_gate_matches_the_plain_statistics(monkeypatch):
    """With the fill-statistics gate on, ``_fill_stats`` takes
    ``fill_stats_pass``: the same fill, and statistics within float32
    rounding of the plain reduction."""
    from pyconsensus_tpu_torch.models import pipeline

    x = encode_reports(torch.from_numpy(make_reports(6, 24, 40)
                                        .astype(np.float32)))
    rep = torch.rand(24, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    plain = pipeline._fill_stats(x, rep, 0.1, "int8")
    monkeypatch.setattr(pipeline, "_FILL_STATS_KERNEL", True)
    gated = pipeline._fill_stats(x, rep, 0.1, "int8")
    assert torch.equal(gated[1], plain[1])
    for a, b in zip(gated[2:], plain[2:]):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_int8_needs_int8_storage():
    reports = encode_reports_host(make_reports(1, 24, 12))
    with pytest.raises(ValueError):
        sharded_consensus(reports, params=ConsensusParams(**BASE),
                          device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_consensus(make_reports(1, 24, 12).astype(np.float32),
                          params=ConsensusParams(**BASE))
    with pytest.raises(RuntimeError, match="CUDA"):
        inputs_from_reference(make_reports(1, 24, 12))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib.util, sys\n"
        "import pyconsensus_tpu_torch\n"
        "import pyconsensus_tpu_torch.convert\n"
        "import pyconsensus_tpu_torch.ops.build\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pyconsensus_tpu' or m.startswith('pyconsensus_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
