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


@pytest.mark.parametrize("case", ["scaled", "algorithm", "auto_small_r",
                                  "mesh", "bfloat16"])
def test_refusals_name_the_roadmap(case):
    reports = make_reports(1, 24, 12).astype(np.float32)
    p = ConsensusParams(**BASE)
    kw = {}
    if case == "scaled":
        kw["event_bounds"] = [{"scaled": True, "min": 0, "max": 2}] + \
            [None] * 11
    elif case == "algorithm":
        p = p._replace(algorithm="ica")
    elif case == "auto_small_r":
        p = p._replace(pca_method="auto")
    elif case == "mesh":
        kw["mesh"] = object()
    else:
        p = p._replace(storage_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sharded_consensus(reports, params=p, device="cpu", **kw)


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
