"""The port's plain core whole (``consensus_torch`` ->
``_consensus_core``) against the reference's jitted ``_consensus_core`` on
the CPU: sztorc, fixed-variance and ica; every PCA method (``power-fused``
runs the reference's Pallas kernels in interpret mode); scaled and binary
events; NA and dense matrices; ``max_iterations`` 1 and 3.

Bands: snapped outcomes, ``na_row``, ``iterations``, ``convergence`` and
``ica_converged`` exact; in float64 the rest within 1e-7 (1e-5 on
``power-fused``, whose kernels compute in float32), scaled outcomes within
1e-7 of the event's range; in float32 1e-5 for sztorc and 2e-3 for
fixed-variance and ica. ``first_loading`` compares up to sign: where its
largest entries tie, the sign is the eigensolver's rounding.
Power-family methods run a fixed sweep count (``power_tol=-1``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.models.pipeline import consensus_jit
from pyconsensus_tpu_torch.models.pipeline import (ConsensusParams,
                                                   consensus_torch)
from test_torch_plain import make_data

EXACT_KEYS = ("na_row", "iterations", "convergence", "ica_converged")

CORE_CASES = [(algo, method, mi)
              for algo in ("sztorc", "fixed-variance", "ica")
              for method in ("eigh-cov", "eigh-gram", "power", "power-fused")
              for mi in (1, 3)]


def core_pair(algo, method, mi, data, dtype=torch.float64, ref_dtype=None):
    """The port's ``consensus_torch`` in ``dtype`` and the reference's
    jitted core in ``ref_dtype`` (default: the same) on the same
    inputs."""
    reports, rep, scaled, mins, maxs = data
    np_dtype = (np.float64 if (ref_dtype or dtype) == torch.float64
                else np.float32)
    kw = dict(algorithm=algo, pca_method=method, max_iterations=mi,
              power_iters=64, power_tol=-1.0 if "power" in method else 0.0,
              any_scaled=bool(scaled.any()),
              has_na=bool(np.isnan(reports).any()),
              n_scaled=int(scaled.sum()))
    ref = consensus_jit(*(jnp.asarray(np.asarray(a, np_dtype))
                          for a in (reports, rep)), jnp.asarray(scaled),
                        *(jnp.asarray(np.asarray(a, np_dtype))
                          for a in (mins, maxs)), RefParams(**kw))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        out = consensus_torch(reports, rep, scaled, mins, maxs,
                              ConsensusParams(**kw), device="cpu")
    finally:
        torch.set_default_dtype(prev)
    return out, {k: np.asarray(v) for k, v in ref.items()}


def assert_core_matches(out, ref, scaled, atol, same_dtype=True):
    """Exact keys equal; snapped outcomes exact on binary events, scaled
    medians exact in the same dtype (they select a report or the midpoint
    of two) and within ``atol`` across dtypes, ``outcomes_final`` within
    ``atol`` of the event's range (20); the rest within ``atol``."""
    assert set(out) == set(ref)
    for key, a in ref.items():
        b = out[key].numpy()
        if key in ("outcomes_adjusted", "outcomes_final"):
            np.testing.assert_array_equal(b[~scaled], a[~scaled],
                                          err_msg=key)
            if key == "outcomes_adjusted" and same_dtype:
                np.testing.assert_array_equal(b, a, err_msg=key)
            span = 20.0 if key == "outcomes_final" else 1.0
            np.testing.assert_allclose(b, a, atol=span * atol, rtol=0,
                                       err_msg=key)
        elif key in EXACT_KEYS:
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif key == "first_loading":
            np.testing.assert_allclose(np.abs(b), np.abs(a), atol=atol,
                                       rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("algo,method,mi", CORE_CASES)
def test_core_matches_reference(algo, method, mi):
    """Scaled and binary events with NA, float64: within 1e-7, power-fused
    within 1e-5 (float32 kernels)."""
    data = make_data(11)
    out, ref = core_pair(algo, method, mi, data)
    assert_core_matches(out, ref, data[2],
                        1e-5 if method == "power-fused" else 1e-7)


@pytest.mark.parametrize("algo", ["sztorc", "fixed-variance", "ica"])
@pytest.mark.parametrize("mi", [1, 3])
def test_core_dense_binary_matches_reference(algo, mi):
    """No scaled events, no NA: the short cuts that skip rescale, the
    fill, the median and the absent accounting ("auto": the covariance
    eigh at E = 40)."""
    data = make_data(12, n_scaled=0, na_frac=0.0)
    out, ref = core_pair(algo, "auto", mi, data)
    assert_core_matches(out, ref, data[2], 1e-7)


@pytest.mark.parametrize("algo,atol", [("sztorc", 1e-5),
                                       ("fixed-variance", 2e-3),
                                       ("ica", 2e-3)])
@pytest.mark.parametrize("method", ["eigh-gram", "power"])
def test_core_float32_matches_reference(algo, atol, method):
    """The default float32 dtype (scaled events, NA) against the
    reference's float32 core; fixed-variance against its float64 core,
    since under x64 the reference's fixed-variance promotes a float32
    scan carry and does not run in float32."""
    data = make_data(13)
    out, ref = core_pair(algo, method, 1, data, torch.float32,
                         ref_dtype=(torch.float64
                                    if algo == "fixed-variance" else None))
    assert out["smooth_rep"].dtype == torch.float32
    assert_core_matches(out, ref, data[2], atol,
                        same_dtype=algo != "fixed-variance")
