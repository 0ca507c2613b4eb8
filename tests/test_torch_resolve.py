"""The port's weighted median, outcome resolution and certainty
accounting against the JAX package on the CPU, with the inputs and bands
of ``tests/test_torch_plain.py``: the same seeded numpy inputs through
each ``pyconsensus_tpu.ops.jax_kernels`` function and its
``pyconsensus_tpu_torch.ops.torch_kernels`` counterpart, in float64 and
again in float32. Medians, snapped outcomes and masks are exact;
continuous values within 1e-9 in float64 and 1e-5 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyconsensus_tpu.ops import jax_kernels as jk
from pyconsensus_tpu_torch.ops import torch_kernels as tk
from test_torch_plain import DTYPES, both, close, make_data


@pytest.fixture(params=sorted(DTYPES))
def dt(request):
    return DTYPES[request.param]


@pytest.mark.parametrize("block", [0, 4, 7])
def test_weighted_median_cols_matches(dt, block):
    """Blocked or not; uniform weights on an even count make exact
    midpoint ties, random weights the general case."""
    t_dtype, np_dtype, _ = dt
    rng = np.random.default_rng(8)
    R, E = 16, 19
    values = rng.integers(0, 5, (R, E)).astype(np.float64) / 4.0
    present = rng.random((R, E)) > 0.2
    present[:, 3] = False                         # no present mass
    for w in (np.full(R, 1.0 / R), rng.random(R)):
        (jv, tv), (jw, tw) = (both(values, np_dtype, t_dtype),
                              both(w, np_dtype, t_dtype))
        jp, tp = both(present, np_dtype, t_dtype)
        ref = jk.weighted_median_cols(jv, jw, jp, block_cols=block)
        got = tk.weighted_median_cols(tv, tw, tp, block_cols=block)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gather_median_pays_matches():
    for n, E in ((0, 10), (1, 10), (9, 10), (10, 10), (16384, 100_000)):
        assert tk.gather_median_pays(n, E) == jk.gather_median_pays(n, E)


@pytest.mark.parametrize("flags", ["na_scaled", "na_scaled_gather",
                                   "dense_binary", "na_binary",
                                   "dense_scaled"])
def test_resolve_outcomes_and_certainty_match(dt, flags):
    t_dtype, np_dtype, atol = dt
    has_na = flags.startswith("na")
    any_scaled = "scaled" in flags
    n_scaled = 5 if any_scaled else 0
    reports, rep, scaled, mins, maxs = make_data(
        9, n_scaled=n_scaled, na_frac=0.1 if has_na else 0.0)
    rescaled = np.asarray(jk.rescale(jnp.asarray(reports), scaled, mins,
                                     maxs))
    filled, present = jk.interpolate_masked(jnp.asarray(rescaled),
                                            jnp.asarray(rep), scaled, 0.1)
    (jf, tf), (jr, tr) = (both(filled, np_dtype, t_dtype),
                          both(rep, np_dtype, t_dtype))
    jp, tp = both(present, np_dtype, t_dtype)
    js, ts = both(scaled, np_dtype, t_dtype)
    gather = n_scaled if flags.endswith("gather") else 0
    kw = dict(any_scaled=any_scaled, has_na=has_na, median_block=16,
              n_scaled=gather)
    raw_ref, adj_ref = jk.resolve_outcomes(jp if has_na else None, jf, jr,
                                           js, 0.1, **kw)
    raw, adj = tk.resolve_outcomes(tp if has_na else None, tf, tr, ts, 0.1,
                                   **kw)
    np.testing.assert_array_equal(adj.numpy()[~scaled],
                                  np.asarray(adj_ref)[~scaled])
    close(raw, raw_ref, atol)
    close(adj, adj_ref, atol)
    ref = jk.certainty_and_bonuses(jp if has_na else None, jf, jr, adj_ref,
                                   js, 0.1, has_na=has_na)
    got = tk.certainty_and_bonuses(tp if has_na else None, tf, tr,
                                   torch.from_numpy(np.array(adj_ref)), ts,
                                   0.1, has_na=has_na, any_scaled=any_scaled)
    assert set(got) == set(ref)
    for key, v in ref.items():
        close(got[key], v, atol, key)


def test_resolve_outcomes_refuses_a_wrong_scaled_count():
    """A gather of the wrong count would resolve the wrong columns."""
    reports, rep, scaled, _, _ = make_data(10)
    filled = torch.from_numpy(np.nan_to_num(reports, nan=0.5))
    with pytest.raises(ValueError, match="n_scaled"):
        tk.resolve_outcomes(None, filled, torch.from_numpy(rep),
                            torch.from_numpy(scaled), 0.1, has_na=False,
                            n_scaled=4)
