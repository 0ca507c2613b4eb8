"""The port's power-iteration seed and orthogonal-iteration start block
against ``jax.random`` on the CPU.

The threefry bits (32- and 64-bit draws) must equal ``jax.random.bits``
exactly; the float32 and float64 normals must agree with
``jax.random.normal`` within 4 ulp (XLA's ``log1p`` and fused
multiply-adds may round differently from numpy's).
"""

import jax
import numpy as np
import pytest

from pyconsensus_tpu.ops.jax_kernels import _power_seed
from pyconsensus_tpu_torch.ops import prng

WIDTHS = [1, 4, 127, 1000, 100000]


def _ulp_gap(a, b):
    view = np.int64 if a.dtype == np.float64 else np.int32
    return np.abs(a.view(view).astype(np.int64)
                  - b.view(view).astype(np.int64))


@pytest.mark.parametrize("E", WIDTHS)
def test_threefry_bits_exact(E):
    # the conftest enables x64, so the draw's width is given explicitly
    ref = np.asarray(jax.random.bits(jax.random.key(0), (E,), np.uint32))
    np.testing.assert_array_equal(prng.random_bits(0, E), ref)


@pytest.mark.parametrize("seed", [1, 7, 2 ** 33 + 5])
def test_threefry_bits_other_keys(seed):
    ref = np.asarray(jax.random.bits(jax.random.key(seed), (1000,),
                                     np.uint32))
    np.testing.assert_array_equal(prng.random_bits(seed, 1000), ref)


@pytest.mark.parametrize("E", WIDTHS)
def test_power_seed_within_4_ulp(E):
    ref = np.asarray(_power_seed(E, np.float32))
    got = prng.power_seed(E)
    assert got.dtype == np.float32 and got.shape == (E,)
    assert _ulp_gap(got, ref).max() <= 4


def test_power_seed_cached_and_read_only():
    a = prng.power_seed(127)
    assert a is prng.power_seed(127)
    with pytest.raises(ValueError):
        a[0] = 1.0


def test_erfinv_edges():
    x = np.array([-1.0, 1.0, 0.0], dtype=np.float32)
    out = prng._erfinv_f32(x)
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0


@pytest.mark.parametrize("n", [1, 80, 5000])
def test_threefry_bits64_exact(n):
    ref = np.asarray(jax.random.bits(jax.random.key(0), (n,), np.uint64))
    np.testing.assert_array_equal(prng.random_bits64(0, n), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("E,k", [(16, 5), (40, 4), (300, 3), (100000, 5)])
def test_orth_seed_within_4_ulp(E, k, dtype):
    """The (E, k) start block ``jax.random.normal(key(0), (E, k), acc)``
    of the orthogonal iteration, for both reputation dtypes."""
    ref = np.asarray(jax.random.normal(jax.random.key(0), (E, k), dtype))
    got = prng.orth_seed(E, k, dtype)
    assert got.dtype == dtype and got.shape == (E, k)
    assert _ulp_gap(got, ref).max() <= 4


def test_erfinv_f64_tails_within_4_ulp():
    """All three branches of XLA's ErfInv64 (w < 6.25, < 16, >= 16)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 20000),
                        1.0 - 10.0 ** -rng.uniform(3, 15, 2000),
                        -(1.0 - 10.0 ** -rng.uniform(7, 16, 2000))])
    ref = np.asarray(jax.lax.erf_inv(x))
    got = prng._erfinv_f64(x)
    assert got.dtype == np.float64
    assert _ulp_gap(got, ref).max() <= 4
    edges = prng._erfinv_f64(np.array([-1.0, 1.0, 0.0]))
    assert edges[0] == -np.inf and edges[1] == np.inf and edges[2] == 0.0
