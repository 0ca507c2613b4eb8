"""The port's power-iteration seed against ``jax.random`` on the CPU.

The threefry bits must equal ``jax.random.bits`` exactly; the float32
normals must agree with ``jax.random.normal`` within 4 ulp (XLA's
``log1p`` and fused multiply-adds may round differently from numpy's).
"""

import jax
import numpy as np
import pytest

from pyconsensus_tpu.ops.jax_kernels import _power_seed
from pyconsensus_tpu_torch.ops import prng

WIDTHS = [1, 4, 127, 1000, 100000]


def _ulp_gap(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


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
