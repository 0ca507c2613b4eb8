"""The power-iteration seed vector, drawn in numpy.

The JAX package starts power iteration from
``jax.random.normal(jax.random.key(0), (E,), float32)``. Torch's
generators give other numbers, and the iteration counts depend on the
start vector, so this module reproduces that draw: threefry2x32 with the
bit layout of ``jax_threefry_partitionable=True`` (the default from JAX
0.5 on), jax's mantissa-fill uniform on ``[nextafter(-1, 0), 1)``, and
XLA's single-precision ``erf_inv`` polynomial, all in numpy.

The bits are exact. The normals agree with JAX to a few ulp: XLA's
``log1p`` and its fused multiply-adds may round differently from
numpy's.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["threefry2x32", "random_bits", "normal_f32", "power_seed"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x0, x1)`` under ``key = (k0, k1)``; uint32 arrays in and out."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(seed: int, n: int) -> np.ndarray:
    """``jax.random.bits(jax.random.key(seed), (n,))`` under the
    partitionable layout: the counter of element ``j`` is the 64-bit
    index ``j`` split into (high, low) words, and the 32-bit draw is the
    XOR of the two hash words. ``key(seed)`` is ``(seed >> 32,
    seed & 0xFFFFFFFF)`` for a non-negative seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


# XLA's ErfInv32 coefficients (w < 5 and w >= 5 branches)
_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's ErfInv32. ``log1p`` runs in float64 and each Horner step as
    one float64 multiply-add rounded to float32 (a fused multiply-add, as
    XLA compiles it): measured against ``jax.lax.erf_inv`` on the CPU this
    is the closest of the forms tried (at most 2 ulp, 1% of draws)."""
    f32, f64 = np.float32, np.float64
    x = x.astype(f32)
    with np.errstate(divide="ignore"):
        w = (-np.log1p((x * -x).astype(f64))).astype(f32)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_W_LT5[0]), f32(_W_GE5[0])).astype(f32)
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        c = np.where(lt, f32(a), f32(b)).astype(f64)
        p = (c + p.astype(f64) * w.astype(f64)).astype(f32)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == f32(1.0), x * f32(np.inf),
                        p * x).astype(f32)


def normal_f32(seed: int, n: int) -> np.ndarray:
    """``jax.random.normal(jax.random.key(seed), (n,), float32)``."""
    f32 = np.float32
    bits = random_bits(seed, n)
    fb = (bits >> np.uint32(32 - 23)) | np.array(1.0, f32).view(np.uint32)
    floats = fb.view(f32) - f32(1.0)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    hi = f32(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo).astype(f32)
    return (f32(np.sqrt(2)) * _erfinv_f32(u)).astype(f32)


@functools.lru_cache(maxsize=8)
def _seed_cached(n: int) -> np.ndarray:
    out = normal_f32(0, n)
    out.setflags(write=False)
    return out


def power_seed(n: int) -> np.ndarray:
    """The power-iteration start vector of width ``n`` (float32,
    read-only, cached per width)."""
    return _seed_cached(int(n))
