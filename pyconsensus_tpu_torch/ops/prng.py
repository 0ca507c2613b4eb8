"""The power-iteration seed vector, drawn in numpy.

The JAX package starts power iteration from
``jax.random.normal(jax.random.key(0), (E,), float32)`` and orthogonal
iteration from ``jax.random.normal(jax.random.key(0), (E, k), acc)``, with
``acc`` float32 or float64. Torch's generators give other numbers, and the
iteration counts depend on the start, so this module reproduces those
draws: threefry2x32 with the bit layout of
``jax_threefry_partitionable=True`` (the default from JAX 0.5 on), jax's
mantissa-fill uniform on ``[nextafter(-1, 0), 1)``, and XLA's ``erf_inv``
polynomials (single and double precision), all in numpy. Under that
layout the counter of an element is its flat index, so an ``(E, k)`` draw
is the flat ``(E * k,)`` draw reshaped.

The bits are exact. The normals agree with JAX to a few ulp: XLA's
``log1p`` and its fused multiply-adds may round differently from
numpy's.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["threefry2x32", "random_bits", "random_bits64", "normal_f32",
           "normal_f64", "power_seed", "orth_seed"]

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


def _hash_words(seed: int, n: int):
    """The two threefry words of elements ``0 .. n-1`` under
    ``key(seed)``."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return threefry2x32(key, hi, lo)


def random_bits(seed: int, n: int) -> np.ndarray:
    """``jax.random.bits(jax.random.key(seed), (n,))`` under the
    partitionable layout: the counter of element ``j`` is the 64-bit
    index ``j`` split into (high, low) words, and the 32-bit draw is the
    XOR of the two hash words. ``key(seed)`` is ``(seed >> 32,
    seed & 0xFFFFFFFF)`` for a non-negative seed."""
    b0, b1 = _hash_words(seed, n)
    return b0 ^ b1


def random_bits64(seed: int, n: int) -> np.ndarray:
    """The 64-bit draw of the same layout (``jax.random.bits`` with
    ``uint64``): the first hash word is the high half, the second the
    low half."""
    b0, b1 = _hash_words(seed, n)
    return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)


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


# XLA's ErfInv64 coefficients (w < 6.25, w < 16 and w >= 16 branches),
# highest degree first
_W_LT6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_W_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_W_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)
# XLA's log1p below sqrt(2) - 1 (the Cephes rational form), highest
# degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f64(x: np.ndarray) -> np.ndarray:
    """XLA's double-precision ``log1p``: ``log(1 + x)`` for
    ``|x| >= sqrt(2) - 1``, a rational form below (within 1 ulp of
    ``jax.numpy.log1p`` on the CPU, where numpy's differs by up to 128)."""
    def poly(cs):
        p = np.zeros_like(x)
        for c in cs:
            p = p * x + c
        return p

    with np.errstate(divide="ignore", invalid="ignore"):
        large = np.log(x + 1.0)
        x2 = x * x
        small = x + (-0.5 * x2 + (x * x2) * (poly(_LOG1P_NUM)
                                             / poly(_LOG1P_DEN)))
    return np.where(np.abs(x) < 0.41421356237309504880, small, large)


def _erfinv_f64(x: np.ndarray) -> np.ndarray:
    """XLA's ErfInv64 (Giles' three-branch polynomial) in numpy."""
    x = x.astype(np.float64)
    w = -_log1p_f64(-x * x)
    lt6 = w < 6.25
    lt16 = w < 16.0
    with np.errstate(invalid="ignore"):
        w = np.where(lt6, w - 3.125,
                     np.sqrt(w) - np.where(lt16, 3.25, 5.0))

    def coef(i):
        c = np.full_like(x, _W_LT6_25[i])
        if i < len(_W_LT16):
            c = np.where(lt6, c, _W_LT16[i])
        if i < len(_W_GE16):
            c = np.where(lt16, c, _W_GE16[i])
        return c

    p = coef(0)
    for i in range(1, len(_W_GE16)):
        p = coef(i) + p * w
    for i in range(len(_W_GE16), len(_W_LT16)):
        p = np.where(lt16, coef(i) + p * w, p)
    for i in range(len(_W_LT16), len(_W_LT6_25)):
        p = np.where(lt6, coef(i) + p * w, p)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == 1.0, x * np.inf, p * x)


def normal_f64(seed: int, n: int) -> np.ndarray:
    """``jax.random.normal(jax.random.key(seed), (n,), float64)``: 64
    random bits, a 52-bit mantissa uniform and XLA's ErfInv64."""
    f64 = np.float64
    bits = random_bits64(seed, n)
    fb = (bits >> np.uint64(64 - 52)) | np.array(1.0, f64).view(np.uint64)
    floats = fb.view(f64) - 1.0
    lo = np.nextafter(f64(-1.0), f64(0.0))
    u = np.maximum(lo, floats * (f64(1.0) - lo) + lo)
    return f64(np.sqrt(2)) * _erfinv_f64(u)


@functools.lru_cache(maxsize=8)
def _seed_cached(n: int) -> np.ndarray:
    out = normal_f32(0, n)
    out.setflags(write=False)
    return out


def power_seed(n: int, dtype="float32") -> np.ndarray:
    """The power-iteration start vector
    ``jax.random.normal(key(0), (n,), dtype)`` for ``dtype`` float32 or
    float64 (read-only, cached per width)."""
    if np.dtype(dtype).name == "float64":
        return orth_seed(n, 1, "float64")[:, 0]
    return _seed_cached(int(n))


@functools.lru_cache(maxsize=8)
def _orth_cached(n: int, k: int, dtype: str) -> np.ndarray:
    draw = normal_f64 if dtype == "float64" else normal_f32
    out = draw(0, n * k).reshape(n, k)
    out.setflags(write=False)
    return out


def orth_seed(n: int, k: int, dtype) -> np.ndarray:
    """The orthogonal-iteration start block
    ``jax.random.normal(key(0), (n, k), dtype)`` for ``dtype`` float32 or
    float64 (read-only, cached per shape and dtype)."""
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"orth_seed draws float32 or float64, got {name}")
    return _orth_cached(int(n), int(k), name)
