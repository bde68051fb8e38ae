"""``jax.random.uniform`` and ``jax.random.normal`` under
``PRNGKey(seed)`` in NumPy, bit for bit.

The power solver's start vector is ``uniform - 0.5`` (gKL2.cu:322's
``srand(42)`` analog, ``eig_kl_tpu/spectral/power.py:189-190``); the
Lanczos and LOBPCG start vectors are ``normal`` draws
(``eig_kl_tpu/spectral/lanczos.py:146``, ``lobpcg_solver.py:67``).  The
port reproduces the JAX package's draws, so that both packages start
from the same bits.

This is Threefry-2x32 with 20 rounds (Salmon et al., SC'11), counted
the way JAX's partitionable mode counts (the default since jax 0.5):
element ``i`` of a 1-D draw hashes the counter pair ``(0, i)``.  A
32-bit draw takes ``hi ^ lo`` of the hashed pair, a 64-bit draw takes
``hi << 32 | lo``.  The float is built from the top mantissa bits with
exponent 0 (a value in [1, 2)), minus 1.  A draw of any shape hashes its
row-major flat index.

``normal`` is ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
``[nextafter(-1, 0), 1)``, with ``erf_inv`` as XLA's CPU backend computes
it: M. Giles's polynomials ("Approximating the erfinv function", GPU
Computing Gems, 2011) in ``w = -log1p(-u * u)``, each Horner step one
fused multiply-add, and ``log1p`` a rational function below 0.4142 and
``log(1 + x)`` above.  In f32 ``log`` is Eigen's polynomial (Cephes's
``logf``), reproduced here operation for operation, so the f32 draw
equals JAX's bit for bit.  In f64 ``log`` is the C library's
(``math.log``), and the fused multiply-adds are emulated with error-free
transformations that round correctly in all but rare double-rounding
cases, so the f64 draw is held to one ulp of JAX's.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Hash the counter pairs ``(x0[i], x1[i])`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as a pair of uint32 words."""
    seed = int(seed)
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def uniform(seed: int, n, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype)`` for
    ``n`` a length or a shape."""
    dtype = np.dtype(dtype)
    shape = (n,) if np.ndim(n) == 0 else tuple(n)
    return _uniform_flat(seed, math.prod(shape), dtype).reshape(shape)


def _uniform_flat(seed: int, n: int, dtype: np.dtype) -> np.ndarray:
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(
            prng_key(seed),
            (idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
    if dtype == np.float32:
        bits = (hi ^ lo) >> np.uint32(32 - 23)
        bits |= np.array(1.0, np.float32).view(np.uint32)
        return bits.view(np.float32) - np.float32(1.0)
    if dtype == np.float64:
        bits = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        bits = bits >> np.uint64(64 - 52)
        bits |= np.array(1.0, np.float64).view(np.uint64)
        return bits.view(np.float64) - np.float64(1.0)
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")


# ------------------------------------------------------------------ normal

# Giles's single-precision erfinv: (w < 5 coefficient, w >= 5 coefficient),
# highest degree first, as XLA's f32 expansion rounds them.
_ERFINV_F32 = tuple(
    (float.fromhex(a), float.fromhex(b))
    for a, b in (
        ("0x1.e2cb1p-26", "-0x1.a3e136p-13"), ("0x1.70966cp-22", "0x1.a76ad6p-14"),
        ("-0x1.d8e6aep-19", "0x1.61b8e4p-10"), ("-0x1.26b582p-18", "-0x1.e17bcep-9"),
        ("0x1.ca65b6p-13", "0x1.7824f6p-8"), ("-0x1.48a81p-10", "-0x1.f38baep-8"),
        ("-0x1.11c9dep-8", "0x1.354afcp-7"), ("0x1.f91ec6p-3", "0x1.006db6p+0"),
        ("0x1.805c5ep+0", "0x1.6a9efcp+1"),
    )
)
# Giles's double-precision erfinv, one polynomial per range of w: below
# 6.25 in w - 3.125, below 16 in sqrt(w) - 3.25, above in sqrt(w) - 5.
_ERFINV_F64 = (
    (-3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
     1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
     6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
     2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
     1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
     4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
     0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
     0.24015818242558962, 1.6536545626831027),
    (2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
     1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
     2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
     6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
     0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
     -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
     3.0838856104922208),
    (-2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
     -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
     2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
     -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
     7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
     1.0103004648645344, 4.849906401408584),
)
# The rational log1p below |x| < 0.4142: numerator (monic, after the
# leading 1) and denominator coefficients, in f32 and f64 as XLA rounds
# them; Cephes's logf coefficients for the f32 log.
_LOG1P_NUM = (15.062909083469192, 83.04756596796722, 221.76239823732857,
              309.09872225312057, 216.42788614495947, 60.11866049760384)
_LOG1P_DEN = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554, 20.039553499201283)
_LOGF = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
         1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
         3.3333331174e-1)


def _fma32(a, b, c) -> np.ndarray:
    """``fmaf(a, b, c)`` for f32 arrays: the product is exact in f64 and the
    f64 sum is rounded to odd before the rounding to f32 (Boldo and
    Melquiond, 2005), which makes that rounding the fused one."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32).astype(np.float64)
    c = np.broadcast_to(np.asarray(c, np.float32).astype(np.float64), p.shape)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _two_sum(a, b):
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _two_prod(a, b):
    """``a * b`` as an unevaluated sum of two f64 values (Veltkamp split)."""
    p = a * b

    def split(x):
        t = 134217729.0 * x  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a, b, c) -> np.ndarray:
    """``fma(a, b, c)`` for f64 arrays from error-free transformations: the
    exact ``a * b + c`` as ``s + t + e``, rounded as ``s + (t + e)``."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float64), np.asarray(b, np.float64))
    p, e = _two_prod(a, b)
    s, t = _two_sum(p, np.broadcast_to(np.asarray(c, np.float64), p.shape))
    return s + (t + e)


def _logf(a: np.ndarray) -> np.ndarray:
    """Eigen's ``plog`` for f32 (Cephes's ``logf``), as XLA's CPU backend
    vectorizes it: the mantissa in [sqrt(1/2), sqrt(2)), the polynomial in
    three Horner chains of fused multiply-adds, the exponent added in two
    parts."""
    f32 = np.float32
    clamped = np.maximum(a, f32(2.0**-126))
    bits = clamped.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(f32) + f32(1)
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(f32)
    low = m < f32(float.fromhex("0x1.6a09e6p-1"))
    x = (m - f32(1)) + np.where(low, m, f32(0))
    e = e - np.where(low, f32(1), f32(0))
    x2 = x * x
    x3 = x2 * x
    p = [f32(c) for c in _LOGF]
    y = _fma32(_fma32(x, p[0], p[1]), x, p[2])
    y1 = _fma32(_fma32(x, p[3], p[4]), x, p[5])
    y2 = _fma32(_fma32(x, p[6], p[7]), x, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, e * f32(-2.12194440e-4))
    r = _fma32(e, f32(0.693359375), _fma32(x2, f32(-0.5), x) + y)
    r = np.where(a < 0, f32(np.nan), r)
    r = np.where(a == 0, f32(-np.inf), r)
    return np.where(a == np.inf, f32(np.inf), r).astype(f32)


def _log1p(t: np.ndarray, fma, log) -> np.ndarray:
    """XLA's ``log1p``: ``log(1 + t)``, and below |t| < 0.4142
    ``t - t^2/2 + t^3 P(t)/Q(t)``."""
    dt = t.dtype.type
    big = log(t + dt(1))
    num = np.ones_like(t)
    for c in _LOG1P_NUM:
        num = fma(num, t, dt(c))
    den = np.full_like(t, dt(_LOG1P_DEN[0]))
    for c in _LOG1P_DEN[1:]:
        den = fma(den, t, dt(c))
    t2 = t * t
    small = t + fma(t2, dt(-0.5), (t * t2) * (den / num))
    return np.where(np.abs(t) < dt(0.41421356237309504880), small, big)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``erf_inv`` for f32 or f64 arrays."""
    dt = x.dtype.type
    with np.errstate(all="ignore"):
        if x.dtype == np.float32:
            lg = _log1p(x * -x, _fma32, _logf)
            near = lg > dt(-5)  # w = -lg < 5
            w = np.where(near, dt(-2.5) - lg, np.sqrt(-lg) - dt(3))
            coef = [np.where(near, dt(a), dt(b)) for a, b in _ERFINV_F32]
            p = coef[0]
            for c in coef[1:]:
                p = _fma32(w, p, c)
        else:
            log = np.vectorize(lambda v: math.log(v) if v > 0 else (-math.inf if v == 0 else math.nan),
                               otypes=[np.float64])
            lg = _log1p(x * -x, _fma64, log)
            root = np.sqrt(-lg)
            p = np.zeros_like(x)
            for sel, w, coef in (
                (lg > -6.25, -3.125 - lg, _ERFINV_F64[0]),
                ((lg <= -6.25) & (lg > -16.0), root - 3.25, _ERFINV_F64[1]),
                (lg <= -16.0, root - 5.0, _ERFINV_F64[2]),
            ):
                if sel.any():
                    q = np.full(int(sel.sum()), coef[0])
                    for c in coef[1:]:
                        q = _fma64(w[sel], q, c)
                    p[sel] = q
        p = np.where(np.abs(x) == 1, dt(np.inf), p)
        return (x * p).astype(x.dtype)


def normal(seed: int, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)``: f32 bit
    for bit, f64 within one ulp (see the module note)."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"normal supports float32 and float64, got {dtype}")
    dt = dtype.type
    lo = np.nextafter(dt(-1), dt(0))
    # uniform(lo, 1): floats * (1 - lo) + lo, where 1 - lo rounds to 2.
    u = np.maximum(lo, uniform(seed, shape, dtype) * dt(2) + lo)
    return (dt(np.sqrt(2)) * _erf_inv(u)).astype(dtype)
