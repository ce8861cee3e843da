"""Error-free transforms and the cancellation-free pieces of the NT flux.

Port of `sim5_tpu/utils/fastmath.py`: Knuth's `two_sum`, Dekker's
`two_prod`, the two-float square root `sqrt_df`, `vlog(u) = u - log1p(u)`
without cancellation, and the accurate transcendentals.  Dtype and device
follow the inputs.

The JAX module patches the TPU's approximate f32 `log`, `exp` and
`expm1`.  torch's f32 `log`, `exp` and `expm1` are IEEE-accurate on the
CPU and on the card (no fast-math intrinsics), so `log_accurate`,
`exp_accurate` and `expm1_accurate` keep their names here and are
`torch.log`, `torch.exp` and `torch.expm1` in every dtype.
"""

import torch


def _splitter(dtype):
    """Veltkamp's splitter 2^ceil(p/2) + 1 for the dtype's precision p."""
    return 134217729.0 if dtype == torch.float64 else 4097.0


def two_sum(a, b):
    """Knuth error-free transform: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def two_prod(a, b):
    """Dekker/Veltkamp error-free product: a * b = p + err exactly (no FMA
    assumption; splitter picked for the dtype)."""
    sp = _splitter(a.dtype)
    ca = a * sp
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * sp
    bhi = cb - (cb - b)
    blo = b - bhi
    p = a * b
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def log_accurate(y):
    """Natural log to ~1 ulp in every dtype: `torch.log`, which is
    IEEE-accurate in f32 on the CPU and on the card (the JAX package's
    bit-level f32 log works around the TPU's approximate one)."""
    return torch.log(y)


def exp_accurate(x):
    """exp to ~1 ulp in every dtype: `torch.exp` (the JAX package's f32
    patch works around the TPU's ~8e-6 exp; identical to exp in f64)."""
    return torch.exp(x)


def expm1_accurate(x):
    """expm1 to ~1 ulp in every dtype: `torch.expm1` (the JAX package's
    f32 patch works around the TPU's ~1.1e-4 expm1; identical to expm1 in
    f64)."""
    return torch.expm1(x)


def vlog(u):
    """u - log1p(u) for u >= 0 without the cancellation of the direct
    subtraction (which loses ~(2/u) digits as u -> 0).

    In f32, for u <= 0.5, via log1p(u) = 2 atanh(s), s = u/(2+u):
      vlog(u) = u^2/(2+u) - 2(s^3/3 + s^5/5 + s^7/7 + s^9/9),
    truncation < 5e-8 relative; larger u takes the direct subtraction.  In
    f64 the direct form with the correctly rounded log1p is kept, as in
    the JAX package.
    """
    if u.dtype != torch.float32:
        return u - torch.log1p(u)
    s = u / (2.0 + u)
    s2 = s * s
    series = u * u / (2.0 + u) - 2.0 * s * s2 * (
        1.0 / 3.0 + s2 * (0.2 + s2 * (1.0 / 7.0 + s2 / 9.0)))
    direct = u - log_accurate(1.0 + u)
    return torch.where(u <= 0.5, series, direct)


def sqrt_df(x):
    """sqrt(x) as a two-float pair (hi, lo): hi = fl(sqrt(x)), lo the
    Newton residual (x - hi^2)/(2 hi) with hi^2 formed error-free.
    Accurate to ~ulp^2; for differences of square roots that must be
    accurate far below the ulp of the operands."""
    hi = torch.sqrt(x)
    hi_safe = torch.where(hi > 0.0, hi, 1.0)
    p, e = two_prod(hi_safe, hi_safe)
    lo = ((x - p) - e) / (2.0 * hi_safe)
    return hi, torch.where(hi > 0.0, lo, 0.0)
