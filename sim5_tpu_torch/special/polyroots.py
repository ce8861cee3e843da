"""Closed-form polynomial root solvers (quadratic, cubic, quartic).

Port of `sim5_tpu/special/polyroots.py`.  Roots are returned as separate
(real, imag) tensors.  Dtype and device follow the inputs; in f32 the
quartic takes the exact power-of-two rescale that keeps its resolvent
cubic inside the f32 exponent range.  (reference: sim5polyroots.c)
"""

import math

import torch

from ..core.metric import _as_tensors


def _cbrt(x):
    """Real cube root of x >= 0 (torch has no cbrt): the power form, then
    one Newton step to the working precision."""
    y = torch.pow(x, 1.0 / 3.0)
    y_safe = torch.where(y > 0.0, y, 1.0)
    return torch.where(y > 0.0, y - (y * y * y - x) / (3.0 * y_safe * y_safe),
                       y)


def quadratic_roots(a, b, c):
    """Roots of a x^2 + b x + c = 0.

    Returns (re, im) each of shape (..., 2) and n_real of shape (...).
    (reference: sim5polyroots.c:8-60)
    """
    a, b, c = _as_tensors(a, b, c)
    d = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.abs(d))
    # real case (numerically stable form)
    qq = -0.5 * (b + torch.sign(b) * sq)
    a_safe = torch.where(a == 0.0, 1.0, a)
    qq_safe = torch.where(qq == 0.0, 1.0, qq)
    r1 = qq / a_safe
    r2 = c / qq_safe
    re_real = torch.stack([torch.maximum(r1, r2), torch.minimum(r1, r2)], -1)
    im_real = torch.zeros_like(re_real)
    # complex case
    re_c = torch.stack([-b / (2 * a_safe)] * 2, -1)
    im_c = torch.stack([sq / (2 * a_safe), -sq / (2 * a_safe)], -1)
    real = (d >= 0.0)[..., None]
    return (torch.where(real, re_real, re_c),
            torch.where(real, im_real, im_c),
            torch.where(d >= 0.0, 2, 0))


def cubic_roots(p, q, r):
    """Roots of x^3 + p x^2 + q x + r = 0 (monic, real coefficients).

    Returns (re, im) of shape (..., 3) and n_real.  (sim5polyroots.c:93-150)
    """
    p, q, r = _as_tensors(p, q, r)
    Q = (p * p - 3.0 * q) / 9.0
    R = (2.0 * p ** 3 - 9.0 * p * q + 27.0 * r) / 54.0
    three_real = R * R < Q ** 3
    # three real roots -- inputs sanitized in the untaken branch
    Q_safe = torch.where(Q > 0.0, Q, 1.0)
    arg = torch.where(three_real, R / torch.sqrt(Q_safe ** 3), 0.0)
    th = torch.arccos(torch.clamp(arg, -1.0, 1.0))
    sq = torch.sqrt(Q_safe)
    x1 = -2.0 * sq * torch.cos(th / 3.0) - p / 3.0
    x2 = -2.0 * sq * torch.cos((th + 2.0 * math.pi) / 3.0) - p / 3.0
    x3 = -2.0 * sq * torch.cos((th - 2.0 * math.pi) / 3.0) - p / 3.0
    # one real root
    disc = torch.where(three_real, 1.0, R * R - Q ** 3)
    A = -torch.sign(R) * _cbrt(torch.abs(R) + torch.sqrt(disc))
    A_safe = torch.where(A == 0.0, 1.0, A)
    B = torch.where(A == 0.0, 0.0, Q / A_safe)
    y1 = (A + B) - p / 3.0
    yr = -0.5 * (A + B) - p / 3.0
    yi = (math.sqrt(3.0) / 2.0) * (A - B)
    re = torch.where(three_real[..., None],
                     torch.stack([x1, x2, x3], -1),
                     torch.stack([y1, yr, yr], -1))
    im = torch.where(three_real[..., None],
                     torch.zeros_like(re),
                     torch.stack([torch.zeros_like(yi), yi, -yi], -1))
    return re, im, torch.where(three_real, 3, 1)


def _exponent(v):
    """frexp exponent of v (of 1 where v == 0)."""
    return torch.frexp(torch.where(v != 0.0, v, 1.0))[1]


def quartic_roots(a3, a2, a1, a0):
    """Roots of z^4 + a3 z^3 + a2 z^2 + a1 z + a0 = 0.

    Returns (re, im) of shape (..., 4) and n_real (...).  Resolvent-cubic
    closed form (sim5polyroots.c:330-447), branchless via masks.
    """
    a3, a2, a1, a0 = _as_tensors(a3, a2, a1, a0)
    # depressed quartic y^4 + p y^2 + q y + r, z = y - a3/4
    sh = a3 / 4.0
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + a3 ** 3 / 8.0
    r = a0 - a3 * a1 / 4.0 + a3 * a3 * a2 / 16.0 - 3.0 * a3 ** 4 / 256.0
    # exact power-of-two rescale y = lam u (p ~ lam^2, q ~ lam^3,
    # r ~ lam^4): the resolvent discriminant needs ~(root scale)^12 of
    # range, which overflows f32 for root scales beyond ~1e3.  IEEE f64
    # has the range and skips it.
    if p.dtype == torch.float32:
        e = torch.maximum(
            torch.maximum((_exponent(p) + 1) // 2, (_exponent(q) + 2) // 3),
            torch.clamp((_exponent(r) + 3) // 4, min=0))
        lam = torch.exp2(e.to(p.dtype))
        il = 1.0 / lam
        p = p * il * il
        q = q * il * il * il
        r = r * (il * il) * (il * il)
    else:
        lam = torch.ones_like(p)
    # resolvent cubic: u^3 - p u^2 - 4 r u + (4 p r - q^2) = 0;
    # take the LARGEST real root so that w^2 = u - p >= 0
    cre, cim, _ = cubic_roots(-p, -4.0 * r, 4.0 * p * r - q * q)
    u = torch.amax(torch.where(cim == 0.0, cre, -math.inf), dim=-1)
    # discriminant-boundary rescue (see the JAX module)
    one_real = cim[..., 1] != 0.0
    utol = 100.0 * torch.finfo(u.dtype).eps * (torch.abs(u) + torch.abs(p))
    yr = cre[..., 1]
    u = torch.where(one_real & (u - p < utol) & (yr - p > utol), yr, u)
    # factor into (y^2 + w y + c1)(y^2 - w y + c2), w = sqrt(u - p)
    w2 = u - p
    w = torch.sqrt(torch.clamp(w2, min=0.0))
    w_zero = w2 <= 100.0 * torch.finfo(w2.dtype).eps * (torch.abs(u)
                                                        + torch.abs(p))
    w_safe = torch.where(w_zero, 1.0, w)
    c1 = u / 2.0 - torch.where(w_zero, 0.0, q / (2.0 * w_safe))
    c2 = u / 2.0 + torch.where(w_zero, 0.0, q / (2.0 * w_safe))
    # biquadratic (w == 0) case, the cancelling partner by Vieta
    d_b = p * p - 4.0 * r
    sd_b = torch.sqrt(torch.abs(d_b))
    c_big = 0.5 * (p + torch.sign(p) * sd_b)
    c_big = torch.where(torch.sign(p) == 0.0, 0.5 * sd_b, c_big)
    c_big_safe = torch.where(c_big == 0.0, 1.0, c_big)
    c_small = torch.where(c_big == 0.0, 0.0, r / c_big_safe)
    c1b = torch.where(p >= 0.0, c_small, c_big)
    c2b = torch.where(p >= 0.0, c_big, c_small)
    usable = d_b >= 0.0
    c1 = torch.where(w_zero & usable, c1b,
                     torch.where(w_zero, (p - sd_b) / 2.0, c1))
    c2 = torch.where(w_zero & usable, c2b,
                     torch.where(w_zero, (p + sd_b) / 2.0, c2))
    w = torch.where(w_zero, 0.0, w)

    re1, im1, n1 = quadratic_roots(torch.ones_like(w), w, c1)
    re2, im2, n2 = quadratic_roots(torch.ones_like(w), -w, c2)
    # undo the exact rescale (y = lam u), then the depression shift
    re = torch.cat([re1, re2], -1) * lam[..., None] - sh[..., None]
    im = torch.cat([im1, im2], -1) * lam[..., None]
    return re, im, n1 + n2


def _splitter(dtype):
    return 134217729.0 if dtype == torch.float64 else 4097.0


def _two_sum(a, b):
    """Knuth error-free transform: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """Dekker/Veltkamp error-free product: a * b = p + err exactly."""
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


def _split(a):
    """Veltkamp split a = hi + lo (both halves exact)."""
    c = a * _splitter(a.dtype)
    hi = c - (c - a)
    return hi, a - hi


def _compensated_R(z, c2, c1, c0):
    """R(z) = z^4 + c2 z^2 + c1 z + c0 by the error-free compensated Horner
    scheme (as if in twice the precision), with the split of z shared."""
    zh, zl = _split(z)
    s = z * z
    e = (zh * zh - s + 2.0 * zh * zl) + zl * zl
    s, e2 = _two_sum(s, c2.expand_as(s))
    err = e + e2
    sh, sl = _split(s)
    p = s * z
    e = (sh * zh - p + sh * zl + sl * zh) + sl * zl
    err = err * z + e
    s, e2 = _two_sum(p, c1.expand_as(p))
    err = err + e2
    sh, sl = _split(s)
    p = s * z
    e = (sh * zh - p + sh * zl + sl * zh) + sl * zl
    err = err * z + e
    s, e2 = _two_sum(p, c0.expand_as(p))
    return s + (err + e2)


def _newton_step_compensated(z, im, c2, c1, c0):
    """One Newton step on R = z^4 + c2 z^2 + c1 z + c0 with R evaluated by
    the compensated Horner scheme.  Returns (z_new, delta, ok)."""
    R = _compensated_R(z, c2, c1, c0)
    dR = (4.0 * z * z + 2.0 * c2) * z + c1
    scale = 4.0 * torch.abs(z) ** 3 + 2.0 * torch.abs(c2 * z) + torch.abs(c1)
    ok = (im == 0.0) & (torch.abs(dR) > 1e-5 * scale) & torch.isfinite(R)
    delta = torch.where(ok, -R / torch.where(ok, dR, 1.0), 0.0)
    return z + delta, delta, ok


def polish_quartic_real_roots_df(re, im, c2, c1, c0):
    """Two compensated-Newton steps on the real quartic roots of
    z^4 + c2 z^2 + c1 z + c0, returning each root as a two-float pair
    (hi, lo), root = hi + lo; complex and double-root lanes pass through
    with lo = 0.  (See the JAX module for why two steps and a low part:
    near-critical rays need the root GAP to ~1 ulp of the gap.)
    """
    c2 = c2[..., None]
    c1 = c1[..., None]
    c0 = c0[..., None]
    z0 = re
    # pass 1: compensated Horner for R(z0)
    R0 = _compensated_R(z0, c2, c1, c0)
    dR0 = (4.0 * z0 * z0 + 2.0 * c2) * z0 + c1
    scale = (4.0 * torch.abs(z0) ** 3 + 2.0 * torch.abs(c2 * z0)
             + torch.abs(c1))
    ok = (im == 0.0) & (torch.abs(dR0) > 1e-5 * scale) & torch.isfinite(R0)
    da = torch.where(ok, -R0 / torch.where(ok, dR0, 1.0), 0.0)
    # pass 2 via the exact quartic Taylor expansion about z0
    z1f, rho = _two_sum(z0, da)
    dp = da - rho
    dp2 = dp * dp
    R1 = R0 + dR0 * dp + (6.0 * z0 * z0 + c2) * dp2 \
        + 4.0 * z0 * dp * dp2 + dp2 * dp2
    dR1 = (4.0 * z1f * z1f + 2.0 * c2) * z1f + c1
    d2 = torch.where(ok, -R1 / torch.where(ok, dR1, 1.0), 0.0)
    hi, lo = _two_sum(z1f, d2)
    return torch.where(ok, hi, re), torch.where(ok, lo, 0.0)


def sort_quartic_roots(re, im):
    """Order roots: real roots first in descending order, complex roots last.

    Returns (re_sorted, im_sorted, n_real).  (reference:
    sim5polyroots.c:278-325)  A 5-comparator sorting network that swaps
    only on strictly greater keys, so the complex roots (keyed +inf) keep
    their order and conjugate pairs stay adjacent, +imag first.
    """
    is_real = im == 0.0
    n_real = is_real.sum(-1)
    lanes = [(torch.where(is_real[..., j], -re[..., j], math.inf),
              re[..., j], im[..., j]) for j in range(4)]

    def ce(a, b):
        ka, ra, ia = a
        kb, rb, ib = b
        swap = ka > kb
        return ((torch.where(swap, kb, ka), torch.where(swap, rb, ra),
                 torch.where(swap, ib, ia)),
                (torch.where(swap, ka, kb), torch.where(swap, ra, rb),
                 torch.where(swap, ia, ib)))

    l0, l1, l2, l3 = lanes
    l0, l1 = ce(l0, l1)
    l2, l3 = ce(l2, l3)
    l0, l2 = ce(l0, l2)
    l1, l3 = ce(l1, l3)
    l1, l2 = ce(l1, l2)
    re_s = torch.stack([l0[1], l1[1], l2[1], l3[1]], -1)
    im_s = torch.stack([l0[2], l1[2], l2[2], l3[2]], -1)
    return re_s, im_s, n_real
