"""Legendre elliptic integrals F, E, Pi in Carlson form.

Port of `sim5_tpu/special/legendre.py`.  (reference: sim5elliptic.c:217-474;
conventions m = k^2 as in Byrd & Friedman)  All functions broadcast; dtype
and device follow the inputs.  The `_cos`/`_sin` variants take the cosine
or sine of the amplitude directly, which is what the geodesic engine
produces.
"""

import math

import torch

from ..core.metric import _as_tensors
from .carlson import rf, rd, rj


def _clamp_m(m):
    return torch.where(m >= 1.0, 0.99999999, m)


def elliptic_k(m):
    """Complete elliptic integral K(m).  (sim5elliptic.c:217-225)"""
    m, = _as_tensors(m)
    m = torch.where(m == 1.0, 1.0 - 1e-8, m)
    return rf(torch.zeros_like(m), 1.0 - m, torch.ones_like(m))


def elliptic_k_mc(mc):
    """Complete elliptic integral K(m) from the COMPLEMENT mc = 1 - m, by
    the arithmetic-geometric mean:  K = pi / (2 AGM(1, sqrt(mc))).

    The fixed depths (9 in f64, 7 in f32) reach the working precision's
    noise floor for any mc >= 1e-12; dtype and device follow the input.
    """
    mc, = _as_tensors(mc)
    depth = 9 if mc.dtype == torch.float64 else 7
    a = torch.ones_like(mc)
    b = torch.sqrt(torch.clamp(mc, min=1e-30))
    for _ in range(depth):
        a, b = 0.5 * (a + b), torch.sqrt(a * b)
    return math.pi / (a + b)   # = pi / (2 * agm)


def elliptic_f(phi, m):
    """Incomplete elliptic integral F(phi, m), any real phi.
    (sim5elliptic.c:236-252)"""
    phi, m = _as_tensors(phi, m)
    m = _clamp_m(m)
    # range-reduce phi into (-pi/2, pi/2]: k = round(phi/pi)
    k = torch.round(phi / math.pi)
    phir = phi - k * math.pi
    s2 = torch.sin(phir) ** 2
    f = (torch.sign(phir) * torch.sqrt(s2)
         * rf(1.0 - s2, 1.0 - s2 * m, torch.ones_like(s2)))
    f = torch.where(phir == 0.0, 0.0, f)
    return f + 2.0 * k * elliptic_k(m)


def elliptic_f_cos(cos_phi, m):
    """F(phi, m) with phi given by its cosine, 0 <= phi <= pi.
    (sim5elliptic.c:254-271)"""
    cos_phi, m = _as_tensors(cos_phi, m)
    m = _clamp_m(m)
    neg = cos_phi < 0.0
    c = torch.abs(cos_phi)
    X = torch.where(neg, 2.0 * rf(torch.zeros_like(m), 1.0 - m,
                                  torch.ones_like(m)), 0.0)
    s2 = 1.0 - c * c
    base = (torch.sqrt(torch.clamp(s2, min=0.0))
            * rf(1.0 - s2, 1.0 - s2 * m, torch.ones_like(s2)))
    out = X + torch.where(neg, -base, base)
    return torch.where(cos_phi == 1.0, 0.0, out)


def elliptic_f_sin(sin_phi, m):
    """F(phi, m) with phi in the first quadrant given by its sine.
    (sim5elliptic.c:273-284)"""
    sin_phi, m = _as_tensors(sin_phi, m)
    m = _clamp_m(m)
    s2 = sin_phi * sin_phi
    out = sin_phi * rf(1.0 - s2, 1.0 - s2 * m, torch.ones_like(s2))
    return torch.where(sin_phi == 0.0, 0.0, out)


def _e_complete(m):
    z = torch.zeros_like(m)
    o = torch.ones_like(m)
    return rf(z, 1.0 - m, o) - m * rd(z, 1.0 - m, o) / 3.0


def _e_base(s, c2, q, m):
    """s (RF(c2, q, 1) - s^2 m RD(c2, q, 1) / 3): E's first-quadrant part."""
    o = torch.ones_like(m)
    return s * (rf(c2, q, o) - (s * s * m) * rd(c2, q, o) / 3.0)


def elliptic_e(phi, m):
    """Incomplete elliptic integral E(phi, m), 0 <= phi <= pi.
    (sim5elliptic.c:294-316)"""
    phi, m = _as_tensors(phi, m)
    m = _clamp_m(m)
    over = phi > 0.5 * math.pi
    phir = torch.where(over, math.pi - phi, phi)
    X = torch.where(over, 2.0 * _e_complete(m), 0.0)
    s = torch.sin(phir)
    c2 = torch.cos(phir) ** 2
    base = _e_base(s, c2, 1.0 - s * s * m, m)
    out = X + torch.where(over, -base, base)
    return torch.where(phi == 0.0, 0.0, out)


def elliptic_e_cos(cos_phi, m):
    """E(phi, m) with phi given by its cosine, 0 <= phi <= pi.
    (sim5elliptic.c:318-337)"""
    cos_phi, m = _as_tensors(cos_phi, m)
    m = _clamp_m(m)
    neg = cos_phi < 0.0
    c = torch.abs(cos_phi)
    X = torch.where(neg, 2.0 * _e_complete(m), 0.0)
    c2 = c * c
    s = torch.sqrt(torch.clamp(1.0 - c2, min=0.0))
    base = _e_base(s, c2, 1.0 - m + c2 * m, m)
    out = X + torch.where(neg, -base, base)
    return torch.where(cos_phi == 1.0, 0.0, out)


def elliptic_e_sin(sin_phi, m):
    """E(phi, m) with phi in the first quadrant given by its sine.
    (sim5elliptic.c:339-355)"""
    sin_phi, m = _as_tensors(sin_phi, m)
    m = _clamp_m(m)
    s2 = sin_phi * sin_phi
    out = _e_base(sin_phi, 1.0 - s2, 1.0 - s2 * m, m)
    return torch.where(sin_phi == 0.0, 0.0, out)


def elliptic_pi_complete(n, m):
    """Complete elliptic integral Pi(n, m) (Mathematica sign convention for
    n).  (sim5elliptic.c:365-378)"""
    n, m = _as_tensors(n, m)
    m = _clamp_m(m)
    n = torch.where(n == 1.0, 0.99999999, n)
    q = 1.0 - m
    z = torch.zeros_like(m)
    o = torch.ones_like(m)
    out = rf(z, q, o) + n * rj(z, q, o, 1.0 - n) / 3.0
    return torch.where(torch.isinf(n), 0.0, out)


def elliptic_pi_cos(cos_phi, n, m):
    """Pi(phi, n, m) with phi given by its cosine, 0 <= phi <= pi.
    (sim5elliptic.c:425-450)"""
    cos_phi, n, m = _as_tensors(cos_phi, n, m)
    m = _clamp_m(m)
    negp = cos_phi < 0.0
    c = torch.abs(cos_phi)
    z = torch.zeros_like(m)
    o = torch.ones_like(m)
    X = torch.where(negp, 2.0 * (rf(z, 1.0 - m, o)
                                 + n * rj(z, 1.0 - m, o, 1.0 - n) / 3.0), 0.0)
    c2 = c * c
    s2 = 1.0 - c2
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    ns2 = -n * s2
    q = 1.0 - s2 * m
    base = s * (rf(c2, q, o) - ns2 * rj(c2, q, o, 1.0 + ns2) / 3.0)
    out = X + torch.where(negp, -base, base)
    out = torch.where(cos_phi == 1.0, 0.0,
                      torch.where(cos_phi == 0.0, elliptic_pi_complete(n, m),
                                  out))
    return torch.where(torch.isinf(n), 0.0, out)


def elliptic_pi_sin(sin_phi, n, m):
    """Pi(phi, n, m) with phi in the first quadrant given by its sine.
    (sim5elliptic.c:453-474)"""
    sin_phi, n, m = _as_tensors(sin_phi, n, m)
    m = _clamp_m(m)
    s2 = sin_phi * sin_phi
    c2 = 1.0 - s2
    ns2 = -n * s2
    q = 1.0 - s2 * m
    o = torch.ones_like(m)
    out = sin_phi * (rf(c2, q, o) - ns2 * rj(c2, q, o, 1.0 + ns2) / 3.0)
    out = torch.where(sin_phi == 0.0, 0.0,
                      torch.where(sin_phi == 1.0,
                                  elliptic_pi_complete(n, m), out))
    return torch.where(torch.isinf(n), 0.0, out)
