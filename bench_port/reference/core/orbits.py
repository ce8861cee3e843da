"""Characteristic orbit radii and Keplerian orbital quantities.

Port of `sim5_tpu/core/orbits.py`.  Dtype and device follow the inputs
(`_as_tensors`).  (reference: sim5kerr.c:980-1141)
"""

import torch

from ..special.polyroots import _cbrt
from ..utils.fastmath import two_prod, two_sum
from .metric import Metric, _as_tensors


def r_bh(a):
    """Event horizon radius [rg].  (sim5kerr.c:981-989)"""
    a, = _as_tensors(a)
    return 1.0 + torch.sqrt(1.0 - a * a)


def _cbrt_signed(x):
    """Real cube root of any x (the port's `_cbrt` takes x >= 0)."""
    return torch.sign(x) * _cbrt(torch.abs(x))


def r_ms(a):
    """Marginally stable (ISCO) orbit radius [rg].  (sim5kerr.c:994-1004)

    Supports negative spin (retrograde) like the reference disk module
    (sim5disk-nt.c:98-104).
    """
    a, = _as_tensors(a)
    z1 = 1.0 + _cbrt_signed(1.0 - a * a) * (_cbrt_signed(1.0 + a)
                                            + _cbrt_signed(1.0 - a))
    z2 = torch.sqrt(3.0 * a * a + z1 * z1)
    sga = torch.where(a >= 0.0, 1.0, -1.0)
    return 3.0 + z2 - sga * torch.sqrt((3.0 - z1) * (3.0 + z1 + 2.0 * z2))


def r_mb(a):
    """Marginally bound orbit radius [rg] (Bardeen+72 eq. 2.19).
    (sim5kerr.c:1008-1018)"""
    a, = _as_tensors(a)
    return (2.0 - a) + 2.0 * torch.sqrt(1.0 - a)


def r_ph(a):
    """Photon orbit radius [rg] (Bardeen+72 eq. 2.18).
    (sim5kerr.c:1022-1032)"""
    a, = _as_tensors(a)
    return 2.0 * (1.0 + torch.cos(2.0 / 3.0 * torch.arccos(-a)))


def OmegaK(r, a):
    """Keplerian angular frequency [geom. units].  (sim5kerr.c:1037-1046)"""
    r, a = _as_tensors(r, a)
    return 1.0 / (a + r ** 1.5)


def ellK(r, a):
    """Keplerian specific angular momentum (Komissarov 2008 form).
    (sim5kerr.c:1050-1072)"""
    r, a = _as_tensors(r, a)
    sr = torch.sqrt(r)
    return (r * r - 2.0 * a * sr + a * a) / (sr * r - 2.0 * sr + a)


def omega_r(r, a):
    """Radial epicyclic frequency.  (sim5kerr.c:1076-1085)"""
    r, a = _as_tensors(r, a)
    return OmegaK(r, a) * torch.sqrt(1.0 - 6.0 / r
                                     + 8.0 * a / torch.sqrt(r * r * r)
                                     - 3.0 * a * a / (r * r))


def omega_z(r, a):
    """Vertical epicyclic frequency.  (sim5kerr.c:1089-1098)"""
    r, a = _as_tensors(r, a)
    return OmegaK(r, a) * torch.sqrt(
        1.0 - 4.0 * a / torch.sqrt(r * r * r) + 3.0 * a * a / (r * r))


def Omega_from_ell(ell, m: Metric):
    """Angular frequency for given specific angular momentum.
    (sim5kerr.c:1102-1111)"""
    return -(m.g03 + ell * m.g00) / (m.g33 + ell * m.g03)


def ell_from_Omega(Omega, m: Metric):
    """Specific angular momentum for given angular frequency.
    (sim5kerr.c:1115-1124)"""
    return -(m.g03 + m.g33 * Omega) / (m.g00 + m.g03 * Omega)


def gfactorK(r, a, l):
    """g-factor (redshift) for Keplerian equatorial emission toward a photon
    with motion constant lambda = l.  (sim5kerr.c:1128-1141)

    Through the Bardeen-Press-Teukolsky circular-orbit identity
      1 - 2/r (1-a Om)^2 - (r^2+a^2) Om^2 = r^{3/2}(r^{3/2}-3 r^{1/2}+2a)
                                            / (r^{3/2}+a)^2,
    with the Keplerian bracket kep = s^3 - 3s + 2a (s = sqrt(r)) in
    compensated double-single form: near its zero the bracket is very
    sensitive to s, so s is carried as the pair s + s_l (s_l the sqrt
    residual, error-free via two_prod) and the cubic is evaluated with
    error-free transforms plus the first-order s_l term (see the JAX
    package).  The same code in every dtype.
    """
    r, a, l = _as_tensors(r, a, l)
    s = torch.sqrt(r)
    p, ep = two_prod(s, s)                   # s^2 = p + ep exactly
    s_safe = torch.clamp(s, min=torch.finfo(s.dtype).tiny)
    s_l = ((r - p) - ep) / (2.0 * s_safe)    # double-single sqrt residual
    u, eu = two_prod(p, s)                   # s^3 = u + eu + ep*s
    m3, em3 = two_sum(2.0 * s, s)            # 3s = m3 + em3 exactly
    v, ev = two_sum(u, -m3)
    w, ew = two_sum(v, 2.0 * a)
    kep = w + (((ew + ev) - em3) + (eu + ep * s)
               + (3.0 * p - 3.0) * s_l)      # + kep'(s) s_l
    s3_ = s * r                              # r^{3/2}
    return torch.sqrt(torch.clamp(s3_ * kep, min=0.0)) / (s3_ + a - l)


def keplerian_EL(r, a):
    """Specific energy E and angular momentum L of the prograde circular
    equatorial orbit at radius r (Bardeen, Press & Teukolsky 1972 eq.
    2.12-2.13)."""
    r, a = _as_tensors(r, a)
    sr = torch.sqrt(r)
    d = r ** 0.75 * torch.sqrt(torch.clamp(r * sr - 3.0 * sr + 2.0 * a,
                                           min=1e-30))
    E = (r * sr - 2.0 * sr + a) / d
    L = (r * r - 2.0 * a * sr + a * a) / d
    return E, L
