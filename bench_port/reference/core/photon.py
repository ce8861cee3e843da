"""Photon momentum, motion constants, Carter constant, 4-velocities.
Port of `sim5_tpu/core/photon.py`.

(reference: sim5kerr.c:1150-1353)
"""

import torch

from .metric import Metric, _as_tensors


def photon_carter_const(k, metric: Metric):
    """Carter constant Q of a null geodesic.  (sim5kerr.c:1255-1268)"""
    m2 = metric.m ** 2
    kt = k[..., 0] * metric.g00 + k[..., 3] * metric.g03
    kh = k[..., 2] * metric.g22
    kf = k[..., 3] * metric.g33 + k[..., 0] * metric.g03
    return kh ** 2 + kf ** 2 * m2 / (1.0 - m2) - metric.a ** 2 * kt ** 2 * m2


def _snap_tolerances(a2, l2, m2, D, r2, al, lma, q):
    """How far below 0 the radial and polar potentials R and M may round
    and still count as 0: the reference's 1e-8 in f64; in f32, 8 ulps of
    the largest term each sums (R's terms reach ~r^4, so 1e-8 is far below
    an f32 rounding at r >~ 1)."""
    if r2.dtype != torch.float32:
        return 1e-8, 1e-8
    eps = 8.0 * torch.finfo(torch.float32).eps
    A = r2 + a2 - al
    tol_R = 1e-8 + eps * (A * A + D.abs() * (lma * lma + q.abs()))
    tol_M = 1e-8 + eps * (q.abs() + l2 * m2 / (1.0 - m2) + a2 * m2)
    return tol_R, tol_M


def photon_momentum_checked(a, r, m, l, q, r_sign, m_sign):
    """Like photon_momentum, but returns (k, valid) with no NaN in k:
    invalid rays get a finite placeholder and valid=False."""
    a, r, m, l, q, r_sign, m_sign = _as_tensors(a, r, m, l, q, r_sign, m_sign)
    a2 = a * a
    l2 = l * l
    r2 = r * r
    m2 = m * m
    S = r2 + a2 * m2
    D = r2 - 2.0 * r + a2
    R = (r2 + a2 - a * l) ** 2 - D * ((l - a) ** 2 + q)
    M = q - l2 * m2 / (1.0 - m2) + a2 * m2
    tol_R, tol_M = _snap_tolerances(a2, l2, m2, D, r2, a * l, l - a, q)
    R = torch.where((R < 0.0) & (R > -tol_R), 0.0, R)
    M = torch.where((M < 0.0) & (M > -tol_M), 0.0, M)
    valid = (R >= 0.0) & (M >= 0.0)
    sqrtR = torch.where(R > 0.0, torch.sqrt(torch.where(R > 0.0, R, 1.0)), 0.0)
    sqrtM = torch.where(M > 0.0, torch.sqrt(torch.where(M > 0.0, M, 1.0)), 0.0)
    k0 = (-a * (a * (1.0 - m2) - l) + (r2 + a2) / D * (r2 + a2 - a * l)) / S
    k1 = sqrtR / S * torch.sign(r_sign + 0.5)
    k2 = sqrtM / S * torch.sign(m_sign + 0.5)
    k3 = (-a + l / (1.0 - m2) + a / D * (r2 + a2 - a * l)) / S
    return torch.stack([k0, k1, k2, k3], -1), valid


def photon_momentum(a, r, m, l, q, r_sign, m_sign):
    """Photon 4-momentum k^mu with k.k=0 from motion constants (l, q).

    Invalid (R<0 or M<0 beyond tolerance) rays give NaN components, matching
    the reference's masking policy.  sqrt is taken on sanitized positive
    values, as in the JAX package.  Dtype and device follow the inputs.
    The tolerance is the reference's 1e-8 in f64; in f32 it is 8 ulps of
    the potentials' largest terms (`_snap_tolerances`), where the JAX
    package keeps 1e-8 and loses f32 rays at radial turning points and in
    the far field (1.3% of the solid angle of a = 0.9, 75 deg at example
    08's resolution).
    (sim5kerr.c:1151-1213; Li+05 eq. A2-A3)
    """
    a, r, m, l, q, r_sign, m_sign = _as_tensors(a, r, m, l, q, r_sign, m_sign)
    a2 = a * a
    l2 = l * l
    r2 = r * r
    m2 = m * m
    S = r2 + a2 * m2
    D = r2 - 2.0 * r + a2
    R = (r2 + a2 - a * l) ** 2 - D * ((l - a) ** 2 + q)
    M = q - l2 * m2 / (1.0 - m2) + a2 * m2
    # snap small negatives (reference: 1e-8 tolerance; in f32, the
    # rounding of R's and M's terms)
    tol_R, tol_M = _snap_tolerances(a2, l2, m2, D, r2, a * l, l - a, q)
    R = torch.where((R < 0.0) & (R > -tol_R), 0.0, R)
    M = torch.where((M < 0.0) & (M > -tol_M), 0.0, M)
    bad = (R < 0.0) | (M < 0.0)
    sqrtR = torch.where(R > 0.0, torch.sqrt(torch.where(R > 0.0, R, 1.0)), 0.0)
    sqrtM = torch.where(M > 0.0, torch.sqrt(torch.where(M > 0.0, M, 1.0)), 0.0)
    nanv = torch.where(bad, torch.nan, 0.0)
    k0 = (-a * (a * (1.0 - m2) - l) + (r2 + a2) / D * (r2 + a2 - a * l)) / S + nanv
    k1 = sqrtR / S * torch.sign(r_sign + 0.5) + nanv
    k2 = sqrtM / S * torch.sign(m_sign + 0.5) + nanv
    k3 = (-a + l / (1.0 - m2) + a / D * (r2 + a2 - a * l)) / S + nanv
    return torch.stack([k0, k1, k2, k3], -1)


def photon_motion_constants(a, r, m, k):
    """Motion constants (lambda, Q) of a null geodesic from momentum k.

    (sim5kerr.c:1217-1250)
    """
    a, r, m = _as_tensors(a, r, m)
    k = torch.as_tensor(k, dtype=r.dtype, device=r.device)
    a2 = a * a
    r2 = r * r
    s2 = 1.0 - m * m
    D = r2 - 2.0 * r + a2
    nf = k[..., 3] / k[..., 0]
    nh = (k[..., 2] ** 2) / (k[..., 0] ** 2)
    l = ((-a * a2 + a2 * a2 * nf + nf * r2 * r2 + a * (D - r2)
          + a2 * nf * (2.0 * r2 - D * s2)) * s2
         / (D - a * s2 * (a - a2 * nf + nf * (D - r2))))
    q = ((a * (l - a * s2) + ((a2 + r2) * (a2 - a * l + r2)) / D) ** 2
         * (nh - ((D * m) ** 2 * (l * l - a2 * s2))
            / (-s2 * (a2 * a2 - a * a2 * l + r2 * r2 + a * l * (D - r2)
                      + a2 * (2.0 * r2 - D * s2)) ** 2)))
    return l, q


def fourvelocity_zamo(metric: Metric):
    """4-velocity of a ZAMO observer.  (sim5kerr.c:1279-1291)"""
    g = metric
    U0 = torch.sqrt(g.g33 / (g.g03 ** 2 - g.g33 * g.g00))
    z = torch.zeros_like(U0)
    return torch.stack([U0, z, z, -U0 * g.g03 / g.g33], -1)


def fourvelocity_azimuthal(Omega, metric: Metric):
    """4-velocity of an azimuthally rotating observer.  (sim5kerr.c:1296-1309)"""
    g = metric
    U0 = torch.sqrt(-1.0 / (g.g00 + 2.0 * Omega * g.g03 + Omega ** 2 * g.g33))
    z = torch.zeros_like(U0)
    return torch.stack(torch.broadcast_tensors(U0, z, z, U0 * Omega), -1)


def fourvelocity_radial(vr, metric: Metric):
    """4-velocity of a radially moving observer.  (sim5kerr.c:1314-1327)"""
    g = metric
    U0 = torch.sqrt((-1.0 - vr ** 2 * g.g11) / g.g00)
    z = torch.zeros_like(U0)
    vr = torch.as_tensor(vr, dtype=U0.dtype, device=U0.device)
    return torch.stack([U0, vr.expand(U0.shape), z, z], -1)


def fourvelocity(U1, U2, U3, metric: Metric):
    """4-velocity (U^t, U1, U2, U3) from proper-velocity components
    Ui = dx^i/dtau; U^t solves the unit-norm condition U.U = -1.

    As in the JAX package (a deviation from sim5kerr.c:1342-1353, which
    divides every component by U^t and so loses the unit norm).
    """
    g = metric
    D = ((g.g03 * U3) ** 2 - g.g00 * g.g11 * U1 ** 2 - g.g00 * g.g22 * U2 ** 2
         - g.g00 * g.g33 * U3 ** 2 - g.g00)
    N = (-g.g03 * U3 - torch.sqrt(D)) / g.g00
    return torch.stack(torch.broadcast_tensors(N, U1 + 0.0 * N, U2 + 0.0 * N,
                                               U3 + 0.0 * N), -1)
