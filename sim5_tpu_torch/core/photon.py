"""Photon kinematics.  Port of `sim5_tpu/core/photon.py` (the part the
stepwise march and the analytic seed need).

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


def photon_momentum(a, r, m, l, q, r_sign, m_sign):
    """Photon 4-momentum k^mu with k.k=0 from motion constants (l, q).

    Invalid (R<0 or M<0 beyond tolerance) rays give NaN components, matching
    the reference's masking policy.  sqrt is taken on sanitized positive
    values, as in the JAX package.  Dtype and device follow the inputs.
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
    # snap small negatives (reference: 1e-8 tolerance)
    R = torch.where((R < 0.0) & (R > -1e-8), 0.0, R)
    M = torch.where((M < 0.0) & (M > -1e-8), 0.0, M)
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
