"""Photon kinematics.  Port of `sim5_tpu/core/photon.py` (the part the
stepwise march needs).

(reference: sim5kerr.c:1150-1353)
"""

from .metric import Metric


def photon_carter_const(k, metric: Metric):
    """Carter constant Q of a null geodesic.  (sim5kerr.c:1255-1268)"""
    m2 = metric.m ** 2
    kt = k[..., 0] * metric.g00 + k[..., 3] * metric.g03
    kh = k[..., 2] * metric.g22
    kf = k[..., 3] * metric.g33 + k[..., 0] * metric.g03
    return kh ** 2 + kf ** 2 * m2 / (1.0 - m2) - metric.a ** 2 * kt ** 2 * m2
