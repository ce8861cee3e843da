"""Walker-Penrose polarization transport.

Port of `sim5_tpu/polarization`.  The WP constant kappa = K1 + i K2 is
conserved along Kerr null geodesics; knowing it, the polarization vector
can be reconstructed anywhere, at infinity included.  Complex values are
carried as explicit (re, im) pairs.  Dtype and device follow the inputs.

(reference: sim5polarization.c)
"""

import math

import torch

from ..core.metric import Metric, _as_tensors, _on, vector_norm_to


def polarization_constant(k, f, metric: Metric):
    """Walker-Penrose constant (K1, K2) of a null geodesic from momentum k
    and polarization vector f (f.k = 0).

    Connors, Piran & Stark (1980) / Dexter (2016) eq. 3 convention.
    (reference: polarization_constant, sim5polarization.c:144-215)
    """
    k, f = _on(k, metric), _on(f, metric)
    a, m, r = metric.a, metric.m, metric.r
    s2 = 1.0 - m * m
    A1 = ((k[..., 0] * f[..., 1] - k[..., 1] * f[..., 0])
          + a * s2 * (k[..., 1] * f[..., 3] - k[..., 3] * f[..., 1]))
    A2 = torch.sqrt(s2) * ((r * r + a * a) * (k[..., 3] * f[..., 2]
                                              - k[..., 2] * f[..., 3])
                           - a * (k[..., 0] * f[..., 2] - k[..., 2] * f[..., 0]))
    wp1 = r * A1 - a * m * A2
    wp2 = -r * A2 - a * m * A1
    return wp1, wp2


def polarization_vector(k, wp1, wp2, metric: Metric):
    """Reconstruct the polarization vector f (f.k = 0, f.f = 1, f[0] = 0)
    from the WP constant at the local point.

    (reference: polarization_vector, sim5polarization.c:13-105)
    """
    k, wp1, wp2 = _on(k, metric), _on(wp1, metric), _on(wp2, metric)
    a, m, r = metric.a, metric.m, metric.r
    s = torch.sqrt(torch.clamp(1.0 - m * m, min=1e-24))
    m = torch.where(1.0 - m * m < 1e-24, 1.0 - 0.5 * s, m)
    r2, a2 = r * r, a * a
    s2 = s * s
    ra2 = r2 + a2

    A1 = (r * wp1 - a * m * wp2) / (r2 + a2 * m * m)
    A2 = (-r * wp2 - a * m * wp1) / (r2 + a2 * m * m)

    k0, k1, k2, k3 = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    g11, g22, g33, g03 = metric.g11, metric.g22, metric.g33, metric.g03

    f3 = ((g11 * A1 * k1 * (s * r2 * k3 + s * a2 * k3 - s * a * k0)
           + g22 * A2 * k2 * (k0 - a * s2 * k3))
          / (k0 ** 2 * g33 * (s * k3 * a)
             + k0 ** 2 * g03 * (s * k0 * a - s * r2 * k3 - s * a2 * k3 - a2 * s * s2 * k3)
             + k1 ** 2 * g11 * a * s * s2 * (r2 * k3 + a2 * k3 - a * k0)
             + k2 ** 2 * g22 * (a2 * a * s * s2 * k3 + r2 * a * s * s2 * k3
                                - s * r2 * k0 - s * a2 * k0)
             + k3 ** 2 * g33 * s * (k3 * a * s2 * r2 + k3 * a2 * a * s2
                                    - k0 * r2 - k0 * a2 - a2 * s2 * k0)
             + k3 ** 2 * g03 * a * s * s2 * (r2 * k0 + a2 * k0)))
    f1 = (A1 - a * s * s * k1 * f3) / (k0 - a * s * s * k3)
    f2 = (A2 + s * k2 * f3 * ra2) / (s * k3 * ra2 - s * a * k0)
    f = torch.stack(torch.broadcast_tensors(torch.zeros_like(f1), f1, f2, f3),
                    -1)
    return vector_norm_to(f, 1.0, metric)


def polarization_constant_infinity(a, alpha, beta, incl):
    """WP constant of a geodesic at infinity from its impact parameters
    (polarization along the local x / e_phi direction).

    (reference: polarization_constant_infinity, sim5polarization.c:248-268)
    """
    a, alpha, beta, incl = _as_tensors(a, alpha, beta, incl)
    gamma = -alpha - a * torch.sin(incl)
    return -gamma, -beta


def polarization_angle_rotation(a, inc, alpha, beta, wp1, wp2):
    """Rotation angle of the polarization plane between the emission point
    and the observer at infinity, in (-pi, pi].

    (reference: polarization_angle_rotation, sim5polarization.c:271-285)
    """
    a, inc, alpha, beta, wp1, wp2 = _as_tensors(a, inc, alpha, beta, wp1, wp2)
    S = -alpha - a * torch.sin(inc)
    T = beta
    X = (-S * wp2 - T * wp1) / (S * S + T * T)
    Y = (-S * wp1 + T * wp2) / (S * S + T * T)
    return torch.arctan2(Y, X)


def stokes_poldeg(i, q, u, v=0.0):
    """Degree of polarization from Stokes parameters (0 where i <= 0)."""
    i, q, u = _as_tensors(i, q, u)
    return torch.where(i > 0.0, torch.sqrt(q * q + u * u)
                       / torch.where(i > 0, i, 1.0), 0.0)


def stokes_polang(i, q, u):
    """Polarization angle chi in [0, pi) from Stokes parameters (floor
    modulo, as jnp.mod)."""
    i, q, u = _as_tensors(i, q, u)
    isafe = torch.where(i > 0, i, 1.0)
    ang = torch.where(i > 0.0, 0.5 * torch.arctan2(u / isafe, q / isafe), 0.0)
    return torch.remainder(ang, math.pi)
