"""Orthonormal tetrads of various observers and frame transforms.  Port of
`sim5_tpu/core/tetrads.py`.

A tetrad is a `Tetrad` dataclass holding the basis e[(a)]^mu as a (..., 4, 4)
tensor (first index = tetrad vector, second = coordinate component) plus
the metric at the point.  (reference: sim5kerr.c:629-970)
"""

import dataclasses

import torch

from .metric import Metric, _on, dotprod, vector_covariant, vector_norm_to


@dataclasses.dataclass(frozen=True)
class Tetrad:
    e: torch.Tensor      # (..., 4, 4) basis vectors e[(a)]^mu
    metric: Metric


def tetrad_general(metric: Metric, U):
    """Tetrad of an observer with general 4-velocity U (Kulkarni+11,
    Dexter16 eq. 36-43).  (sim5kerr.c:630-673)

    e3 is the JAX package's corrected phi-vector (u_phi, 0, 0, -u_t)/N3,
    orthogonal to U, not the reference's (-u_t, 0, 0, +u_phi)/N3
    (sim5kerr.c:667-670).
    """
    U = _on(U, metric)
    u = vector_covariant(U, metric)
    u0U0_u3U3 = u[..., 0] * U[..., 0] + u[..., 3] * U[..., 3]
    one_u2U2 = 1.0 + u[..., 2] * U[..., 2]
    D = metric.r ** 2 - 2.0 * metric.r + metric.a ** 2
    N1 = torch.sqrt(-metric.g11 * u0U0_u3U3 * one_u2U2)
    N2 = torch.sqrt(metric.g22 * one_u2U2)
    N3 = torch.sqrt(-u0U0_u3U3 * D * (1.0 - metric.m ** 2))
    z = torch.zeros_like(N1)
    e0 = U.expand(N1.shape + (4,))
    e1 = torch.stack([u[..., 1] * U[..., 0] / N1, -u0U0_u3U3 / N1, z,
                      u[..., 1] * U[..., 3] / N1], -1)
    e2 = torch.stack([u[..., 2] * U[..., 0] / N2, u[..., 2] * U[..., 0] / N1,
                      one_u2U2 / N2, u[..., 2] * U[..., 3] / N2], -1)
    e3 = torch.stack([u[..., 3] / N3, z, z, -u[..., 0] / N3], -1)
    return Tetrad(torch.stack([e0, e1, e2, e3], -2), metric)


def tetrad_zamo(metric: Metric):
    """Tetrad of a zero-angular-momentum observer.  (sim5kerr.c:678-710)"""
    g = metric
    z = torch.zeros_like(g.g00)
    e00 = torch.sqrt(g.g33 / (g.g03 ** 2 - g.g33 * g.g00))
    e0 = torch.stack([e00, z, z, -e00 * g.g03 / g.g33], -1)
    e1 = torch.stack([z, 1.0 / torch.sqrt(g.g11), z, z], -1)
    e2 = torch.stack([z, z, -1.0 / torch.sqrt(g.g22), z], -1)
    e3 = torch.stack([z, z, z, 1.0 / torch.sqrt(g.g33)], -1)
    return Tetrad(torch.stack([e0, e1, e2, e3], -2), metric)


def tetrad_radial(metric: Metric, v_r):
    """Tetrad of a purely radially moving observer.  (sim5kerr.c:715-761)"""
    g = metric
    v_r = _on(v_r, g)
    zero_v = v_r == 0.0
    v_safe = torch.where(zero_v, 1e-30, v_r)
    z = torch.zeros_like(g.g00)
    U0 = torch.sqrt((-1.0 - v_safe ** 2 * g.g11) / g.g00)
    U1 = v_safe.expand(U0.shape)
    e0 = torch.stack([U0, U1, z, z], -1)
    UG = U0 * U0 * g.g00 + U1 * U1 * g.g11
    sq = torch.sqrt(UG * g.g11 * g.g00)
    e1 = torch.stack([-U1 * sq * U0 / (g.g11 * UG) * g.g11 / (U0 * g.g00),
                      sq * U0 / (g.g11 * UG), z, z], -1)
    e2 = torch.stack([z, z, -1.0 / torch.sqrt(g.g22), z], -1)
    e3 = torch.stack([z, z, z, 1.0 / torch.sqrt(g.g33)], -1)
    e = torch.stack([e0, e1, e2, e3], -2)
    return Tetrad(torch.where(zero_v[..., None, None], tetrad_zamo(g).e, e),
                  metric)


def tetrad_azimuthal(metric: Metric, Omega):
    """Tetrad of an azimuthally rotating observer.  (sim5kerr.c:766-813)"""
    g = metric
    Omega = _on(Omega, g)
    zero_O = Omega == 0.0
    O = torch.where(zero_O, 1e-30, Omega)
    z = torch.zeros_like(g.g00)
    U0 = torch.sqrt(-1.0 / (g.g00 + 2.0 * O * g.g03 + O ** 2 * g.g33))
    U3 = U0 * O
    e0 = torch.stack([U0, z, z, U3], -1)
    e1 = torch.stack([z, torch.sqrt(1.0 / g.g11), z, z], -1)
    e2 = torch.stack([z, z, -torch.sqrt(1.0 / g.g22), z], -1)
    k1 = g.g03 * U3 + g.g00 * U0
    k2 = g.g33 * U3 + g.g03 * U0
    e30 = -torch.sign(k1) * k2 / torch.sqrt(
        (g.g33 * g.g00 - g.g03 ** 2)
        * (g.g00 * U0 ** 2 + g.g33 * U3 ** 2 + 2.0 * g.g03 * U0 * U3))
    e3 = torch.stack([e30, z, z, e30 * (-k1 / k2)], -1)
    e = torch.stack([e0, e1, e2, e3], -2)
    return Tetrad(torch.where(zero_O[..., None, None], tetrad_zamo(g).e, e),
                  metric)


def tetrad_surface(metric: Metric, Omega, V, dhdr):
    """Tetrad of an observer moving along an axisymmetric surface with
    angular velocity Omega and radial drift V (measured in the corotating
    frame); dhdr = dH/dR gives the local surface orientation.  Sadowski+2011
    App. A.  (sim5kerr.c:818-921)"""
    g = metric
    Omega, V, dhdr = (_on(v, g) for v in (Omega, V, dhdr))
    z = torch.zeros_like(g.g00)
    one = torch.ones_like(g.g00)
    # zero-radial-velocity surface tangent S0 in the [r, theta] plane
    S0r = 1.0 / torch.sqrt(g.g11 + g.g22 * dhdr ** 2)
    S0h = S0r * dhdr
    # Sadowski+2011 Eq. A.10, the sqrt on a guarded argument (V = 0 for
    # thin disks)
    ur = V / torch.sqrt(1.0 - V * V) / torch.sqrt(g.g11)
    varg = (((ur / S0r) ** 2
             * (-g.g00 - 2.0 * Omega * g.g03 - Omega ** 2 * g.g33))
            / (1.0 + (ur / S0r) ** 2))
    v = torch.sign(V) * torch.where(
        varg > 0.0, torch.sqrt(torch.where(varg > 0.0, varg, 1.0)), 0.0)
    # observer 4-velocity U ~ eta + Omega xi + v S0 (Eq. A.5)
    e0 = vector_norm_to(torch.stack([one, v * S0r, v * S0h,
                                     Omega.expand(one.shape)], -1),
                        -1.0, metric)
    # surface tangent S (Eq. A.12)
    e1 = vector_norm_to(torch.stack([
        v * e0[..., 0],
        v * e0[..., 1] + S0r / e0[..., 0],
        v * e0[..., 2] + S0h / e0[..., 0],
        v * e0[..., 3]], -1), 1.0, metric)
    # surface normal N (Eq. A.3)
    e2 = vector_norm_to(torch.stack([z, dhdr.expand(z.shape), -one, z], -1),
                        1.0, metric)
    # remaining [t, phi] space-like vector K with K.U = 0 (Eq. A.8)
    e3 = vector_norm_to(torch.stack([
        -(g.g03 + g.g33 * Omega) / (g.g00 + g.g03 * Omega), z, z, one], -1),
        1.0, metric)
    return Tetrad(torch.stack([e0, e1, e2, e3], -2), metric)


def tetrad_valid(t: Tetrad, tol=1e-8):
    """Validity mask for a tetrad: e0 is unit-timelike and all components
    finite (`vector_norm_to` leaves a vector of the wrong causal character
    unscaled, e.g. a superluminal Omega inside the ergosphere)."""
    u2 = dotprod(t.e[..., 0, :], t.e[..., 0, :], t.metric)
    return torch.isfinite(t.e).all(-1).all(-1) & ((u2 + 1.0).abs() < tol)


def bl2on(Vin, tetrad: Tetrad):
    """Coordinate (BL) -> local orthonormal frame: V^(a) = eta^ab e_(b).V.

    (sim5kerr.c:925-944)
    """
    Vin = _on(Vin, tetrad.metric)
    d = [dotprod(tetrad.e[..., i, :], Vin, tetrad.metric) for i in range(4)]
    return torch.stack([-d[0], d[1], d[2], d[3]], -1)


def on2bl(Vin, tetrad: Tetrad):
    """Local orthonormal -> coordinate (BL) frame: V^mu = V^(a) e_(a)^mu.

    (sim5kerr.c:948-970)
    """
    return torch.einsum('...a,...am->...m', _on(Vin, tetrad.metric),
                        tetrad.e)
