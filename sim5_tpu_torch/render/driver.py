"""Disk raytracing driver: the local-frame helpers and spectral models.

Port of the first part of `sim5_tpu/render/driver.py` (its lines
35-124): the disk-surface tetrad, the observed g-factor and emission
angle, the Zhu+12 vertical gravity, the You+15 spectral hardening, and
the blackbody spectral model.  The surface solvers (`find_surface`,
`find_surface_march`) and `DiskRaytrace` come with the thick-disk slice.
Dtype and device follow the inputs.
"""

import torch

from .. import consts
from ..core import kerr_metric, tetrad_surface, dotprod, Omega_from_ell
from ..disk import DiskModel
from ..radiation import blackbody_Iv


# ---------------------------------------------------------------------------
# local-frame helpers (sim5diskraytrace.py:340-430)
# ---------------------------------------------------------------------------

def disk_tetrad(a, r, m, disk: DiskModel):
    """Tetrad attached to the disk surface at (r, m).

    Omega_from_ell has a pole where g33 + ell g03 = 0 (deep ergosphere):
    such lanes, outside every disk's domain, get Omega = 0, as in the JAX
    package (their tetrad is discarded downstream).
    (reference: DiskRaytrace.__tetrad, sim5diskraytrace.py:340-349)
    """
    R = r * torch.sqrt(1.0 - m * m)
    metric = kerr_metric(a, r, m)
    Omega = Omega_from_ell(disk.ell(R), metric)
    Omega = torch.where(torch.isfinite(Omega) & (Omega.abs() < 1e3),
                        Omega, 0.0)
    dhdr = torch.where(m > 0.0, disk.dhdr(R), 0.0)
    return tetrad_surface(metric, Omega, disk.vr(R), dhdr)


def observed_gfactor(k, tetrad):
    """Energy shift g = k_t(infinity)/(k.U) of a photon incoming to the
    local frame (backward raytracing).  (sim5diskraytrace.py:353-362)"""
    m = tetrad.metric
    U = tetrad.e[..., 0, :]
    g = (k[..., 0] * m.g00 + k[..., 3] * m.g03) / dotprod(k, U, m)
    return torch.clamp(g, min=0.0)


def emission_angle(k, tetrad):
    """Cosine of the emission angle mu_e = (k.N)/(k.U).

    (sim5diskraytrace.py:377-401; small negatives from dH/dR imperfections
    are snapped to 1e-3 as in the reference)
    """
    m = tetrad.metric
    U = tetrad.e[..., 0, :]
    N = tetrad.e[..., 2, :]
    mue = dotprod(k, N, m) / dotprod(k, U, m)
    return torch.where((mue < 0.0) & (mue > -1e-2), 1e-3, mue)


def vertical_gravity(R, tetrad, bh_mass, bh_spin):
    """Vertical gravitational acceleration at the disk surface [s^-2]
    (Zhu+2012).  (sim5diskraytrace.py:405-414)"""
    m = tetrad.metric
    U = tetrad.e[..., 0, :]
    u_t = U[..., 0] * m.g00 + U[..., 3] * m.g03
    u_f = U[..., 0] * m.g03 + U[..., 3] * m.g33
    return (bh_mass * consts.solar_mass * consts.grav_const
            / (R * bh_mass * consts.grav_radius) ** 3
            * (u_f ** 2 + bh_spin ** 2 * (u_t - 1.0)) / R)


def spectral_hardening(T, mdot):
    """Spectral hardening factor fit (You+2015, arXiv:1506.03959).

    (sim5diskraytrace.py:418-430)
    """
    t4 = T / 1e4
    m4 = ((mdot + 0.1) / 0.2) ** 0.24
    t4s = torch.clamp(t4, min=1e-30)
    return torch.where(t4 > 10.0, 1.6 * m4,
                       torch.where(t4 > 1.0, (t4s / 3.0) ** 0.3904 * m4, m4))


# ---------------------------------------------------------------------------
# spectral models (python/sim5diskspectrum.py)
# ---------------------------------------------------------------------------

class DiskSpectrum:
    """Base spectral model protocol: spectrum(T, mu, f, E) -> Iv."""

    def spectrum(self, T, mu, f, E):
        raise NotImplementedError


class DiskSpectrum_BlackBody(DiskSpectrum):
    """Planck spectrum with hardening factor and limb darkening; 0 where
    T < 100 K.

    (reference: DiskSpectrum_BlackBody, sim5diskspectrum.py:48-88)
    """

    def spectrum(self, T, mu, f, E):
        Iv = blackbody_Iv(T[..., None], f[..., None], mu[..., None], E)
        return torch.where(T[..., None] >= 1e2, Iv, 0.0)
