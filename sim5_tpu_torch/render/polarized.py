"""Polarized disk images and spectra: Stokes I/Q/U via Walker-Penrose
transport.

Port of `sim5_tpu/render/polarized.py`.  For each pixel the polarization
plane at the disk is transported analytically to infinity through the
conserved Walker-Penrose constant; the local polarization degree is a
pluggable function of the emission angle (default: the Chandrasekhar
(1960) electron-scattering atmosphere fit).

Eager f64 torch on the disk's device.  The spectrum's sums over the image
run in another order on the card than on the CPU, so they agree to a
relative tolerance, not bit for bit.
"""

import torch

from .. import consts
from ..core import kerr_metric, photon_momentum
from ..disk import NTDisk, nt_flux
from ..disk.base import ThinDisk
from ..geodesic import (geodesic_init_inf, geodesic_find_midplane_crossing,
                        geodesic_position_rad)
from ..polarization import polarization_constant, polarization_angle_rotation
from ..radiation import blackbody_Iv
from .driver import disk_tetrad, observed_gfactor, emission_angle
from .image import image_grid


def chandrasekhar_poldeg(mu):
    """Polarization degree of a semi-infinite electron-scattering
    atmosphere vs emission cosine (Chandrasekhar 1960 table XXIV fit)."""
    return 0.1171 * (1.0 - mu) / (1.0 + 3.582 * mu)


def _disk_frame(disk: NTDisk, incl, npix_x, npix_y, rmax):
    """The steps both renderers share: each pixel's midplane crossing
    (order 0) outside the ISCO, the outward photon momentum there (the
    reference driver's convention), the disk tetrad, g-factor and emission
    cosine, and the WP rotation of the local azimuthal polarization
    vector.  Returns (hit, r_s, gf, mue, chi)."""
    a = disk.a
    rms = disk.rms - 1e-3
    alpha, beta = image_grid(npix_x, npix_y, rmax, dtype=a.dtype,
                             device=a.device)
    g = geodesic_init_inf(incl, a, alpha, beta)
    P = geodesic_find_midplane_crossing(g, 0)
    r = geodesic_position_rad(g, P)
    hit = torch.isfinite(r) & (r >= rms) & (g.status == 0)
    r_s = torch.where(hit, r, rms + 1.0)
    m_s = torch.zeros_like(r_s)
    P_s = torch.where(hit, P, 1.0)

    k = photon_momentum(a, r_s, m_s, g.l, g.q, g.Rpc - P_s,
                        torch.ones_like(r_s))
    tet = disk_tetrad(a, r_s, m_s, ThinDisk(disk))
    gf = observed_gfactor(k, tet)
    mue = torch.clamp(emission_angle(k, tet), 1e-4, 1.0)

    # electron-scattering polarization is perpendicular to the meridian
    # plane of the emitted ray: f along the local azimuthal direction (e3)
    metric = kerr_metric(a, r_s, m_s)
    wp1, wp2 = polarization_constant(k, tet.e[..., 3, :], metric)
    chi = polarization_angle_rotation(a, g.incl, alpha, beta, wp1, wp2)
    return hit, r_s, gf, mue, chi


def render_polarized_image(disk: NTDisk, incl, npix_x=256, npix_y=256,
                           rmax=None, poldeg_fn=chandrasekhar_poldeg):
    """Render Stokes (I, Q, U) maps, each (npix_y, npix_x), of an
    equatorial NT disk, on the disk's device.

    The local polarization vector lies in the disk plane perpendicular to
    the photon's projected momentum (electron-scattering polarization);
    its angle at the observer is chi0 + chi_rot where chi_rot is the
    WP-transport rotation (sim5polarization.c:271-285).
    """
    if rmax is None:
        rmax = disk.rms - 1e-3 + 12.0
    hit, r_s, gf, mue, chi = _disk_frame(disk, incl, npix_x, npix_y, rmax)

    # intensity: local flux boosted, limb-darkened
    F = nt_flux(disk, r_s)
    I = torch.where(hit, F * gf ** 4 * (0.5 + 0.75 * mue), 0.0)

    pd = poldeg_fn(mue)
    Q = torch.where(hit, I * pd * torch.cos(2.0 * chi), 0.0)
    U = torch.where(hit, I * pd * torch.sin(2.0 * chi), 0.0)
    return I, Q, U


def polarized_spectrum(disk: NTDisk, incl, energies, npix=256, rmax=None,
                       poldeg_fn=chandrasekhar_poldeg,
                       bh_mass=10.0, bh_dist=10.0, hardening=1.7):
    """Energy-resolved Stokes spectra (I_E, Q_E, U_E) [erg/s/cm2/keV] of an
    equatorial NT disk, each (n_E,) f64 on the disk's device.

    Per image-plane pixel: blackbody specific intensity at the local
    effective temperature, redshifted (I_E ~ Iv(E/g) g^3), polarized by
    poldeg_fn(mu_e) along the transported polarization plane (WP rotation
    chi), and summed over pixel solid angle.  `energies` [keV] may be
    numpy; degree = sqrt(Q^2 + U^2)/I and angle = atan2(U, Q)/2 follow.
    """
    if rmax is None:
        rmax = disk.rms - 1e-3 + 18.0
    hit, r_s, gf, mue, chi = _disk_frame(disk, incl, npix, npix, rmax)
    T = ThinDisk(disk).t_eff(r_s)
    hit = hit & (T > 100.0) & torch.isfinite(gf) & (gf > 0.0)
    gf = torch.where(hit, gf, 1.0)

    chi = torch.where(hit & torch.isfinite(chi), chi, 0.0)
    # zero-weight lanes can still carry NaN (0 * NaN = NaN in the energy
    # sums), so the polarized weights are masked explicitly
    pd = poldeg_fn(mue)
    pd = torch.where(hit & torch.isfinite(pd), pd, 0.0)

    energies = torch.as_tensor(energies, dtype=torch.float64,
                               device=T.device)
    # pixel solid angle: (2 rmax/npix)^2 rg^2 at distance D
    dOmega = ((2.0 * rmax / npix) ** 2
              * ((bh_mass * consts.grav_radius)
                 / (bh_dist * consts.parsec * 1e3)) ** 2)
    Iv = blackbody_Iv(T[..., None], torch.full_like(T, hardening)[..., None],
                      mue[..., None], energies / gf[..., None])
    w = torch.where(hit, gf ** 3, 0.0)[..., None] * dOmega
    I_E = torch.sum(Iv * w, dim=(0, 1))
    Q_E = torch.sum(Iv * w * (pd * torch.cos(2.0 * chi))[..., None], dim=(0, 1))
    U_E = torch.sum(Iv * w * (pd * torch.sin(2.0 * chi))[..., None], dim=(0, 1))
    return I_E, Q_E, U_E
