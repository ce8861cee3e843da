"""High-level disk raytracing driver (images, spectra, surface solving).

Port of `sim5_tpu/render/driver.py`, the batched equivalent of the
reference application layer (python/sim5diskraytrace.py): the local-frame
helpers and spectral models, the thick-disk surface solvers
(`find_surface`, a bracketed root-find in the position integral P, and
`find_surface_march`, the reference's step-halving march kept as its
oracle), and `DiskRaytrace`, which renders disk images and observed
spectra for any `DiskModel`.

Every pixel batch is evaluated in lockstep with the JAX package's masks:
its `lax.while_loop` / `fori_loop` become Python loops that end on one
`.any()` a trip, and each finished lane is frozen by the same
`torch.where`.  Dtype and device follow the inputs; `DiskRaytrace` builds
its rays on `device` (the card unless the caller asks for the CPU) in
`dtype`.
"""

import dataclasses
import math

import numpy as np
import torch

from .. import consts
from ..core import (kerr_metric, tetrad_surface, dotprod, Omega_from_ell,
                    r_bh, photon_momentum)
from ..core.metric import default_device
from ..disk import DiskModel
from ..geodesic import (
    geodesic_init_inf, geodesic_find_midplane_crossing,
    geodesic_position_rad, geodesic_position_pol, geodesic_P_int,
    geodesic_follow, geodesic_dm_sign, GEOD_TYPE_RR_BH,
)
from ..geodesic.analytic import _fold_pol, _theta_inv
from ..radiation import blackbody_Iv
from ..utils.log import get_logger, log_run


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


# ---------------------------------------------------------------------------
# thick-disk surface intersection
# ---------------------------------------------------------------------------

def _start_radius(g, disk):
    """The far start radius of the surface solvers: at least 200, beyond
    1.1 rp, and beyond the disk's opening angle along the line of sight."""
    disk_theta = torch.arctan(disk.h(g.a.new_tensor(1e6)) / 1e6)
    return torch.maximum(
        torch.clamp(1.1 * g.rp, min=200.0),
        0.5 * torch.sqrt(g.alpha ** 2 + g.beta ** 2)
        / torch.cos(g.incl + disk_theta))


def find_surface_march(g, disk: DiskModel, accuracy=1e-2, max_steps=512):
    """Reference-parity surface intersection by step-halving march along
    the analytic solution: the batched equivalent of the reference's
    DiskRaytrace.__find_surface (sim5diskraytrace.py:257-336), kept as the
    oracle of `find_surface` (it reproduces the reference's march
    endpoints to machine precision).

    Returns (P, r, m, ok).  One batched iteration a step while any ray is
    still marching (typical batches finish in 30-80 steps); the
    equatorial-plane shortcut target is loop-invariant and hoisted.  Not
    differentiable.
    """
    r0 = _start_radius(g, disk)

    # expand r0 (x2) until the start point lies above the surface
    for _ in range(16):
        P1 = geodesic_P_int(g, r0, 0)
        r1 = geodesic_position_rad(g, P1)
        m1 = geodesic_position_pol(g, P1)
        Hd = disk.h(r1 * torch.sqrt(1.0 - m1 ** 2))
        expand = (Hd >= r1 * m1) & (r0 < 5e6) & torch.isfinite(P1)
        if not bool(expand.any()):
            break
        r0 = torch.where(expand, 2.0 * r0, r0)
    P = geodesic_P_int(g, r0, 0)
    r = geodesic_position_rad(g, P)
    m = geodesic_position_pol(g, P)
    Hd = disk.h(r * torch.sqrt(1.0 - m ** 2))
    alive = (Hd < r * m) & torch.isfinite(P) & (g.status == 0)

    # the equatorial-plane shortcut target
    P_eq = geodesic_find_midplane_crossing(g, 0)
    P_eq_z = torch.where(torch.isfinite(P_eq), P_eq, 1.0)
    r_eq = geodesic_position_rad(g, P_eq_z)
    m_eq = geodesic_position_pol(g, P_eq_z)
    eq_ok = torch.isfinite(P_eq) & torch.isfinite(r_eq)

    r = torch.where(alive, r, 10.0)
    m = torch.where(alive, m, 0.5)
    sf = torch.ones_like(r)
    done = torch.zeros_like(alive)
    r_stop = 1.05 * r_bh(g.a)
    for _ in range(max_steps):
        upd = alive & ~done
        if not bool(upd.any()):
            break
        R = r * torch.sqrt(1.0 - m ** 2)
        H = r * m
        Hd = disk.h(R)
        step = torch.clamp(
            torch.minimum((H - Hd) / 2.0,
                          0.5 * (torch.sqrt(torch.clamp(r, min=1.0)) - 0.99)
                          * sf),
            min=accuracy / 2.0)
        # a frozen lane's step is discarded below: give it 0, so that the
        # follower's substeps stop with the live lanes.  Forward and
        # revert steps are <= 0.5 (sqrt(r) - 0.99) sf, i.e. <= 10 substeps
        # under the 5e-2 sqrt(r) clamp; 12 leaves margin
        step = torch.where(upd, step, 0.0)
        Pn, rn, mn, stat = geodesic_follow(g, step, P, r, m, max_substeps=12)
        Rn = rn * torch.sqrt(1.0 - mn ** 2)
        crossed = (rn * mn <= disk.h(Rn)) & upd
        # surface hit at fine resolution -> step back half and stop;
        # crossed but coarse -> revert the step, reduce the step factor
        fine = crossed & (step < accuracy)
        # the equatorial-plane shortcut (thin outer region)
        eqhit = ((rn * mn).abs() < 1e-4) & upd & ~crossed & eq_ok
        P_out = torch.where(eqhit, P_eq_z, Pn)
        r_out = torch.where(eqhit, r_eq, rn)
        m_out = torch.where(eqhit, m_eq, mn)
        # The JAX package computes both back-steps on every lane and
        # selects them only where `crossed` / `fine`: skipping them when
        # no lane needs them is exact.  The fine back-step (step <
        # accuracy) fits one substep of the 5e-2 sqrt(r) clamp, so 2
        # substeps are exact there
        if bool(crossed.any()):
            Pc, rc_, mc, _ = geodesic_follow(g, -step, Pn, rn, mn,
                                             max_substeps=12)
            P_out = torch.where(crossed, Pc, P_out)
            r_out = torch.where(crossed, rc_, r_out)
            m_out = torch.where(crossed, mc, m_out)
            if bool(fine.any()):
                Pb, rb, mb, _ = geodesic_follow(g, -step / 2.0, Pn, rn, mn,
                                                max_substeps=2)
                P_out = torch.where(fine, Pb, P_out)
                r_out = torch.where(fine, rb, r_out)
                m_out = torch.where(fine, mb, m_out)
        fail = upd & ((stat == 0) | (rn < r_stop) | (mn < 0.0))
        sf = torch.where(crossed & ~fine, sf / 5.0, sf)
        done_n = done | fine | eqhit
        P = torch.where(upd, P_out, P)
        r = torch.where(upd, r_out, r)
        m = torch.where(upd, m_out, m)
        alive = torch.where(upd, alive & ~fail & ~done_n, alive)
        done = torch.where(upd, done_n, done)
    return P, r, m, done


def _geodesic_probe_axis(g):
    """Append a probe axis to every per-ray field of a Geodesic (the
    (..., 4) root fields keep their root axis last), so the position
    functions evaluate a (..., N) batch of P values a ray."""
    nd = g.a.ndim

    def ex(v):
        if v is None:
            return None
        return v[..., None, :] if v.ndim == nd + 1 else v[..., None]

    return g._replace(**{f.name: ex(getattr(g, f.name))
                         for f in dataclasses.fields(g)})


def _surface_resid(g, disk, P, qpos=False):
    """Photosphere residual f(P) = H(P) - h(R(P)) along the geodesic, with
    (r, m) returned for reuse.  NaN-safe: an invalid P evaluates the
    residual at a dummy value (masked by callers).

    qpos=True skips the vortical (q < 0) poloidal branch, one of the three
    elliptic inversions an evaluation: valid inside find_surface, whose
    bracket requires an equatorial crossing (q > 0 by construction).
    """
    r = geodesic_position_rad(g, P)
    if qpos:
        Pz = torch.where(torch.isfinite(P), P, 0.0)
        sign_dm, dT = _fold_pol(g, Pz)
        m = -sign_dm * _theta_inv(g, dT)
        m = torch.where(torch.isfinite(P), m, torch.nan)
    else:
        m = geodesic_position_pol(g, P)
    bad = ~torch.isfinite(r) | ~torch.isfinite(m)
    r_s = torch.where(bad, 10.0, r)
    m_s = torch.where(bad, 0.5, m)
    R = r_s * torch.sqrt(torch.clamp(1.0 - m_s * m_s, 1e-12, 1.0))
    f = r_s * m_s - disk.h(R)
    return torch.where(bad, -1.0, f), r_s, m_s, bad


def _detached(g):
    """`g` with every tensor field detached (JAX's stop_gradient over the
    pytree)."""
    return g._replace(**{f.name: getattr(g, f.name).detach()
                         for f in dataclasses.fields(g)
                         if getattr(g, f.name) is not None})


def find_surface(g, disk: DiskModel, n_scan=24):
    """First intersection of each geodesic with the disk photosphere
    H = disk.h(R), as a bracketed root-find in the position integral P.

    The analytic engine makes the surface hit a root of the scalar
    residual f(P) = H(P) - h(R(P)) on a bracket the ray's first equatorial
    crossing supplies: f > 0 at the far start point and f <= 0 at P_eq,
    where H = 0 <= h.  A sweep of n_scan probes (one batched inversion of
    shape (..., n_scan)) finds the first sign change; a fixed-depth
    bisection (24 steps in f64, 16 in f32) refines it; a Newton polish
    with the closed-form derivative

        df/dP = m dr/dP + r dm/dP - h'(R) dR/dP,
        dr/dP = +-sqrt(R(r)),   dm/dP = +-sqrt(Theta(m))

    sharpens the root and attaches the implicit-function gradient: the
    bracket is found on the detached geodesic, so d(surface)/d(spin, disk
    parameters) flows through the Newton correction only, which is the
    implicit-function rule at f ~ 0.

    Returns (P, r, m, ok).  Rays whose first equatorial crossing does not
    exist (vortical q < 0, or a crossing beyond the domain) are ok=False.
    """
    gs = _detached(g)
    r0 = _start_radius(gs, disk)

    # expand r0 (x2) until the start point lies above the surface
    for _ in range(16):
        P = geodesic_P_int(gs, r0, 0)
        f, _, _, bad = _surface_resid(gs, disk, P, qpos=True)
        expand = ~((f > 0.0) & ~bad & torch.isfinite(P)) & (r0 < 5e6)
        if not bool(expand.any()):
            break
        r0 = torch.where(expand, 2.0 * r0, r0)
    P0 = geodesic_P_int(gs, r0, 0)
    f0, _, _, bad0 = _surface_resid(gs, disk, P0, qpos=True)
    P_eq = geodesic_find_midplane_crossing(gs, 0)
    alive = ((f0 > 0.0) & ~bad0 & torch.isfinite(P0) & (gs.status == 0)
             & torch.isfinite(P_eq))

    P0z = torch.where(alive, P0, 0.4)
    P1z = torch.where(alive & (P_eq > P0z), P_eq, P0z + 0.1)

    # coarse scan: one batched inversion over (..., n_scan) probes
    t = (torch.arange(n_scan, dtype=P0z.dtype, device=P0z.device)
         + 1.0) / n_scan
    Ps = P0z[..., None] + (P1z - P0z)[..., None] * t
    fs, _, _, _ = _surface_resid(_geodesic_probe_axis(gs), disk, Ps,
                                 qpos=True)
    neg = fs <= 0.0
    crossed = neg.any(-1)
    idx = torch.argmax(neg.to(torch.uint8), -1)  # first probe at/past it
    P_hi = torch.gather(Ps, -1, idx[..., None])[..., 0]
    P_prev = torch.gather(Ps, -1, torch.clamp(idx - 1, min=0)[..., None])[
        ..., 0]
    P_lo = torch.where(idx == 0, P0z, P_prev)

    # fixed-depth bisection down to the Newton basin (~1e-5 bracket
    # width); the quadratic Newton step below reaches the working
    # precision's noise floor from there
    depth = 24 if P_lo.dtype == torch.float64 else 16
    for _ in range(depth):
        mid = 0.5 * (P_lo + P_hi)
        fm, _, _, _ = _surface_resid(gs, disk, mid, qpos=True)
        pos = fm > 0.0
        P_lo, P_hi = torch.where(pos, mid, P_lo), torch.where(pos, P_hi, mid)
    P_b = (0.5 * (P_lo + P_hi)).detach()

    # Newton polish at the converged root on the differentiable geodesic:
    # the implicit-function gradient dP*/dtheta = -f_theta / f_P
    f_b, r_b, m_b, _ = _surface_resid(g, disk, P_b, qpos=True)
    a2 = g.a * g.a
    R_pot = (r_b ** 4 + (a2 - g.l ** 2 - g.q) * r_b ** 2
             + 2.0 * (g.q + (g.l - g.a) ** 2) * r_b - a2 * g.q)
    M_pot = g.q + (a2 - g.l ** 2 - g.q) * m_b ** 2 - a2 * m_b ** 4
    # radial direction: inward (-) before the turning point at P = Rpc,
    # outward (+) after; RR_BH bound bands run opposite
    rsign = (torch.where(P_b < g.Rpc, -1.0, 1.0)
             * torch.where(g.gtype == GEOD_TYPE_RR_BH, -1.0, 1.0))
    drdP = rsign * torch.sqrt(torch.clamp(R_pot, min=0.0))
    dmdP = geodesic_dm_sign(g, P_b) * torch.sqrt(torch.clamp(M_pot, min=0.0))
    dmdP = torch.where(torch.isfinite(dmdP), dmdP, 0.0)
    s1m = torch.sqrt(torch.clamp(1.0 - m_b * m_b, 1e-12, 1.0))
    R_b = r_b * s1m
    dRdP = s1m * drdP - r_b * m_b / s1m * dmdP
    dfdP = (m_b * drdP + r_b * dmdP - disk.dhdr(R_b) * dRdP).detach()
    dfdP = torch.where(dfdP.abs() > 1e-12, dfdP, -1e-12)
    P_star = P_b - f_b / dfdP

    r_star = geodesic_position_rad(g, P_star)
    m_star = geodesic_position_pol(g, P_star)
    ok = (alive & crossed & torch.isfinite(P_star) & torch.isfinite(r_star)
          & torch.isfinite(m_star)
          & (r_star.detach() > 1.05 * r_bh(gs.a)))
    P_out = torch.where(ok, P_star,
                        torch.where(torch.isfinite(P_star), P_star, 1.0))
    r_out = torch.where(ok, r_star, 10.0)
    m_out = torch.where(ok, m_star, 0.5)
    return P_out, r_out, m_out, ok


def _ray_block(alpha, beta, dOmega, mesh):
    """This rank's block of a batch of rays (numpy): the batch padded to a
    multiple of the mesh's size with its last ray at zero weight (dOmega
    = 0), cut into equal blocks in rank order."""
    from ..parallel.mesh import check_mesh
    size, rank = check_mesh(mesh).size(), mesh.get_local_rank()
    block = -(-len(alpha) // size)
    pad = block * size - len(alpha)
    if pad:
        alpha = np.concatenate([alpha, np.full(pad, alpha[-1])])
        beta = np.concatenate([beta, np.full(pad, beta[-1])])
        dOmega = np.concatenate([dOmega, np.zeros(pad)])
    sl = slice(rank * block, (rank + 1) * block)
    return alpha[sl], beta[sl], dOmega[sl]


def polar_grid(r_in, incl, radres, angres, r_max):
    """The reference spectrum driver's polar observer-plane quadrature
    (sim5diskraytrace.py:79-90), built on the host in numpy: rings from
    r_in outward with dr = radres (1 + r/5) up to 1.1 r_max, and
    floor(angres / sqrt(cos incl)) angles a ring.  Returns (alpha, beta,
    dOmega) with dOmega the solid angle of each sample for unit
    (M/D)^2."""
    radii, drs = [], []
    rx = r_in
    while rx < r_max * 1.1:
        dr = radres * (1.0 + rx / 5.0)
        radii.append(rx)
        drs.append(dr)
        rx += dr
    nphi = int(np.floor(angres / np.sqrt(np.cos(incl))))
    dphi = 2.0 * np.pi / nphi
    rx = np.repeat(radii, nphi)
    drx = np.repeat(drs, nphi)
    phi = np.tile(np.arange(nphi) * dphi, len(radii))
    return (-rx * np.cos(phi), -rx * np.sin(phi) * np.cos(incl),
            np.cos(incl) * (rx + drx / 2.0) * drx * dphi)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DiskRaytrace:
    """Raytracing from a disk photosphere to an observer at infinity.

    Rays are built on `device` (None: the card) in `dtype` (float64, or
    float32 for the fast mode; this replaces the JAX package's x64
    switch); the disk's tensors should sit on the same device.  `image`
    and `spectrum` take a `mesh` (`parallel.make_mesh`): each rank of it
    then traces its share of the rows or rays on its own device, which
    should be this one.
    (reference: DiskRaytrace, python/sim5diskraytrace.py:16-462)
    """
    bh_mass: float
    bh_spin: float
    bh_dist: float              # [kpc]
    disk: DiskModel
    spectra: DiskSpectrum
    r_max: float = 1e6
    device: torch.device = None
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.bh_spin = max(self.bh_spin, 1e-4)
        self.device = default_device(self.device)

    def _tensor(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _is_flat(self):
        return bool(self.disk.h(self._tensor(1e5)) == 0.0)

    def geodesic(self, incl, alpha, beta, flat=None):
        """Batched pixel -> surface solver.

        Returns (r, m, g, k, ok); k is the photon momentum pointing from
        the disk outward (the reference's convention,
        sim5diskraytrace.py:250: r_sign = Rpc - P, m_sign = +1).
        """
        if flat is None:
            flat = self._is_flat()
        alpha, beta = self._tensor(alpha), self._tensor(beta)
        g = geodesic_init_inf(incl, self.bh_spin, alpha, beta)
        if flat:
            P = geodesic_find_midplane_crossing(g, 0)
            r = geodesic_position_rad(g, P)
            m = torch.zeros_like(r)
            ok = torch.isfinite(r) & (g.status == 0)
        else:
            P, r, m, ok = find_surface(g, self.disk)
        r_s = torch.where(ok, r, 10.0)
        m_s = torch.where(ok, m, 0.0)
        P_s = torch.where(ok, P, 1.0)
        k = photon_momentum(self.bh_spin, r_s, m_s, g.l, g.q,
                            g.Rpc - P_s, torch.ones_like(r_s))
        return r_s, m_s, g, k, ok

    def image(self, incl_deg, rmax, N, limbdk=1, mesh=None):
        """Disk image: flux, g-factor, emission angle, T, R, H, vr maps,
        each (N, N) with beta along rows and alpha along columns, NaN off
        the disk.

        With `mesh` (a 1-D DeviceMesh, `parallel.make_mesh`), the grid's
        rows are padded with the last row to a multiple of the mesh's
        size, each rank solves and shades its block of rows, and one
        all-gather gives every rank the whole maps, the pad dropped.

        (reference: DiskRaytrace.image, sim5diskraytrace.py:138-210, a
        per-pixel Python loop)
        """
        incl = math.radians(max(1.0, incl_deg))
        dOmega = (2.0 * rmax / N) ** 2 / (
            (self.bh_mass * consts.grav_radius)
            / (self.bh_dist * consts.parsec * 1e3)) ** 2
        xs = ((torch.arange(N, dtype=self.dtype, device=self.device) + 0.5)
              / N - 0.5) * 2.0 * rmax
        alpha, beta = torch.meshgrid(xs, xs, indexing="xy")
        if mesh is not None:
            from ..parallel.mesh import shard_image_rows
            alpha = shard_image_rows(alpha, mesh)
            beta = shard_image_rows(beta, mesh)

        r, m, g, k, ok = self.geodesic(incl, alpha, beta)
        R = r * torch.sqrt(1.0 - m * m)
        F = self.disk.flux(R)
        T = self.disk.t_eff(R)
        V = self.disk.vr(R)
        ok = ok & (F > 0.0)

        tet = disk_tetrad(self.bh_spin, r, m, self.disk)
        gf = observed_gfactor(k, tet)
        mue = torch.clamp(emission_angle(k, tet), 1e-4, 1.0 - 1e-6)
        limb = 0.5 + 0.75 * mue if limbdk > 0 else torch.ones_like(mue)
        ok = ok & (gf > 0.0)

        z = torch.where(ok, torch.ones_like(r), torch.nan)
        maps = {
            "flux": z * F * gf ** 4 * limb * dOmega,
            "gfactor": z * gf,
            "mue": z * torch.rad2deg(torch.arccos(mue)),
            "T": z * T,
            "R": z * R,
            "H": z * r * m,
            "V": z * V,
        }
        if mesh is None:
            return maps
        from ..parallel.mesh import gather_rows
        both = gather_rows(torch.stack(list(maps.values()), 1), mesh, N)
        return {key: both[:, i].contiguous() for i, key in enumerate(maps)}

    def spectrum(self, incl_deg, energies, limbdk=1, flat=0,
                 radres=0.15, angres=90.0, hardening=0.0, batch=8192,
                 return_diagnostics=False, mesh=None):
        """Observed disk spectrum [erg/s/cm2/keV] on the detector energy
        grid, by solid-angle-weighted accumulation over a polar grid of
        the observer plane.  Returns (spec_f, spec_0), the hardened and
        unhardened spectra, as float64 tensors on the CPU.

        The grid is built on the host; batches of `batch` rays go to the
        device, and the sums stay there until the end.  With
        `return_diagnostics=True` also returns a dict with the solid-angle
        coverage error (`domega_err`, the solid angle of rays whose
        geodesic setup or surface solve failed, and `domega_tot`, the
        total): the reference's dOmega_err accumulator
        (sim5diskraytrace.py:76,93).  A warning is logged when the
        fraction exceeds 1%.

        With `mesh` (a 1-D DeviceMesh, `parallel.make_mesh`), each batch
        is padded to a multiple of the mesh's size with zero-weight rays
        (dOmega = 0), each rank traces its block of it, and one all-reduce
        at the end sums the spectra and the solid angles over the ranks.

        (reference: DiskRaytrace.spectrum, sim5diskraytrace.py:43-134, a
        per-pixel Python loop)
        """
        incl = np.radians(max(1.0, incl_deg))
        energies = self._tensor(energies)
        alpha, beta, dOmega = polar_grid(
            float(r_bh(torch.tensor(self.bh_spin, dtype=self.dtype))), incl,
            radres, angres, self.r_max)
        dOmega = dOmega * ((self.bh_mass * consts.grav_radius)
                           / (self.bh_dist * consts.parsec * 1e3)) ** 2

        is_flat = bool(flat) or self._is_flat()
        spec_f, spec_0, dom_err, dom_tot = (
            torch.zeros(n, dtype=torch.float64, device=self.device)
            for n in (len(energies), len(energies), (), ()))
        for i in range(0, len(alpha), batch):
            sl = slice(i, i + batch)
            al, be, dom = alpha[sl], beta[sl], dOmega[sl]
            if mesh is not None:
                al, be, dom = _ray_block(al, be, dom, mesh)
            dom = self._tensor(dom)
            r, m, g, k, ok = self.geodesic(incl, al, be, flat=is_flat)
            R = r * torch.sqrt(1.0 - m * m)
            T = self.disk.t_eff(R)
            ok = ok & (T > 0.0)
            tet = disk_tetrad(self.bh_spin, r, m, self.disk)
            gf = observed_gfactor(k, tet)
            mue = (emission_angle(k, tet) if limbdk > 0
                   else torch.full_like(gf, -1.0))
            ok = ok & (gf > 0.0)
            f = (torch.full_like(T, hardening) if hardening > 0
                 else spectral_hardening(T, self.disk.mdot()))
            gf_s = torch.where(ok, gf, 1.0)
            E = energies[None, :] / gf_s[:, None]
            Iv_f = self.spectra.spectrum(T, mue, f, E)
            Iv_0 = self.spectra.spectrum(T, mue, torch.ones_like(f), E)
            w = torch.where(ok, gf_s ** 3 * dom, 0.0)
            spec_f += (Iv_f * w[:, None]).sum(0)
            spec_0 += (Iv_0 * w[:, None]).sum(0)
            dom_err += torch.where(ok, 0.0, dom).sum()
            dom_tot += dom.sum()
        if mesh is not None:
            from ..parallel.mesh import all_reduce
            ne = len(energies)
            sums = all_reduce(torch.cat([spec_f, spec_0, dom_err[None],
                                         dom_tot[None]]), mesh)
            spec_f, spec_0 = sums[:ne], sums[ne:2 * ne]
            dom_err, dom_tot = sums[2 * ne], sums[2 * ne + 1]
        spec_f, spec_0 = spec_f.cpu(), spec_0.cpu()
        dom_err, dom_tot = float(dom_err), float(dom_tot)
        if dom_tot > 0.0 and dom_err / dom_tot > 0.01:
            log_run(get_logger(), "spectrum_coverage_warning",
                    domega_err=dom_err, domega_tot=dom_tot,
                    err_fraction=dom_err / dom_tot,
                    incl_deg=float(incl_deg), radres=float(radres),
                    angres=float(angres))
        if return_diagnostics:
            return spec_f, spec_0, {"domega_err": dom_err,
                                    "domega_tot": dom_tot}
        return spec_f, spec_0
