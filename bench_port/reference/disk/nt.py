"""Novikov-Thorne / Page-Thorne relativistic thin disk.

Port of `sim5_tpu/disk/nt.py`.  The disk is an immutable `NTDisk`, a
frozen dataclass of tensors, and every quantity is a batched function of
(disk, r).  Dtype and device follow the disk's tensors: an `nt_setup`
given f64 values (or Python numbers) builds the f64 parity disk, one given
f32 tensors the f32 fast-path disk.

Luminosity is a fixed-grid log-Simpson rule, and the luminosity -> mdot
inversion a fixed-depth bisection.  That bisection carries no implicit
derivative in either package: the JAX package's `nt_mdot_for_luminosity`
is a plain `fori_loop`, so the mdot it returns is a constant to autodiff
there and here.  (reference: sim5disk-nt.c)
"""

import dataclasses
import io
import math
import sys

import numpy as np
import torch

from .. import consts
from ..core import r_ms
from ..core.metric import _as_tensors
from ..special.quadrature import simpson_weights
from ..utils.fastmath import log_accurate, vlog, sqrt_df

DISK_NT_OPTION_LUMINOSITY = 1

_FIELDS = ("M", "a", "mdot", "rms", "alpha")


@dataclasses.dataclass(frozen=True)
class NTDisk:
    """Immutable NT disk parameters (the reference's static module
    state); the fields and their order are those of the JAX package's
    `NTDisk`."""
    M: torch.Tensor       # BH mass [M_sun]
    a: torch.Tensor       # BH spin
    mdot: torch.Tensor    # accretion rate [Eddington units]
    rms: torch.Tensor     # inner edge (ISCO + 1e-3) [rg]
    alpha: torch.Tensor   # viscosity parameter
    options: int = 0

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, d, device="cuda"):
        """NTDisk from a dict of numpy values (e.g. the fields of a
        `sim5_tpu` NTDisk, `disk._asdict()`), on `device` (the card unless
        the caller asks for the CPU); dtypes are kept."""
        return cls(**{f: torch.as_tensor(np.array(d[f]), device=device)
                      for f in _FIELDS}, options=int(d.get("options", 0)))

    def numpy(self):
        """The disk as a dict of numpy values (the inverse of
        `from_numpy`)."""
        out = {f: getattr(self, f).detach().cpu().numpy() for f in _FIELDS}
        out["options"] = self.options
        return out


def _r_min(a):
    """Disk inner edge = ISCO + 1e-3 (sim5disk-nt.c:91-105)."""
    return r_ms(a) + 1e-3


def _f32_quantize(x):
    """Round to float32 with a straight-through gradient.

    The reference keeps its disk state in `static float` fields
    (sim5disk-nt.c:27-32), so all its outputs see float32-rounded
    (M, a, mdot, rms, alpha).  Mirroring that is required for the <= 1e-6
    image parity gate; the straight-through form keeps gradients exact.
    The identity on f32 tensors.
    """
    q = x.to(torch.float32).to(x.dtype)
    return x + (q - x).detach()


def nt_setup(M, a, mdot_or_L, alpha, options=0, f32_state=True,
             device=None):
    """Construct an NTDisk from (M, a, mdot) or (M, a, L).

    Dtype and device follow the inputs (with no tensor among them: f64 on
    `device`, the card unless the caller asks for the CPU).
    `f32_state=True` (default) mirrors the reference's float32 state
    storage (see _f32_quantize); pass False for full-precision parameters.
    (reference: disk_nt_setup, sim5disk-nt.c:37-77)
    """
    M, a, mdot_or_L, alpha = _as_tensors(M, a, mdot_or_L, alpha,
                                         device=device)
    if f32_state:
        M, a, mdot_or_L, alpha = (
            _f32_quantize(v) for v in (M, a, mdot_or_L, alpha))
    rms = _r_min(a)
    if f32_state:
        rms = _f32_quantize(rms)
    disk = NTDisk(M, a, mdot_or_L, rms, alpha, options)
    if options & DISK_NT_OPTION_LUMINOSITY:
        mdot = nt_mdot_for_luminosity(disk, mdot_or_L)
        if f32_state:
            mdot = _f32_quantize(mdot)
        disk = disk._replace(mdot=mdot)
    return disk


def _like(r, disk):
    return torch.as_tensor(r, dtype=disk.a.dtype, device=disk.a.device)


def nt_flux(disk: NTDisk, r):
    """Local radiative flux F(r) from one side of the disk [erg cm-2 s-1],
    Page & Thorne (1974) eq. 15n.  (reference: disk_nt_flux,
    sim5disk-nt.c:110-146)

    The PT74 bracket B = f0 - f1 - f2 - f3 is evaluated in its delta form
    (see the JAX package for the derivation and the f32 measurements):
      B = delta*C1 + 1.5 a vlog(delta/x0) + sum_i c_i vlog(delta/(x0-x_i)),
    delta = sqrt(r) - sqrt(rms) as a two-float difference (sqrt_df), the
    partial-fraction weights and x0 - x_i through exact trigonometric
    identities valid at every spin, and the denominator x^3 - 3x + 2a in
    factored form.  The same function in f64 to ~1e-16.
    """
    r = _like(r, disk)
    a = disk.a
    inside = r <= disk.rms
    rs = torch.where(inside, disk.rms * 1.0001, r)
    ac = torch.arccos(torch.clamp(a, -1.0, 1.0))
    th = ac / 3.0
    x1 = 2.0 * torch.cos(th - math.pi / 3.0)
    x2 = 2.0 * torch.cos(th + math.pi / 3.0)
    x3 = -2.0 * torch.cos(th)
    s3 = math.sqrt(3.0)
    sth = torch.sin(th)
    s2th = torch.sin(2.0 * th)
    cth = torch.cos(th)
    d12x = 2.0 * s3 * sth                  # x1 - x2
    d13x = 3.0 * cth + s3 * sth            # x1 - x3
    d23x = 3.0 * cth - s3 * sth            # x2 - x3
    x1ma = sth * (s3 + 2.0 * s2th)         # x1 - a
    x3ma = x3 - a                          # never collapses (<= -1.7)
    x1ma_s = torch.where(x1ma == 0.0, 1.0, x1ma)
    x2ma = a * (1.0 - a) * (1.0 + a) / (x1ma_s * x3ma)
    x2_s = torch.where(x2 == 0.0, 1e-300, x2)
    c1_ = 3.0 * (x1ma * x1ma) / (x1 * d12x * d13x)
    c2_ = -3.0 * (x2ma * x2ma) / (x2_s * d12x * d23x)
    c3_ = 3.0 * (x3ma * x3ma) / (x3 * (x3 - x1) * (x3 - x2))
    xh, xl = sqrt_df(rs)
    x = xh
    x0h, x0l = sqrt_df(disk.rms)
    x0 = x0h
    delta = (xh - x0h) + (xl - x0l)
    rms1 = disk.rms - 1.0
    x0mx1 = (rms1 - 2.0 * sth * sth - s3 * s2th) / (x0 + x1)
    x0mx2 = (rms1 - 2.0 * sth * sth + s3 * s2th) / (x0 + x2)
    x0mx3 = x0 + 2.0 * cth
    C1 = 1.0 - 1.5 * a / x0 - c1_ / x0mx1 - c2_ / x0mx2 - c3_ / x0mx3
    B = (delta * C1 + 1.5 * a * vlog(delta / x0)
         + c1_ * vlog(delta / x0mx1)
         + c2_ * vlog(delta / x0mx2)
         + c3_ * vlog(delta / x0mx3))
    F = 1.0 / (4.0 * math.pi * rs) * 1.5 \
        / (x * x * ((x0mx1 + delta) * (x0mx2 + delta) * (x0mx3 + delta))) * B
    # normalization: F ~ mdot/m * 9.1721376255e+28 erg/cm2/s
    # (sim5disk-nt.c:137-145)
    out = 9.1721376255e+28 * F * disk.mdot / disk.M
    return torch.where(inside, 0.0, out)


def nt_temp(disk: NTDisk, r):
    """Effective temperature T_eff(r) = (F/sigma_SB)^(1/4) [K]."""
    return (torch.clamp(nt_flux(disk, r), min=0.0) / consts.sb_sigma) ** 0.25


# fixed Simpson panels (log grid; matches the adaptive reference to ~1e-7)
_LUMI_N = 2 ** 12


def nt_lumi(disk: NTDisk):
    """Total disk luminosity in Eddington units, integrating
    L = 2 * 2pi Int F(r) (-U_t) r dr over r in (rms, 1e5) by a fixed
    log-grid Simpson rule of 2^12 panels.

    (reference: disk_nt_lumi, sim5disk-nt.c:151-187)
    """
    a = disk.a
    x0 = torch.log(disk.rms)
    x1 = torch.log(torch.full_like(x0, 1e5))
    n = _LUMI_N
    ar = torch.arange(n + 1, dtype=x0.dtype, device=x0.device)
    xs = x0[..., None] + (x1 - x0)[..., None] * ar / n
    r = torch.exp(xs)
    a_ = a[..., None]
    gtt = -1.0 + 2.0 / r
    gtf = -2.0 * a_ / r
    gff = r * r + a_ * a_ + 2.0 * a_ * a_ / r
    Omega = 1.0 / (a_ + r ** 1.5)
    U_t = torch.sqrt(-1.0 / (gtt + 2.0 * Omega * gtf + Omega * Omega * gff)) \
        * (gtt + Omega * gtf)
    d1 = disk._replace(**{f: getattr(disk, f)[..., None] for f in _FIELDS})
    F = nt_flux(d1, r)
    ys = 2.0 * math.pi * r * 2.0 * (-U_t) * F * r
    h = (x1 - x0) / n
    # the Eddington-normalized summands are O(1e5)
    scale = float(consts.grav_radius ** 2 / consts.L_Edd)
    w = simpson_weights(n, x0.device).to(x0.dtype)
    L = h / 3.0 * torch.sum(w * (ys * scale), dim=-1)
    return L * disk.M


def nt_mdot_for_luminosity(disk: NTDisk, L0):
    """Invert L(mdot) = L0 by fixed-depth bisection (40 halvings) over mdot
    in [0, 100].  (reference: disk_nt_find_mdot_for_luminosity,
    sim5disk-nt.c:370-382)"""
    L0 = _like(L0, disk)
    lo = torch.zeros_like(L0)
    hi = torch.full_like(lo, 100.0)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        below = nt_lumi(disk._replace(mdot=mid)) < L0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def nt_sigma(disk: NTDisk, r):
    """Midplane column density Sigma(r) [g/cm2] (two-zone SS73-like
    model).  (reference: disk_nt_sigma, sim5disk-nt.c:204-251)"""
    r = _like(r, disk)
    a = disk.a
    inside = r < disk.rms
    rs = torch.where(inside, disk.rms * 1.0001, r)
    x = torch.sqrt(rs)
    x0 = torch.sqrt(disk.rms)
    ac = torch.arccos(torch.clamp(a, -1.0, 1.0))
    x1 = 2.0 * torch.cos(ac / 3.0 - math.pi / 3.0)
    x2 = 2.0 * torch.cos(ac / 3.0 + math.pi / 3.0)
    x3 = -2.0 * torch.cos(ac / 3.0)

    xA = 1.0 + a ** 2 / rs ** 2 + 2.0 * a ** 2 / rs ** 3
    xB = 1.0 + a / x ** 3
    xC = 1.0 - 3.0 / x ** 2 + 2.0 * a / x ** 3
    xD = 1.0 - 2.0 / rs + a ** 2 / rs ** 2
    xE = (1.0 + 4.0 * a ** 2 / rs ** 2 - 4.0 * a ** 2 / rs ** 3
          + 3.0 * a ** 4 / rs ** 4)

    f0 = x - x0 - 1.5 * a * log_accurate(x / x0)
    f1 = (3.0 * (x1 - a) ** 2 / (x1 * (x1 - x2) * (x1 - x3))
          * log_accurate((x - x1) / (x0 - x1)))
    f2 = (3.0 * (x2 - a) ** 2 / (x2 * (x2 - x1) * (x2 - x3))
          * log_accurate((x - x2) / (x0 - x2)))
    f3 = (3.0 * (x3 - a) ** 2 / (x3 * (x3 - x2) * (x3 - x1))
          * log_accurate((x - x3) / (x0 - x3)))
    xL = ((1.0 + a / x ** 3) / torch.sqrt(1.0 - 3.0 / x ** 2
                                          + 2.0 * a / x ** 3) / x
          * (f0 - f1 - f2 - f3))

    xMdot = disk.mdot * disk.M * consts.Mdot_Edd / 1e17
    r_im = 40.0 * (disk.alpha ** (2.0 / 21.0) / (disk.M / 3.0) ** (2.0 / 3.0)
                   * xMdot ** (16.0 / 20.0)) * xA ** (20.0 / 21.0) \
        * xB ** (-36.0 / 21.0) * xD ** (-8.0 / 21.0) * xE ** (-10.0 / 21.0) \
        * xL ** (16.0 / 21.0)

    sig_in = (20.0 * (disk.M / 3.0) / xMdot / disk.alpha
              * torch.sqrt(rs ** 3) / xA ** 2 * xB ** 3 * torch.sqrt(xC) * xE
              / xL)
    sig_out = (5e4 * (disk.M / 3.0) ** (-2.0 / 5.0) * xMdot ** (3.0 / 5.0)
               * disk.alpha ** (-4.0 / 5.0) * rs ** (-3.0 / 5.0)
               * xB ** (-4.0 / 5.0) * torch.sqrt(xC) * xD ** (-4.0 / 5.0)
               * xL ** (3.0 / 5.0))
    sigma = torch.where(rs < r_im, sig_in, sig_out)
    return torch.where(inside, 0.0, sigma)


def nt_ell(disk: NTDisk, r):
    """Specific angular momentum of the fluid.  (sim5disk-nt.c:256-267)"""
    r = torch.maximum(disk.rms, _like(r, disk))
    a = disk.a
    sr = torch.sqrt(r)
    return (r * r - 2.0 * a * sr + a * a) / (sr * r - 2.0 * sr + a)


def nt_vr(disk: NTDisk, r):
    """Radial velocity (zero for a thin disk).  (sim5disk-nt.c:272-282)"""
    return torch.zeros_like(_like(r, disk))


def nt_h(disk: NTDisk, r):
    """Surface height (zero for a thin disk).  (sim5disk-nt.c:287-298)"""
    return torch.zeros_like(_like(r, disk))


def nt_dhdr(disk: NTDisk, r):
    """Surface slope dH/dR (zero for a thin disk).  (sim5disk-nt.c:303-313)"""
    return torch.zeros_like(_like(r, disk))


def nt_dump(disk: NTDisk, filename=None, rmax=2000.0):
    """Print the radial disk structure (r, flux, sigma, ell, vr, H, dH/dr)
    from r_ms out to `rmax` on the reference's x1.05 geometric grid, to
    `filename` or stdout.  (reference: disk_nt_dump, sim5disk-nt.c:318-365)
    """
    rms = float(disk.rms)
    n = max(1, int(math.ceil(math.log(rmax / rms) / math.log(1.05))))
    r = _like(rms * 1.05 ** np.arange(n), disk)
    cols = [r, nt_flux(disk, r), nt_sigma(disk, r), nt_ell(disk, r),
            nt_vr(disk, r), nt_h(disk, r), nt_dhdr(disk, r)]
    cols = [c.detach().cpu().numpy() for c in cols]

    buf = io.StringIO()
    buf.write("# (sim5_tpu disk.nt) dump\n")
    buf.write("#-------------------------------------------\n")
    buf.write(f"# M        = {float(disk.M):.4f}\n")
    buf.write(f"# a        = {float(disk.a):.4f}\n")
    buf.write(f"# rmin     = {rms:.4f}\n")
    buf.write(f"# rmax     = {rmax:.4f}\n")
    buf.write(f"# alpha    = {float(disk.alpha):.4f}\n")
    buf.write(f"# options  = {int(disk.options)}\n")
    buf.write(f"# L        = {float(nt_lumi(disk)):e}\n")
    buf.write(f"# mdot     = {float(disk.mdot):e}\n")
    buf.write("#-------------------------------------------\n")
    buf.write("# r   flux   sigma   ell   vr   H   dH/dr\n")
    buf.write("#-------------------------------------------\n")
    for row in zip(*cols):
        buf.write("  ".join(f"{v:e}" for v in row) + "\n")

    if filename:
        with open(filename, "w") as fh:
            fh.write(buf.getvalue())
    else:
        sys.stdout.write(buf.getvalue())
