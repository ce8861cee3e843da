"""Closed-form (analytic) null-geodesic engine for Kerr spacetime.

Port of `sim5_tpu/geodesic/analytic.py`: initialisation from impact
parameters at infinity, the position integral P(r), its radial and
poloidal inversions r(P), m(P), the sign of dm/dP, the photon momentum at
P, the equatorial-plane crossing, the capture predicate, the azimuth
phi(P) and the travel time between two positions (radial, and with the
poloidal term).  Still to port, with the thick-disk driver that uses
them: `geodesic_init_src`, `geodesic_follow` and
`geodesic_position_pol_sign_k_theta`.

The geodesic equation is solved via the quartic roots of the radial
potential R(r) (Cadez, Fanton & Calvani 1998) and Jacobi/Carlson elliptic
integrals, as the reference engine (sim5kerr-geod.c), but batched:

* the per-type `switch` of the reference becomes masked evaluation of all
  live trajectory types (RR / RR_BH / RC / CC) with NaN-safe dummy inputs
  in the untaken branches;
* the theta-oscillation `while` loops become closed-form period counts.

Every masked dummy and NaN-safe select of the JAX package is kept:
`torch.where` evaluates both branches, as `jnp.where` does.  Dtype and
device follow the inputs; in f32 every fixed depth and tolerance is the
JAX package's f32 one.

Position along a geodesic is parametrized by the monotonic position
integral P (Bursa 2017, eq. 34/43), increasing from 0 at infinity.
"""

import dataclasses
import math

import numpy as np
import torch

from ..core import photon_momentum, photon_motion_constants, r_bh
from ..core.metric import _as_tensors
from ..special import (
    quartic_roots, sort_quartic_roots, polish_quartic_real_roots_df, rf,
    elliptic_k_mc, elliptic_f_cos, jacobi_sncndn, jacobi_icn,
    integral_R_rp_re, integral_R_rp_re_inf,
    integral_R_rp_cc2_inf, integral_R_rp_cc2,
    integral_R_r0_re, integral_R_r1_re, integral_R_r2_re,
    integral_R_r0_cc, integral_R_r1_cc, integral_R_r2_cc,
    integral_R_r0_bh, integral_R_r1_bh, integral_R_r2_bh, integral_R_rp_bh,
    integral_T_mp, integral_T_mp_dn, integral_T_m2, integral_T_m2_dn,
)
from .types import (
    Geodesic,
    GEOD_TYPE_RR, GEOD_TYPE_RR_DBL, GEOD_TYPE_RR_BH, GEOD_TYPE_RC, GEOD_TYPE_CC,
    GD_OK, GD_ERROR_UNKNOWN_SOLUTION, GD_ERROR_TYPE_RR_DOUBLE,
    GD_ERROR_Q_RANGE, GD_ERROR_MUPLUS_RANGE, GD_ERROR_MU0_RANGE,
    GD_ERROR_MM_RANGE, GD_ERROR_INCL_RANGE, GD_ERROR_SPIN_RANGE,
)

_HALF_PI = math.pi / 2.0
_BIG = 1e300


def _tinyf(x):
    """Smallest-normal floor for x's dtype: the guard value for positive
    quantities (a literal 1e-300 flushes to 0.0 in f32)."""
    return torch.finfo(x.dtype).tiny


def _like(v, ref):
    """`v` as a tensor of `ref`'s dtype and device."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _live(g):
    return ((g.gtype == GEOD_TYPE_RR) | (g.gtype == GEOD_TYPE_RC)
            | (g.gtype == GEOD_TYPE_CC) | (g.gtype == GEOD_TYPE_RR_BH))


def _theta_int(g: Geodesic, x):
    """T-integral from m=x to mu_plus:  mK * icn(x/sqrt(m2p), mm).

    (reference macro theta_int, sim5kerr-geod.c:29)
    """
    u = torch.clamp(x / torch.sqrt(g.m2p), -1.0, 1.0)
    return g.mK * jacobi_icn(u, g.mm)


def _theta_inv(g: Geodesic, x):
    """Inverse of the T-integral: m(x) = sqrt(m2p) * cn(x/mK, mm).

    (reference macro theta_inv, sim5kerr-geod.c:30)
    """
    return torch.sqrt(g.m2p) * jacobi_sncndn(x / g.mK, g.mm)[1]


def _theta_pol_vortical(g: Geodesic, P):
    """m(P) and sign(dm/dP) for vortical rays (q < 0), which oscillate in
    one hemisphere between sqrt(-m2m) and sqrt(m2p): a Jacobi dn, not cn
    (BF 213.00; see the JAX package)."""
    sign0 = torch.where(g.beta >= 0.0, 1.0, -1.0)
    hemi = torch.where(g.cos_i >= 0.0, 1.0, -1.0)
    u = (P - sign0 * g.Tip) / g.mK
    sn, cn, dn = jacobi_sncndn(u, g.mm)
    m = hemi * torch.sqrt(g.m2p) * dn
    # dm/dP = hemi*sqrt(m2p) * dn'(u)/mK,  dn' = -mm*sn*cn
    dm_sign = -hemi * torch.sign(sn * cn)
    return m, dm_sign


def _theta_fold(g: Geodesic, P):
    """Closed-form oscillation folding shared by the cumulative theta
    integrals: returns (n, dT) with n completed half-oscillations since the
    fold base T0 (the most recent m = +-sqrt(m2p) touch at or below P=0)
    and dT = P - T0 - n*Tpp in (0, Tpp]."""
    sign0 = torch.where(g.beta >= 0.0, 1.0, -1.0)
    T0 = torch.where(sign0 > 0.0, -(g.Tpp - g.Tip), -g.Tip)
    n = torch.clamp(torch.ceil((P - T0) / g.Tpp) - 1.0, min=0.0)
    return n, P - T0 - n * g.Tpp


def _vortical_fold(g: Geodesic, P):
    """The dn-band fold of vortical (q < 0) rays, anchored at u = 0
    (m = +-sqrt(m2p)) and odd in u: returns (s, j, v, c2, b2, xv) with s
    the sign of the anchored P, j completed oscillations of length Tpp,
    v in [0, Tpp) the remainder, (c2, b2) the band's dummy-safe squared
    edges and xv = b dn(v/mK) clipped to the band."""
    qneg = g.q < 0.0
    c2 = torch.where(qneg, -g.m2m, 0.2)
    b2 = torch.where(qneg, g.m2p, 0.7)
    sign0 = torch.where(g.beta >= 0.0, 1.0, -1.0)
    Pu = P - sign0 * g.Tip
    s = torch.sign(Pu)
    A = torch.abs(Pu)
    j = torch.floor(A / g.Tpp)
    v = A - j * g.Tpp                     # in [0, Tpp)
    xv = torch.sqrt(b2) * jacobi_sncndn(v / g.mK, g.mm)[2]   # b*dn
    xv = torch.minimum(torch.maximum(xv, torch.sqrt(c2)), torch.sqrt(b2))
    return s, j, v, c2, b2, xv


def _theta_phi_cum(g: Geodesic, P):
    """Cumulative azimuthal theta-term  l * int dP' / (1 - m(P')^2), measured
    from the oscillation base point, monotone in P (sign of l).

    Equator-crossing rays (q > 0, cn-form): per half-oscillation of length
    Tpp the term grows by the complete integral; the in-segment remainder
    is integral_T_mp at the signed m (its negative-X branch is the
    monotone continuation past the equator).  Vortical rays (q < 0,
    dn-form): segments of length Tpp/2 alternate between the dn-band
    integrals.  This full folding replaces the reference's single-break
    while loop (sim5kerr-geod.c:538-547), which truncates after one
    oscillation.
    """
    # --- q > 0 (cn-form)
    qpos = g.q > 0.0
    m2m = torch.where(qpos, g.m2m, 1.0)
    m2p_c = torch.where(qpos, g.m2p, 0.5)
    n, dT = _theta_fold(g, P)
    # in-segment descending variable x = sqrt(m2p)*cn(dT/mK): runs from
    # +sqrt(m2p) monotonically to -sqrt(m2p)
    sq = torch.sqrt(m2p_c)
    x = jacobi_sncndn(torch.where(qpos, dT, 0.5 * g.Tpp) / g.mK, g.mm)[1]
    x = torch.minimum(torch.maximum(sq * x, -sq), sq)
    one = torch.ones_like(g.a)
    seg = integral_T_mp(m2m, m2p_c, one, x)
    full = integral_T_mp(m2m, m2p_c, one, -sq)
    cum_cn = (g.l / g.a) * (n * full + seg)

    # --- q < 0 (dn-form)
    s, j, v, c2, b2, xv = _vortical_fold(g, P)
    seg_dn = integral_T_mp_dn(c2, b2, one, xv)
    full_dn = 2.0 * integral_T_mp_dn(c2, b2, one, torch.sqrt(c2))
    segv = torch.where(v <= 0.5 * g.Tpp, seg_dn, full_dn - seg_dn)
    cum_dn = (g.l / g.a) * s * (j * full_dn + segv)

    return torch.where(g.q < 0.0, cum_dn, cum_cn)


# ---------------------------------------------------------------------------
# root finding & classification
# ---------------------------------------------------------------------------

def _rc_geometry(t1, t2, tu, tv):
    """Stable RC-branch elliptic geometry for two real roots t1 > t2 and a
    complex pair tu +- i tv.

    Returns (A, B, AmB, mm, mmc) with A = |t1 - (tu+itv)|, B = |t2 - .|,
    AmB = A - B and mmc = 1 - mm, the last two in cancellation-free product
    forms (see the JAX package).
    """
    x1 = t1 - tu
    x2 = t2 - tu
    A = torch.sqrt(x1 * x1 + tv * tv)
    B = torch.sqrt(x2 * x2 + tv * tv)
    tv2 = tv * tv
    # the hypot-identity denominators are sanitized on their untaken side
    d1p = torch.where(x1 > 0.0, A + x1, 1.0)
    d1m = torch.where(x1 < 0.0, A - x1, 1.0)
    d2p = torch.where(x2 > 0.0, B + x2, 1.0)
    d2m = torch.where(x2 < 0.0, B - x2, 1.0)
    hm1 = torch.where(x1 > 0.0, tv2 / d1p, A - x1)
    hp1 = torch.where(x1 < 0.0, tv2 / d1m, A + x1)
    hm2 = torch.where(x2 > 0.0, tv2 / d2p, B - x2)
    hp2 = torch.where(x2 < 0.0, tv2 / d2m, B + x2)
    ApB = A + B
    AmB = (t1 - t2) * (x1 + x2) / ApB
    mm = ((ApB) ** 2 - (t1 - t2) ** 2) / (4.0 * A * B)
    mmc = ((t1 - t2) ** 2 * (hm1 + hm2) * (hp1 + hp2)
           / (4.0 * A * B * ApB ** 2))
    return (A, B, AmB, torch.clamp(mm, 0.0, 1.0),
            torch.clamp(mmc, _tinyf(mmc), 1.0))


def _cc_complement(b1, a1, b2, a2_, A_cc, B_cc):
    """Stable CC-branch complement 1 - mm_cc = ((A-B)/(A+B))^2 via the
    cancellation-free difference A - B = 4 a1 a2 / (A + B)."""
    AmB = 4.0 * a1 * a2_ / (A_cc + B_cc)
    return AmB, torch.clamp((AmB / (A_cc + B_cc)) ** 2, _tinyf(AmB), 1.0)


def _cc_map(rr, ri, is_cc):
    """Masked CC map parameters (dummy-safe on non-CC lanes): b1, a1,
    A_cc, B_cc, AmB_cc, mmc_cc, g1, mm_cc."""
    b1 = torch.where(is_cc, rr[..., 0], 0.0)
    a1 = torch.where(is_cc, torch.abs(ri[..., 0]), 1.0)
    b2 = torch.where(is_cc, rr[..., 2], 1.0)
    a2_ = torch.where(is_cc, torch.abs(ri[..., 2]), 2.0)
    A_cc = torch.sqrt((b1 - b2) ** 2 + (a1 + a2_) ** 2)
    B_cc = torch.sqrt((b1 - b2) ** 2 + (a1 - a2_) ** 2)
    AmB_cc, mmc_cc = _cc_complement(b1, a1, b2, a2_, A_cc, B_cc)
    g1num = torch.clamp(4.0 * a1 * a1 - AmB_cc ** 2, min=1e-30)
    g1den = torch.clamp((A_cc + B_cc) ** 2 - 4.0 * a1 * a1, min=1e-30)
    g1 = torch.sqrt(g1num / g1den)
    mm_cc = 4.0 * A_cc * B_cc / (A_cc + B_cc) ** 2
    return b1, a1, A_cc, B_cc, mmc_cc, g1, mm_cc


def _R_roots(a, l, q, r0):
    """Quartic roots of R(r) = r^4 + (a^2-l^2-q) r^2 + 2(q+(l-a)^2) r - a^2 q,
    trajectory classification against observation radius r0, periastron and
    Rpc (position integral infinity->periastron).

    Returns (rr, rr_lo, ri, nrr, gtype, rp, Rpc, status).
    (reference: geodesic_priv_R_roots, sim5kerr-geod.c:986-1104)
    """
    a2 = a * a
    c2 = a2 - l * l - q               # coefficient of r^2
    c1 = 2.0 * (q + (l - a) ** 2)     # coefficient of r
    c0 = -a2 * q                      # constant
    re, im, _n = quartic_roots(torch.zeros_like(a), c2, c1, c0)
    rr, ri, nrr = sort_quartic_roots(re, im)
    # two-float compensated-Newton polish: the elliptic moduli below are
    # cross-ratios of root differences
    rr, rr_lo = polish_quartic_real_roots_df(rr, ri, c2, c1, c0)

    is4 = nrr == 4
    is2 = nrr == 2
    is0 = nrr == 0

    r1, r2, r3 = rr[..., 0], rr[..., 1], rr[..., 2]

    def dd(i, j, dummy):
        """Accurate masked root difference rr[i]-rr[j] (two-float)."""
        d = ((rr[..., i] - rr[..., j])
             + (rr_lo[..., i] - rr_lo[..., j]))
        return torch.where(is4, d, dummy)

    # --- classification (nrr==4)
    dbl_root = is4 & (torch.abs(r1 - r2) < 1e-8)
    inner = is4 & (r0 >= r3) & (r0 <= r2)
    bad4 = is4 & ((r0 < r3) | ((r0 > r2) & (r0 < r1)))

    gtype = torch.where(is4, GEOD_TYPE_RR,
                        torch.where(is2, GEOD_TYPE_RC, GEOD_TYPE_CC))
    gtype = torch.where(dbl_root, GEOD_TYPE_RR_DBL, gtype)
    gtype = torch.where(inner & ~dbl_root, GEOD_TYPE_RR_BH, gtype)

    status = torch.where(bad4, GD_ERROR_UNKNOWN_SOLUTION,
                         torch.where(dbl_root, GD_ERROR_TYPE_RR_DOUBLE, GD_OK))

    # --- RR (outer) branch: moduli from the two-float root differences
    d12 = dd(0, 1, 2.0)
    d13 = dd(0, 2, 4.0)
    d14 = dd(0, 3, 6.0)
    d23 = dd(1, 2, 2.0)
    d24 = dd(1, 3, 4.0)
    d34 = dd(2, 3, 2.0)
    m4 = (d23 * d14) / (d24 * d13)
    c4 = 2.0 / torch.sqrt(d13 * d24)
    z4 = torch.clamp(torch.sqrt(d24 / d14), 0.0, 1.0)

    # --- RC branch: two real roots + complex pair u +- iv
    t1 = torch.where(is2, r1, 6.0)
    t2 = torch.where(is2, r2, 2.0)
    tu = torch.where(is2, rr[..., 2], 0.0)
    tv = torch.where(is2, torch.abs(ri[..., 2]), 1.0)
    A_rc, B_rc, AmB_rc, mm_rc, mmc_rc = _rc_geometry(t1, t2, tu, tv)
    z_rc = AmB_rc / (A_rc + B_rc)
    feps = 8.0 * torch.finfo(m4.dtype).eps
    az_rc = torch.clamp(torch.abs(z_rc), feps, 1.0 - feps)

    # --- CC branch: two complex pairs b1 +- ia1, b2 +- ia2
    b1, a1, A_cc, B_cc, mmc_cc, g1, mm_cc = _cc_map(rr, ri, is0)
    zg = 1.0 / g1
    w2_cc = zg * zg / (1.0 + zg * zg)       # w^2; 1 - w^2 = 1/(1+zg^2)
    w2c_cc = 1.0 / (1.0 + zg * zg)
    w_cc = torch.sqrt(w2_cc)

    # every Rpc branch reduces to ONE incomplete-RF slot plus ONE
    # complete-K slot (see the JAX package):
    #   RF slot: RR isn | RC icn-generic | CC itn-as-isn
    #   K slot:  RR_BH K(m4) | RC K(mm_rc) | CC K(mm_cc)
    one = torch.ones_like(m4)
    x1c = torch.where(is4, d12 / d14,
                      torch.where(is2, az_rc * az_rc, w2c_cc))
    y1c = torch.where(is4, d12 / d13,
                      torch.where(is2, mmc_rc + mm_rc * az_rc * az_rc,
                                  mmc_cc + mm_cc * w2c_cc))
    rf1 = rf(x1c, y1c, one)
    mc_K = torch.where(is4, (d12 * d34) / (d24 * d13),
                       torch.where(is2, mmc_rc, mmc_cc))
    K_slot = elliptic_k_mc(mc_K)

    Rpc_rr = c4 * z4 * rf1
    Rpc_bh = c4 * K_slot
    icn1 = torch.sqrt(1.0 - az_rc * az_rc) * rf1
    Rpc_rc = torch.where(z_rc >= 0.0, icn1, 2.0 * K_slot - icn1) \
        / torch.sqrt(A_rc * B_rc)
    # the CC integral continues past the tangent half-map's pole:
    # u(infinity) = 2K - itn(1/g1) (not the reference's itn(1/g1))
    Rpc_cc = 2.0 / (A_cc + B_cc) * (2.0 * K_slot - w_cc * rf1)

    rp = torch.where(is4, torch.where(inner, r2, r1),
                     torch.where(is2, t1, b1 - a1 * g1))
    Rpc = torch.where(is4, torch.where(inner, Rpc_bh, Rpc_rr),
                      torch.where(is2, Rpc_rc, Rpc_cc))
    return (rr, rr_lo, ri, nrr.to(torch.int32), gtype.to(torch.int32), rp,
            Rpc, status.to(torch.int32))


def _T_roots(a, l, q, m0):
    """Roots of the theta potential M(m) = q + (a^2-l^2-q)m^2 - a^2 m^4
    = a^2 (m2m + m^2)(m2p - m^2), plus derived moduli.

    (reference: geodesic_priv_T_roots, sim5kerr-geod.c:1109-1184)
    Returns (m2p, m2m, mm, mK, status).
    """
    a2 = a * a
    qla = q + l * l - a2
    S = torch.sqrt(qla * qla + 4.0 * q * a2)
    # X = S + qla cancels when qla < 0: take the rationalized branch
    denom = S - qla
    X = torch.where(qla >= 0.0, S + qla,
                    4.0 * q * a2 / torch.where(denom != 0.0, denom, 1.0))
    m2m = X / (2.0 * a2)
    m2p = (2.0 * q) / X

    # validity gates with a few-ulp slack, floored at 1e-12 exactly as the
    # JAX package, so the port accepts and rejects the same lanes
    feps = max(8.0 * float(torch.finfo(m2p.dtype).eps), 1e-12)
    bad_mp = (m2p <= 0.0) | (m2p > 1.0 + feps)
    qpos = q > 0.0
    qneg = q < 0.0

    mm_pos = m2p / (m2p + m2m)
    mm_neg = (m2p + m2m) / m2p
    mm = torch.where(qpos, mm_pos, mm_neg)
    mm = torch.clamp(mm, max=1.0 - feps)
    bad_mm = (mm < 0.0) | (mm >= 1.0)

    sqrt_m2p = torch.sqrt(torch.clamp(m2p, min=0.0))
    m0_slack = sqrt_m2p * (1.0 + feps)
    bad_m0 = torch.where(
        qpos, torch.abs(m0) > m0_slack,
        (torch.abs(m0) > m0_slack)
        | (torch.abs(m0) < torch.sqrt(torch.clamp(-m2m, min=0.0))
           * (1.0 - feps)))

    mK = torch.where(qpos,
                     1.0 / torch.sqrt(a2 * (m2p + m2m)),
                     1.0 / torch.sqrt(a2 * torch.clamp(m2p,
                                                       min=_tinyf(m2p))))

    status = torch.where(
        bad_mp, GD_ERROR_MUPLUS_RANGE,
        torch.where(bad_mm, GD_ERROR_MM_RANGE,
                    torch.where(bad_m0, GD_ERROR_MU0_RANGE,
                                torch.where(~qpos & ~qneg,
                                            GD_ERROR_Q_RANGE, GD_OK))))
    return m2p, m2m, mm, mK, status.to(torch.int32)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def geodesic_init_inf(i, a, alpha, beta):
    """Set up a geodesic from impact parameters at infinity.

    Args broadcast; dtype and device follow them.  Returns a `Geodesic`
    whose `status` field is GD_OK where the setup succeeded (invalid
    entries carry error codes and NaN-free dummy caches).
    (reference: geodesic_init_inf, sim5kerr-geod.c:42-100)
    """
    i, a, alpha, beta = _as_tensors(i, a, alpha, beta)
    bad_spin = (a < 0.0) | (a > 1.0 - 1e-6)
    bad_incl = (i <= 0.0) | (i >= _HALF_PI)
    beta = torch.where(beta == 0.0, 1e-6, beta)
    a_eff = torch.clamp(a, min=1e-4)
    cos_i = torch.cos(i)
    l = -alpha * torch.sin(i)
    q = beta ** 2 + cos_i ** 2 * (alpha ** 2 - a_eff ** 2)
    bad_q = q == 0.0
    q = torch.where(bad_q, 1.0, q)   # dummy to keep downstream finite

    # the observer at r0 = 1e300 (inf in f32, as the JAX cast gives)
    r_obs = torch.full_like(a_eff, _BIG, dtype=torch.float64).to(a_eff.dtype)
    rr, rr_lo, ri, nrr, gtype, rp, Rpc, st_r = _R_roots(a_eff, l, q, r_obs)
    m2p, m2m, mm, mK, st_t = _T_roots(a_eff, l, q, cos_i)

    status = torch.where(
        bad_spin, GD_ERROR_SPIN_RANGE,
        torch.where(bad_incl, GD_ERROR_INCL_RANGE,
                    torch.where(bad_q, GD_ERROR_Q_RANGE,
                                torch.where(st_r != 0, st_r, st_t))))

    # Tpp = 2 mK K(mm), K from the exact theta-root complement of mm
    mm_c = torch.where(q > 0.0, m2m / (m2p + m2m),
                       -m2m / torch.where(m2p != 0.0, m2p, 1.0))
    mm_c = torch.clamp(mm_c, 1e-12, 1.0)
    Tpp = 2.0 * mK * elliptic_k_mc(mm_c)
    # Tip = mK icn(cos_i/sqrt(m2p), mm) with the cancellation-free
    # 1 - u^2 = beta^2 sin^2 i / (a^2 (m2m + cos_i^2) m2p) where the direct
    # difference is ill-conditioned (see the JAX package)
    denom = a_eff ** 2 * (m2m + cos_i ** 2) * m2p
    eps_ident = (beta * torch.sin(i)) ** 2 / torch.where(denom > 0.0, denom,
                                                         1.0)
    eps_ident = torch.where(denom > 0.0, eps_ident, 0.5)
    eps_direct = (m2p - cos_i ** 2) / m2p
    eps = torch.where(eps_direct > 1e-6, eps_direct, eps_ident)
    eps = torch.clamp(eps, _tinyf(eps), 1.0)
    # vortical (q < 0) rays take the dn-form integral in the same fused
    # sqrt(e) RF(1-e, y, 1) slot
    qneg = q < 0.0
    sn2v = torch.clamp(eps / torch.clamp(mm, min=_tinyf(mm)), 0.0,
                       1.0 - 1e-12)
    e_sel = torch.where(qneg, sn2v, eps)
    y_sel = torch.where(qneg, 1.0 - mm * sn2v, (1.0 - eps) + eps * mm_c)
    Tip = mK * torch.sqrt(e_sel) * rf(1.0 - e_sel, y_sel,
                                      torch.ones_like(e_sel))
    return Geodesic(a_eff, alpha, beta, i, cos_i, l, q, rr, ri, nrr, gtype,
                    m2p, m2m, mm, mK, rp, Rpc, Tpp, Tip,
                    status.to(torch.int32), rr_lo)


def geodesic_init_src(a, r, m, k, ppc):
    """Set up a geodesic from a point (r, m) and 4-momentum direction k.

    `ppc`: 1 if the point is past the radial turning point else 0.
    Infers the at-infinity parameters (cos_i, alpha, beta).  Dtype and
    device follow `k`.
    (reference: geodesic_init_src, sim5kerr-geod.c:106-173)
    """
    k = torch.as_tensor(k)
    if not k.is_floating_point():
        k = k.to(torch.float64)
    a, r, m = torch.broadcast_tensors(*(_like(v, k) for v in (a, r, m)))
    l, q = photon_motion_constants(a, r, m, k)
    a_eff = torch.clamp(a, min=1e-8)

    rr, rr_lo, ri, nrr, gtype, rp, Rpc, st_r = _R_roots(a_eff, l, q, r)
    m2p, m2m, mm, mK, st_t = _T_roots(a_eff, l, q, m)
    status = torch.where(st_r != 0, st_r, st_t)

    zero = torch.zeros_like(a_eff)
    g = Geodesic(a_eff, zero, zero, zero, zero, l, q, rr, ri, nrr, gtype,
                 m2p, m2m, mm, mK, rp, Rpc, zero, zero,
                 status.to(torch.int32), rr_lo)

    Tmp = _theta_int(g, m)
    Tpp = 2.0 * _theta_int(g, zero)
    P_pt = geodesic_P_int(g, r, ppc)
    sign_dm = torch.where(k[..., 2] < 0.0, 1.0, -1.0)
    T = P_pt + torch.where(sign_dm > 0.0, Tpp - Tmp, Tmp)
    # fold T into (0, Tpp], flipping sign_dm once a period (the
    # reference's while T > Tpp loop); nper >= 0, where torch.remainder
    # agrees with jnp's %
    nper = torch.clamp(torch.ceil(T / Tpp) - 1.0, min=0.0)
    T = T - nper * Tpp
    sign_dm = sign_dm * torch.where(torch.remainder(nper, 2.0) == 0.0,
                                    1.0, -1.0)
    cos_i = -sign_dm * _theta_inv(g, T)
    incl = torch.arccos(cos_i)
    alpha = -l / torch.sqrt(torch.clamp(1.0 - cos_i ** 2, min=1e-30))
    beta = -sign_dm * torch.sqrt(torch.clamp(
        q - cos_i ** 2 * (alpha ** 2 - a_eff ** 2), min=0.0))

    g = g._replace(alpha=alpha, beta=beta, incl=incl, cos_i=cos_i)
    Tip = _theta_int(g, cos_i)

    # vortical (q < 0) theta bookkeeping (no reference equivalent: its
    # init_src assumes equator-crossing rays): infer the dn-phase u_pt
    # from (|m|, sign dm) and store a Tip/beta pair consistent with the
    # sign0 = +1 convention of _theta_pol_vortical
    qneg = q < 0.0
    b2v = torch.where(qneg, g.m2p, 0.7)
    mm_s = torch.where(qneg, g.mm, 0.5)
    hemi = torch.where(m >= 0.0, 1.0, -1.0)
    sn2v = torch.clamp((1.0 - m * m / b2v) / mm_s, 0.0, 1.0)
    Tcur = g.mK * elliptic_f_cos(torch.sqrt(1.0 - sn2v), mm_s)
    desc = sign_dm * hemi < 0.0        # |m| decreasing: u_pt in (0, K)
    Tip_v = (torch.where(torch.isfinite(P_pt), P_pt, 0.0)
             - torch.where(desc, Tcur, -Tcur))
    # torch.round rounds half to even, as jnp.round
    Tip_v = Tip_v - Tpp * torch.round(Tip_v / Tpp)
    _, _, dn_ip = jacobi_sncndn(Tip_v / g.mK, mm_s)
    cos_i_v = hemi * torch.sqrt(b2v) * dn_ip
    incl_v = torch.arccos(torch.clamp(cos_i_v, -1.0, 1.0))
    alpha_v = -l / torch.sqrt(torch.clamp(1.0 - cos_i_v ** 2, min=1e-30))
    beta_v = torch.sqrt(torch.clamp(
        q - cos_i_v ** 2 * (alpha_v ** 2 - a_eff ** 2), min=0.0))

    return g._replace(alpha=torch.where(qneg, alpha_v, alpha),
                      beta=torch.where(qneg, beta_v, beta),
                      incl=torch.where(qneg, incl_v, incl),
                      cos_i=torch.where(qneg, cos_i_v, cos_i),
                      Tpp=Tpp, Tip=torch.where(qneg, Tip_v, Tip))


# ---------------------------------------------------------------------------
# position integral and its inversions
# ---------------------------------------------------------------------------

def geodesic_P_int(g: Geodesic, r, ppc):
    """Value of the position integral between infinity and radius r.

    `ppc`: 0 = before the (outer) turning point, 1 = past it; for bound
    RR_BH rays the flag refers to the apastron r2 (see the JAX package).
    (reference: geodesic_P_int, sim5kerr-geod.c:178-263)
    """
    r = _like(r, g.a)
    ppc_f = _like(ppc, g.a)
    is_rr = g.gtype == GEOD_TYPE_RR
    is_bh = g.gtype == GEOD_TYPE_RR_BH
    is_rc = g.gtype == GEOD_TYPE_RC
    is_cc = g.gtype == GEOD_TYPE_CC
    is4 = is_rr | is_bh

    r1 = torch.where(is4, g.rr[..., 0], 8.0)
    r2 = torch.where(is4, g.rr[..., 1], 6.0)
    d13 = torch.where(is4, g.root_diff(0, 2), 4.0)
    d14 = torch.where(is4, g.root_diff(0, 3), 6.0)
    d23 = torch.where(is4, g.root_diff(1, 2), 2.0)
    d24 = torch.where(is4, g.root_diff(1, 3), 4.0)
    mm4 = (d23 * d14) / (d24 * d13)
    # RR: argument sqrt(((r2-r4)(r-r1))/((r1-r4)(r-r2))); the sqrt
    # arguments are guarded before the clamp at zero
    rs = torch.where(is4, r, 10.0)
    q_rr = (d24 * (rs - r1)) / (d14 * (rs - r2))
    arg_rr = torch.where(q_rr > 0.0,
                         torch.sqrt(torch.where(q_rr > 0.0, q_rr, 1.0)), 0.0)
    # RR_BH: argument sqrt((r1-r3)/(r2-r3)*(r2-r)/(r1-r))
    rs_bh = torch.where(is_bh, r, 3.0)
    q_bh = d13 / d23 * (r2 - rs_bh) / (r1 - rs_bh)
    arg_bh = torch.where(q_bh > 0.0,
                         torch.sqrt(torch.where(q_bh > 0.0, q_bh, 1.0)), 0.0)
    # RR and RR_BH lanes share one isn slot
    arg4 = torch.clamp(torch.where(is_bh, arg_bh, arg_rr), max=1.0)
    c4 = 2.0 / torch.sqrt(d13 * d24)

    # RC (stable A-B / complement forms, see _rc_geometry)
    t1 = torch.where(is_rc, g.rr[..., 0], 6.0)
    t2 = torch.where(is_rc, g.rr[..., 1], 2.0)
    tu = torch.where(is_rc, g.rr[..., 2], 0.0)
    tv = torch.where(is_rc, torch.abs(g.ri[..., 2]), 1.0)
    A, B, AmB, mm_rc, mmc_rc = _rc_geometry(t1, t2, tu, tv)
    rs_rc = torch.where(is_rc, r, 10.0)
    z_rc = (((AmB) * rs_rc + t1 * B - t2 * A)
            / ((A + B) * rs_rc - t1 * B - t2 * A))
    feps = 8.0 * torch.finfo(mm4.dtype).eps
    az_rc = torch.clamp(torch.abs(z_rc), feps, 1.0 - feps)

    # CC
    b1, a1, A_cc, B_cc, mmc_cc, g1, mm_cc = _cc_map(g.rr, g.ri, is_cc)
    rs_cc = torch.where(is_cc, r, 10.0)
    z_cc = (rs_cc - b1 + a1 * g1) / (a1 + b1 * g1 - g1 * rs_cc)
    w2_cc = z_cc * z_cc / (1.0 + z_cc * z_cc)
    w2c_cc = 1.0 / (1.0 + z_cc * z_cc)
    w_cc = torch.sqrt(w2_cc)

    # one incomplete-RF slot + one complete-K slot across all types:
    #   RF slot: RR/RR_BH isn(arg4) | RC icn-generic | CC itn(|z_cc|)
    #   K slot:  RC K(mm_rc) | CC K(mm_cc)
    one = torch.ones_like(mm4)
    x1c = torch.where(is4, 1.0 - arg4 * arg4,
                      torch.where(is_rc, az_rc * az_rc, w2c_cc))
    y1c = torch.where(is4, 1.0 - mm4 * arg4 * arg4,
                      torch.where(is_rc, mmc_rc + mm_rc * az_rc * az_rc,
                                  mmc_cc + mm_cc * w2c_cc))
    rf1 = rf(x1c, y1c, one)
    K_slot = elliptic_k_mc(torch.where(is_rc, mmc_rc, mmc_cc))

    R_rr = c4 * arg4 * rf1
    R_bh = R_rr
    icn1 = torch.sqrt(1.0 - az_rc * az_rc) * rf1
    R_rc = torch.where(z_rc >= 0.0, icn1, 2.0 * K_slot - icn1) \
        / torch.sqrt(A * B)
    # monotone continuation past the z-pole (see _R_roots)
    itn_abs = w_cc * rf1
    u_cc = torch.where(z_cc >= 0.0, itn_abs, 2.0 * K_slot - itn_abs)
    R_cc = 2.0 / (A_cc + B_cc) * u_cc

    P = torch.where(
        is_rr, g.Rpc + torch.where(ppc_f > 0, R_rr, -R_rr),
        torch.where(is_bh, g.Rpc + torch.where(ppc_f > 0, R_bh, -R_bh),
                    torch.where(is_rc, g.Rpc - R_rc,
                                torch.where(is_cc, g.Rpc - R_cc, torch.nan))))
    P = torch.where(g.gtype == GEOD_TYPE_RR_DBL, torch.nan, P)
    # domain gate: from-infinity types live at r >= rp; the bound RR_BH
    # band at r3 <= r <= r2 = rp
    r3_bh = g.rr[..., 2]
    P = torch.where(torch.where(is_bh, (r > g.rp) | (r < r3_bh), r < g.rp),
                    torch.nan, P)
    P = torch.where(r == g.rp, g.Rpc, P)
    return P


def geodesic_position_rad(g: Geodesic, P):
    """Radius r(P); NaN outside the valid range.

    (reference: geodesic_position_rad, sim5kerr-geod.c:290-357; RR_BH and
    CC are inverted in closed form beyond the reference, see the JAX
    package)
    """
    P = _like(P, g.a)
    is_rr = g.gtype == GEOD_TYPE_RR
    is_bh = g.gtype == GEOD_TYPE_RR_BH
    is_rc = g.gtype == GEOD_TYPE_RC
    is_cc = g.gtype == GEOD_TYPE_CC
    is4 = is_rr | is_bh

    # sanitize NaN P before any arithmetic
    Pz = torch.where(torch.isfinite(P), P, 0.5 * g.Rpc)
    # RR_BH: bound orbits have radial period 2 Rpc; fold P
    Pf = torch.where(is_bh,
                     Pz - 2.0 * g.Rpc * torch.floor(Pz / (2.0 * g.Rpc)), Pz)
    # invalid P to mid-range
    P_valid = torch.isfinite(P) & (Pf > 0.0) & (Pf < 2.0 * g.Rpc)
    Ps = torch.where(P_valid, Pf, 0.5 * g.Rpc)

    r1 = torch.where(is4, g.rr[..., 0], 8.0)
    r2 = torch.where(is4, g.rr[..., 1], 6.0)
    # accurate two-float root differences (see _R_roots)
    d12 = torch.where(is4, g.root_diff(0, 1), 2.0)
    d13 = torch.where(is4, g.root_diff(0, 2), 4.0)
    d14 = torch.where(is4, g.root_diff(0, 3), 6.0)
    d23 = torch.where(is4, g.root_diff(1, 2), 2.0)
    d24 = torch.where(is4, g.root_diff(1, 3), 4.0)
    d34 = torch.where(is4, g.root_diff(2, 3), 2.0)
    m4 = (d23 * d14) / (d24 * d13)
    m4c = torch.clamp((d12 * d34) / (d24 * d13), _tinyf(d12), 1.0)
    x4 = 0.5 * torch.abs(Ps - g.Rpc) * torch.sqrt(d13 * d24)

    t1 = torch.where(is_rc, g.rr[..., 0], 6.0)
    t2 = torch.where(is_rc, g.rr[..., 1], 2.0)
    tu = torch.where(is_rc, g.rr[..., 2], 0.0)
    tv = torch.where(is_rc, torch.abs(g.ri[..., 2]), 1.0)
    A, B, AmB, m2, m2c = _rc_geometry(t1, t2, tu, tv)
    # RC valid domain is 0 < P < Rpc only (no turning point)
    Ps_rc = torch.where(P_valid & (Pf < g.Rpc), Ps, 0.5 * g.Rpc)

    # CC: no real roots; domain 0 < P <= Rpc (monotone plunge)
    b1, a1, A_cc, B_cc, mmc_cc, g1, mm_cc = _cc_map(g.rr, g.ri, is_cc)
    Ps_cc = torch.where(P_valid & (Pf <= g.Rpc), Ps, 0.5 * g.Rpc)

    # one AGM evaluation serves all branches, with the complement
    u_j = torch.where(is4, x4,
                      torch.where(is_cc, 0.5 * (A_cc + B_cc) * (g.Rpc - Ps_cc),
                                  torch.sqrt(A * B) * (g.Rpc - Ps_rc)))
    m_j = torch.where(is4, m4, torch.where(is_cc, mm_cc, m2))
    mc_j = torch.where(is4, m4c, torch.where(is_cc, mmc_cc, m2c))
    sn_j, cn, _dn = jacobi_sncndn(u_j, m_j, mc=mc_j)
    sn2 = sn_j ** 2
    # RR radius by the exact-identity form r = r2 + d12 d24 / D with
    # D = d24 cn^2 - d12 sn^2 (no subtractive cancellation in r - r2)
    cn2_rr = torch.where(is4, cn * cn, 0.5)
    D_rr = d24 * cn2_rr - d12 * sn2
    r_rr = r2 + d12 * d24 / torch.where(D_rr != 0.0, D_rr, _tinyf(D_rr))
    # RR_BH: w = sn^2 (r2-r3)/(r1-r3);  r = (r2 - w r1)/(1 - w)
    w_bh = sn2 * d23 / d13
    r_bh_ = (r2 - w_bh * r1) / (1.0 - w_bh)
    r_rc = ((t2 * A - t1 * B - (t2 * A + t1 * B) * cn)
            / (AmB - (A + B) * cn))
    r_rc = torch.where(Pf > g.Rpc, torch.nan, r_rc)   # no turning point
    # CC: r = (z (a1 + b1 g1) + b1 - a1 g1) / (1 + g1 z),  z = sn/cn, with
    # cn sanitized on non-CC lanes
    cn_cc = torch.where(is_cc, cn, 0.5)
    z_cc = sn_j / torch.where(torch.abs(cn_cc) > 1e-30, cn_cc,
                              torch.where(cn_cc >= 0, 1e-30, -1e-30))
    r_cc = ((z_cc * (a1 + b1 * g1) + b1 - a1 * g1)
            / (1.0 + g1 * z_cc))
    r_cc = torch.where(Pf > g.Rpc, torch.nan, r_cc)   # no turning point

    r = torch.where(is_rr, r_rr,
                    torch.where(is_bh, r_bh_,
                                torch.where(is_rc, r_rc,
                                            torch.where(is_cc, r_cc,
                                                        torch.nan))))
    r = torch.where((Pf <= 0.0) | (Pf >= 2.0 * g.Rpc) | ~torch.isfinite(P),
                    torch.nan, r)
    r = torch.where(Pf == g.Rpc, g.rp, r)
    return r


def _fold_pol(g: Geodesic, P):
    """Shared bookkeeping of theta-oscillations: returns (sign_dm, P - T)
    where T is the last sign-flip value below P.

    The reference's while loop (sim5kerr-geod.c:385-390) in closed form:
    n = max(0, ceil((P - T0)/Tpp) - 1), T = T0 + n*Tpp, flip sign n times.
    """
    sign0 = torch.where(g.beta >= 0.0, 1.0, -1.0)
    T0 = torch.where(sign0 > 0.0, -(g.Tpp - g.Tip), -g.Tip)
    n = torch.clamp(torch.ceil((P - T0) / g.Tpp) - 1.0, min=0.0)
    T = T0 + n * g.Tpp
    sign_dm = sign0 * torch.where(torch.remainder(n, 2.0) == 0.0, 1.0, -1.0)
    return sign_dm, P - T


def geodesic_position_pol(g: Geodesic, P):
    """Poloidal coordinate m(P) = cos(theta).  (sim5kerr-geod.c:362-407;
    vortical q < 0 rays use the dn-form, see _theta_pol_vortical)"""
    P = _like(P, g.a)
    Pz = torch.where(torch.isfinite(P), P, 0.0)
    sign_dm, dT = _fold_pol(g, Pz)
    m = -sign_dm * _theta_inv(g, dT)
    m_v, _ = _theta_pol_vortical(g, Pz)
    m = torch.where(g.q < 0.0, m_v, m)
    return torch.where(_live(g) & torch.isfinite(P), m, torch.nan)


def geodesic_dm_sign(g: Geodesic, P):
    """Sign of d(m)/d(P) at position P.  (sim5kerr-geod.c:736-781)"""
    P = _like(P, g.a)
    Pz = torch.where(torch.isfinite(P), P, 0.0)
    sign_dm, _ = _fold_pol(g, Pz)
    _, sign_v = _theta_pol_vortical(g, Pz)
    sign_dm = torch.where(g.q < 0.0, sign_v, sign_dm)
    return torch.where(_live(g) & torch.isfinite(P), sign_dm, torch.nan)


def geodesic_position_pol_sign_k_theta(g: Geodesic, P):
    """Sign of k^theta at position P (dk[2] = -d(m)).
    (sim5kerr-geod.c:413-457)"""
    return -geodesic_dm_sign(g, P)


def geodesic_find_midplane_crossing(g: Geodesic, order=0):
    """P value where the geodesic crosses the equatorial plane for the
    `order`-th time (0 the direct image, 1 the first orbiting one); NaN
    where there is no such crossing.

    Pure arithmetic on the cached T-integrals: mK K(mm) = Tpp/2 and
    mK icn(cos_i/sqrt(m2p), mm) = Tip (see the JAX package).
    (reference: geodesic_find_midplane_crossing, sim5kerr-geod.c:845-885)
    """
    u = g.cos_i / torch.sqrt(g.m2p)
    u_ok = torch.abs(u) <= 1.0 + 1e-4
    pos = ((2.0 * order + 1.0) * 0.5 * g.Tpp
           + torch.where(g.beta > 0.0, g.Tip,
                         torch.where(g.beta < 0.0, -g.Tip, 0.0)))
    pos = torch.where(pos > 2.0 * g.Rpc, torch.nan, pos)
    return torch.where((g.q <= 0.0) | ~u_ok | (g.status != GD_OK),
                       torch.nan, pos)


def geodesic_momentum(g: Geodesic, P, r=None, m=None):
    """Photon 4-momentum at position P (oriented along increasing P).

    As in the reference (sim5kerr-geod.c:815-822), k[2] is signed by dm/dP,
    not by dtheta/dlambda: flip it to feed the stepwise integrator.
    """
    P = _like(P, g.a)
    if r is None:
        r = geodesic_position_rad(g, P)
    if m is None:
        m = geodesic_position_pol(g, P)
    dm = geodesic_dm_sign(g, P)
    is_bh = g.gtype == GEOD_TYPE_RR_BH
    # RR_BH runs outward on the first half-period (see position_rad)
    Pz = torch.where(torch.isfinite(P), P, 0.0)
    Pf = torch.where(is_bh,
                     Pz - 2.0 * g.Rpc * torch.floor(Pz / (2.0 * g.Rpc)), Pz)
    rsign = (torch.where(Pf < g.Rpc, -1.0, 1.0)
             * torch.where(is_bh, -1.0, 1.0))
    k = photon_momentum(g.a, torch.where(torch.isfinite(r), r, 10.0),
                        torch.where(torch.isfinite(m), m, 0.0),
                        g.l, g.q, rsign,
                        torch.where(torch.isfinite(dm), dm, 1.0))
    bad = ~_live(g) | ~torch.isfinite(r) | ~torch.isfinite(m)
    return torch.where(bad[..., None], torch.nan, k)


def geodesic_is_captured(g: Geodesic):
    """True where a from-infinity geodesic has no radial turning point
    outside the horizon: the photon falls in.  The captured set over the
    image plane is the black-hole shadow (silhouette).

    As in the JAX package (beyond the reference): RC/CC rays plunge by
    construction, RR rays are captured iff the periastron sits inside the
    horizon.
    """
    rh = 1.0 + torch.sqrt(torch.clamp(1.0 - g.a ** 2, min=0.0))
    is_rr = g.gtype == GEOD_TYPE_RR
    plunging = (g.gtype == GEOD_TYPE_RC) | (g.gtype == GEOD_TYPE_CC)
    return (g.status == GD_OK) & (plunging | (is_rr & (g.rp <= rh)))


# geodesic_follow status codes: the reference returns TRUE while the ray
# remains inside the valid domain, FALSE when it leaves
# (sim5kerr-geod.c:890); the batched form adds a third code for a step
# that did not fit into the substep budget
FOLLOW_STOPPED = 0        # ray left the valid domain (horizon / P range)
FOLLOW_OK = 1             # full step taken
FOLLOW_NOT_CONVERGED = 2  # substep budget exhausted before the step completed


def geodesic_follow(g: Geodesic, step, P, r, m, max_substeps=64):
    """Advance (P, r, m) by an affine step along the geodesic.

    As the reference (sim5kerr-geod.c:890-925) the step is taken in
    affine-parameter units (dP = dl / (r^2 + a^2 m^2)) and clamped to
    5e-2 sqrt(r) a substep; returns (P, r, m, status) with status
    FOLLOW_OK while the ray remains inside the valid domain,
    FOLLOW_STOPPED when it leaves, and FOLLOW_NOT_CONVERGED when the step
    needed more than `max_substeps` clamped substeps.

    Every lane advances in lockstep with masked substeps, as the JAX
    package's fixed-length scan; the loop ends early once no lane is
    active, since a frozen lane's carry no longer changes.
    """
    MAXSTEP = 5e-2
    P = _like(P, g.a)
    r = _like(r, g.a)
    m = _like(m, g.a)
    remaining = torch.broadcast_to(_like(step, g.a), P.shape)
    active = remaining.abs() > 1e-5
    failed = torch.zeros_like(active)
    for _ in range(max_substeps):
        if not bool(active.any()):
            break
        truestep = torch.sign(remaining) * torch.minimum(
            remaining.abs(), MAXSTEP * torch.sqrt(torch.clamp(r, min=1e-10)))
        Pn = P + truestep / (r ** 2 + (g.a * m) ** 2)
        rn = geodesic_position_rad(g, Pn)
        mn = geodesic_position_pol(g, Pn)
        hit_bh = rn < 1.01 * r_bh(g.a)
        out = (Pn < 0.0) | (Pn > 2.0 * g.Rpc) | ~torch.isfinite(rn)
        ok = active & ~hit_bh & ~out
        failed = failed | (active & (hit_bh | out))
        P = torch.where(ok, Pn, P)
        r = torch.where(ok, rn, r)
        m = torch.where(ok, mn, m)
        remaining = torch.where(ok, remaining - truestep, remaining)
        active = ok & (remaining.abs() > 1e-5)
    status = torch.where(failed, FOLLOW_STOPPED,
                         torch.where(active, FOLLOW_NOT_CONVERGED, FOLLOW_OK))
    return P, r, m, status.to(torch.int32)


# ---------------------------------------------------------------------------
# azimuth and travel time
# ---------------------------------------------------------------------------

def _as_f64(g: Geodesic):
    """`g` with every floating field in f64: the azimuth and the travel
    time are computed in f64 whatever the geodesic's dtype (their RR
    radial terms are differences of large integrals)."""
    return g._replace(**{f.name: getattr(g, f.name).double()
                         for f in dataclasses.fields(g)
                         if getattr(g, f.name) is not None
                         and getattr(g, f.name).is_floating_point()})


def _on_lanes(g: Geodesic, mask, fn, *args):
    """fn(g', *args') on the lanes where `mask` holds, scattered into
    zeros of the broadcast shape (the other lanes): g' and args' are `g`
    and `args` gathered to those lanes, as 1-D batches.  Elementwise, so
    every lane gets the value a full-batch evaluation would give; no work
    is done when no lane is selected."""
    shape = torch.broadcast_shapes(mask.shape, g.Rpc.shape,
                                   *(a.shape for a in args))
    mask = mask.expand(shape)
    out = torch.zeros(shape, dtype=g.Rpc.dtype, device=g.Rpc.device)
    if not bool(mask.any()):
        return out

    def take(v):
        if v is None:
            return None
        if v.ndim > g.Rpc.ndim:          # the (..., 4) root arrays
            return v.expand(shape + v.shape[-1:])[mask]
        return v.expand(shape)[mask]

    sub = g._replace(**{f.name: take(getattr(g, f.name))
                        for f in dataclasses.fields(g)})
    out[mask] = fn(sub, *(take(a) for a in args))
    return out


# --- CC (four complex roots) radial integrals: the tangent half-map of
# P_int/position_rad makes u an affine function of P, so any radial
# integrand becomes a smooth integral in u, evaluated by composite
# end-refined Gauss-Legendre in u (see the JAX package).  The reference
# NaNs the CC type in both azm and timedelay (sim5kerr-geod.c:516-521,
# 703-707).  The rule runs on the CC lanes only (`_on_lanes`), where the
# JAX package skips it at run time when a batch has none.

_GL16_X, _GL16_W = np.polynomial.legendre.leggauss(16)
# panel edges geometrically refined toward both ends: the horizon pole sits
# just below u_lo and the far-field structure just above u_hi
_CC_PANELS = np.array([0.0, 1.0 / 64, 1.0 / 8, 1.0 / 2,
                       7.0 / 8, 63.0 / 64, 1.0])


def _cc_quad(lo, hi):
    """(u_nodes, weights) of shape (..., 96) for int_lo^hi."""
    L = (hi - lo)[..., None]
    edges = lo[..., None] + L * _like(_CC_PANELS, lo)
    a, b = edges[..., :-1], edges[..., 1:]
    mid, half = 0.5 * (a + b), 0.5 * (b - a)
    u = mid[..., None] + half[..., None] * _like(_GL16_X, lo)
    w = half[..., None] * _like(_GL16_W, lo) * torch.ones_like(u)
    return (u.reshape(*u.shape[:-2], 96), w.reshape(*w.shape[:-2], 96))


def _cc_setup(g: Geodesic):
    """Masked CC map parameters (dummy-safe on non-CC lanes)."""
    is_cc = g.gtype == GEOD_TYPE_CC
    b1 = torch.where(is_cc, g.rr[..., 0], 0.0)
    a1 = torch.where(is_cc, torch.abs(g.ri[..., 0]), 1.0)
    b2 = torch.where(is_cc, g.rr[..., 2], 1.0)
    a2_ = torch.where(is_cc, torch.abs(g.ri[..., 2]), 2.0)
    A_cc = torch.sqrt((b1 - b2) ** 2 + (a1 + a2_) ** 2)
    B_cc = torch.sqrt((b1 - b2) ** 2 + (a1 - a2_) ** 2)
    g1num = torch.clamp(4.0 * a1 * a1 - (A_cc - B_cc) ** 2, min=1e-30)
    g1den = torch.clamp((A_cc + B_cc) ** 2 - 4.0 * a1 * a1, min=1e-30)
    g1 = torch.sqrt(g1num / g1den)
    mm_cc = 4.0 * A_cc * B_cc / (A_cc + B_cc) ** 2
    return b1, a1, b2, a2_, A_cc, B_cc, g1, mm_cc


def _cc_r_of_u(cc, u):
    """r(u) through the continued tangent half-map (cf. position_rad)."""
    b1, a1, _, _, _, _, g1, mm_cc = cc
    sn, cn, _ = jacobi_sncndn(u, mm_cc[..., None])
    cn = torch.where(torch.abs(cn) > 1e-30, cn,
                     torch.where(cn >= 0, 1e-30, -1e-30))
    z = sn / cn
    g1e = g1[..., None]
    return ((z * (a1 + b1 * g1)[..., None] + (b1 - a1 * g1)[..., None])
            / (1.0 + g1e * z))


def _cc_u_of_P(g: Geodesic, cc, P):
    """Affine P -> u: P = Rpc - 2u/(A+B)."""
    A_cc, B_cc = cc[4], cc[5]
    return (g.Rpc - P) * 0.5 * (A_cc + B_cc)


def _horizon_poles(a):
    """(a^2, outer horizon, inner horizon, sqrt(1 - a^2))."""
    a2 = a ** 2
    sq = torch.sqrt(1.0 - a2)
    return a2, 1.0 + sq, 1.0 - sq, sq


def _cc_phi_radial(g: Geodesic, cc, P):
    """Cumulative radial phi term from infinity (P=0) to P for CC rays."""
    A_cc, B_cc = cc[4], cc[5]
    a2, rph, rmh, sq = _horizon_poles(g.a)
    u_pt = _cc_u_of_P(g, cc, torch.where(torch.isfinite(P), P, 0.5 * g.Rpc))
    u_inf = _cc_u_of_P(g, cc, torch.zeros_like(g.Rpc))
    lo = torch.minimum(u_pt, u_inf)
    un, w = _cc_quad(lo, u_inf)
    r = _cc_r_of_u(cc, un)
    cp = (g.a * rph - g.l * a2 / 2.0) / sq
    cm = (g.a * rmh - g.l * a2 / 2.0) / sq
    f = (cp[..., None] / (r - rph[..., None])
         - cm[..., None] / (r - rmh[..., None]))
    return (2.0 / (A_cc + B_cc)) * torch.sum(f * w, dim=-1)


def _cc_time_radial(g: Geodesic, cc, P1, P2):
    """Radial travel time between P1 < P2 for CC rays.

    The far-field growth (dt ~ dr + 2 dlnr) is extracted exactly as the
    elementary part E(r) = r + 2 ln r; the Gauss sum handles only the
    bounded remainder W(u) (cancellation-free via the 1/r-series form of
    f_t - (1+2/r) sqrt(R), regular because the quartic has no cubic term).
    """
    b1, a1, b2, a2_, A_cc, B_cc, _, _ = cc
    a2, rph, rmh, sq = _horizon_poles(g.a)
    Ac = (-g.a * g.l + 4.0) * rph - 2.0 * a2
    Bc = (g.a * g.l - 4.0) * rmh + 2.0 * a2
    u1 = _cc_u_of_P(g, cc, P1)
    u2 = _cc_u_of_P(g, cc, P2)
    lo, hi = torch.minimum(u1, u2), torch.maximum(u1, u2)
    un, w = _cc_quad(lo, hi)
    r = _cc_r_of_u(cc, un)
    s = 1.0 / r
    # Q1*Q2 = 1 + q1 s + q2 s^2 + q3 s^3 + q4 s^4 (qi real); q1 = -2(b1+b2)
    # vanishes identically for the geodesic quartic (no cubic term)
    c1r = b1 * b1 + a1 * a1
    c2r = b2 * b2 + a2_ * a2_
    q1 = -2.0 * (b1 + b2)
    q2 = c1r + c2r + 4.0 * b1 * b2
    q3 = -2.0 * (b1 * c2r + b2 * c1r)
    q4 = c1r * c2r
    Q1 = 1.0 + s * (-2.0 * b1[..., None] + s * c1r[..., None])
    Q2 = 1.0 + s * (-2.0 * b2[..., None] + s * c2r[..., None])
    S = torch.sqrt(torch.clamp(Q1 * Q2, min=_tinyf(Q1)))
    poly = (q1[..., None] / s + q2[..., None]
            + s * (q3[..., None] + s * q4[..., None]))
    W = (4.0
         + (Ac[..., None] / (r - rph[..., None])
            + Bc[..., None] / (r - rmh[..., None])) / sq[..., None]
         - (1.0 + 2.0 * s) * poly / (1.0 + S))
    quad = (2.0 / (A_cc + B_cc)) * torch.sum(W * w, dim=-1)
    r_lo = _cc_r_of_u(cc, hi[..., None])[..., 0]   # larger u = larger r
    r_hi_ = _cc_r_of_u(cc, lo[..., None])[..., 0]
    r_a = torch.minimum(r_lo, r_hi_)
    r_b = torch.maximum(r_lo, r_hi_)
    r_a = torch.clamp(r_a, min=1e-6)
    elem = (r_b - r_a) + 2.0 * torch.log(r_b / r_a)
    return torch.abs(quad) + elem


def geodesic_position_azm(g: Geodesic, r, m, P):
    """Azimuthal angle change between [r,m] and the anchor point.

    Anchor: infinity for the from-infinity types (RR/RC/CC -- the
    reference's convention); the apastron passage at P=Rpc for bound
    RR_BH rays (which have no infinity).

    Beyond the reference (geodesic_position_azm, sim5kerr-geod.c:462-555,
    which implements RR and RC only and truncates the poloidal
    oscillation bookkeeping after one fold): RR_BH via the bound-band Z1
    integrals, CC via the end-refined Gauss rule in the elliptic
    parameter, and the fully folded closed-form theta term for q > 0 and
    vortical q < 0 rays alike.  Computed in f64 whatever the dtype of `g`
    (the JAX package does the same); the result is f64.
    """
    g = _as_f64(g)
    r = _like(r, g.a)
    P = _like(P, g.a)
    is_rr = g.gtype == GEOD_TYPE_RR
    is_rc = g.gtype == GEOD_TYPE_RC
    is_bh = g.gtype == GEOD_TYPE_RR_BH
    is_cc = g.gtype == GEOD_TYPE_CC

    a2, rph, rmh, sq = _horizon_poles(g.a)
    ppc = (g.nrr > 0) & (P > g.Rpc)
    cp = (g.a * rph - g.l * a2 / 2.0) / sq
    cm = (g.a * rmh - g.l * a2 / 2.0) / sq

    # RR radial part
    r1 = torch.where(is_rr, g.rr[..., 0], 8.0)
    r2 = torch.where(is_rr, g.rr[..., 1], 6.0)
    r3 = torch.where(is_rr, g.rr[..., 2], 4.0)
    r4 = torch.where(is_rr, g.rr[..., 3], 2.0)
    rs = torch.where(is_rr & (r >= r1), r, 10.0)
    sgn = torch.where(ppc, 1.0, -1.0)
    A_rr = (integral_R_rp_re_inf(r1, r2, r3, r4, rph)
            + sgn * integral_R_rp_re(r1, r2, r3, r4, rph, rs))
    B_rr = (integral_R_rp_re_inf(r1, r2, r3, r4, rmh)
            + sgn * integral_R_rp_re(r1, r2, r3, r4, rmh, rs))
    phi_rr = A_rr * cp - B_rr * cm

    # RC radial part
    t1 = torch.where(is_rc, g.rr[..., 0], 6.0)
    t2 = torch.where(is_rc, g.rr[..., 1], 2.0)
    tu = torch.where(is_rc, g.rr[..., 2], 0.0)
    tv = torch.where(is_rc, torch.abs(g.ri[..., 2]), 1.0)
    rs_rc = torch.where(is_rc & (r >= t1), r, 10.0)
    A_rc = integral_R_rp_cc2_inf(t1, t2, tu, tv, rph, rs_rc)
    B_rc = integral_R_rp_cc2_inf(t1, t2, tu, tv, rmh, rs_rc)
    phi_rc = A_rc * cp - B_rc * cm

    # RR_BH radial part: cumulative from the apastron passage at P=Rpc,
    # folded over the 2*Rpc radial period (k full cycles cost 2*Jc each;
    # Jc diverges iff the band straddles a horizon -- physical winding)
    b1 = torch.where(is_bh, g.rr[..., 0], 8.0)
    b2 = torch.where(is_bh, g.rr[..., 1], 6.0)
    b3 = torch.where(is_bh, g.rr[..., 2], 4.0)
    b4 = torch.where(is_bh, g.rr[..., 3], 2.0)
    Pz = torch.where(torch.isfinite(P), P, g.Rpc)
    k_cyc = torch.floor(Pz / (2.0 * g.Rpc))
    Pf = Pz - 2.0 * g.Rpc * k_cyc
    y_bh = torch.minimum(torch.maximum(
        torch.where(is_bh & torch.isfinite(r), r, 5.0), b3 + 1e-14), b2)
    J_y = (integral_R_rp_bh(b1, b2, b3, b4, rph, y_bh) * cp
           - integral_R_rp_bh(b1, b2, b3, b4, rmh, y_bh) * cm)
    need_jc = is_bh & (k_cyc != 0.0)
    # dummy pole below the band on untaken lanes
    p_hi = torch.where(need_jc, rph, b3 - 1.0)
    p_lo = torch.where(need_jc, rmh, b3 - 1.0)
    Jc = torch.where(
        need_jc,
        integral_R_rp_bh(b1, b2, b3, b4, p_hi, b3 + 1e-14) * cp
        - integral_R_rp_bh(b1, b2, b3, b4, p_lo, b3 + 1e-14) * cm, 0.0)
    phi_bh = 2.0 * k_cyc * Jc + torch.where(Pf <= g.Rpc, -J_y, J_y)

    # CC radial part (cumulative from infinity, Gauss in the elliptic u),
    # on the CC lanes only
    phi_cc = _on_lanes(g, is_cc,
                       lambda gc, P_: _cc_phi_radial(gc, _cc_setup(gc), P_),
                       Pz)

    phi = torch.where(is_rr, phi_rr,
          torch.where(is_rc, phi_rc,
          torch.where(is_bh, phi_bh,
          torch.where(is_cc, phi_cc, torch.nan))))

    # theta part: fully folded closed-form cumulative; anchored at P=0
    # (infinity) for from-infinity types, at the apastron P=Rpc for bound
    # RR_BH rays
    P_anchor = torch.where(is_bh, g.Rpc, torch.zeros_like(g.Rpc))
    phi = phi + (_theta_phi_cum(g, Pz) - _theta_phi_cum(g, P_anchor))
    return torch.where(torch.isfinite(P), phi, torch.nan)


def geodesic_timedelay(g: Geodesic, P1, r1c, m1c, P2, r2c, m2c):
    """Travel time between positions P1 and P2 (radial part, as in the
    reference whose theta part is disabled, sim5kerr-geod.c:663-702).

    Beyond the reference (geodesic_timedelay, sim5kerr-geod.c:559-731,
    which implements RR and RC only): bound RR_BH rays via the band
    Z1/Z2 integrals (cumulative over the 2*Rpc radial period) and CC
    plunging rays via the Gauss rule with exact far-field extraction.
    Computed in f64 whatever the dtype of `g`; the result is f64.
    """
    g = _as_f64(g)
    P1, P2 = _like(P1, g.a), _like(P2, g.a)
    r1c, r2c = _like(r1c, g.a), _like(r2c, g.a)
    swap = P1 > P2
    P1s, P2s = torch.where(swap, P2, P1), torch.where(swap, P1, P2)
    x1 = torch.where(swap, r2c, r1c)
    x2 = torch.where(swap, r1c, r2c)

    a2, rph, rmh, sq = _horizon_poles(g.a)
    is_rr = g.gtype == GEOD_TYPE_RR
    is_rc = g.gtype == GEOD_TYPE_RC
    is_bh = g.gtype == GEOD_TYPE_RR_BH
    is_cc = g.gtype == GEOD_TYPE_CC

    ra = torch.where(is_rr, g.rr[..., 0], 8.0)
    rb = torch.where(is_rr, g.rr[..., 1], 6.0)
    rc_ = torch.where(is_rr, g.rr[..., 2], 4.0)
    rd_ = torch.where(is_rr, g.rr[..., 3], 2.0)
    x1s = torch.where(is_rr & (x1 >= ra), x1, 10.0)
    x2s = torch.where(is_rr & (x2 >= ra), x2, 12.0)
    s = torch.where(((P1s > g.Rpc) & (P2s < g.Rpc))
                    | ((P1s < g.Rpc) & (P2s > g.Rpc)), 1.0, -1.0)

    def both(fn, *args):
        return fn(ra, rb, rc_, rd_, *args, x1s) + s * fn(ra, rb, rc_, rd_,
                                                         *args, x2s)

    R0 = both(integral_R_r0_re)
    R1_ = both(integral_R_r1_re)
    R2_ = both(integral_R_r2_re)
    RA = both(integral_R_rp_re, rph)
    RB = both(integral_R_rp_re, rmh)
    A = (-g.a * g.l + 4.0) * rph - 2.0 * a2
    B = (g.a * g.l - 4.0) * rmh + 2.0 * a2
    t_rr = (4.0 * torch.abs(R0) + 2.0 * torch.abs(R1_) + torch.abs(R2_)
            + (A * torch.abs(RA) + B * torch.abs(RB)) / sq)

    ta = torch.where(is_rc, g.rr[..., 0], 6.0)
    tb = torch.where(is_rc, g.rr[..., 1], 2.0)
    tu = torch.where(is_rc, g.rr[..., 2], 0.0)
    tv = torch.where(is_rc, torch.abs(g.ri[..., 2]), 1.0)
    lo = torch.where(is_rc, torch.minimum(x1, x2), 10.0)
    hi = torch.where(is_rc, torch.maximum(x1, x2), 12.0)
    R0c = (integral_R_r0_cc(ta, tb, tu, tv, lo)
           - integral_R_r0_cc(ta, tb, tu, tv, hi))
    R1c = integral_R_r1_cc(ta, tb, tu, tv, lo, hi)
    R2c = integral_R_r2_cc(ta, tb, tu, tv, lo, hi)
    RAc = integral_R_rp_cc2(ta, tb, tu, tv, rph, lo, hi)
    RBc = integral_R_rp_cc2(ta, tb, tu, tv, rmh, lo, hi)
    t_rc = (4.0 * torch.abs(R0c) + 2.0 * torch.abs(R1c) + torch.abs(R2c)
            + (A * torch.abs(RAc) + B * torch.abs(RBc)) / sq)

    # RR_BH: cumulative band time relative to the apastron passage, folded
    # over the 2*Rpc radial period (same structure as the azm band term)
    b1 = torch.where(is_bh, g.rr[..., 0], 8.0)
    b2 = torch.where(is_bh, g.rr[..., 1], 6.0)
    b3 = torch.where(is_bh, g.rr[..., 2], 4.0)
    b4 = torch.where(is_bh, g.rr[..., 3], 2.0)

    def t_band_J(y):
        """int_y^r2 (r^2 + 2r + 4 + horizon poles) dr/sqrt(R) on the band."""
        return (4.0 * integral_R_r0_bh(b1, b2, b3, b4, y)
                + 2.0 * integral_R_r1_bh(b1, b2, b3, b4, y)
                + integral_R_r2_bh(b1, b2, b3, b4, y)
                + (A * integral_R_rp_bh(b1, b2, b3, b4,
                                        torch.where(is_bh, rph, b3 - 1.0), y)
                   + B * integral_R_rp_bh(b1, b2, b3, b4,
                                          torch.where(is_bh, rmh, b3 - 1.0),
                                          y))
                / sq)

    def t_band_cum(P, rc_):
        Pz = torch.where(torch.isfinite(P), P, g.Rpc)
        k_cyc = torch.floor(Pz / (2.0 * g.Rpc))
        Pf = Pz - 2.0 * g.Rpc * k_cyc
        y = torch.minimum(torch.maximum(
            torch.where(is_bh & torch.isfinite(rc_), rc_, 5.0),
            b3 + 1e-14), b2)
        Jy = t_band_J(y)
        need = is_bh & (k_cyc != 0.0)
        Jc = torch.where(need, t_band_J(b3 + 1e-14), 0.0)
        return 2.0 * k_cyc * Jc + torch.where(Pf <= g.Rpc, -Jy, Jy)

    t_bh = torch.abs(t_band_cum(P2s, x2) - t_band_cum(P1s, x1))

    # CC: Gauss in the elliptic parameter with far-field extraction, on
    # the CC lanes only
    P1z = torch.where(torch.isfinite(P1s), P1s, 0.4 * g.Rpc)
    P2z = torch.where(torch.isfinite(P2s), P2s, 0.6 * g.Rpc)
    t_cc = _on_lanes(
        g, is_cc,
        lambda gc, p1, p2: _cc_time_radial(gc, _cc_setup(gc), p1, p2),
        P1z, P2z)

    t = torch.where(is_rr, t_rr,
        torch.where(is_rc, t_rc,
        torch.where(is_bh, t_bh,
        torch.where(is_cc, t_cc, torch.nan))))
    return torch.where(torch.isfinite(P1) & torch.isfinite(P2), t, torch.nan)


def _theta_time_cum(g: Geodesic, P):
    """Cumulative poloidal time integral  t_theta(P) = a^2 * int m(P')^2 dP'
    from the oscillation-fold base point to P (monotone increasing in P).

    From Carter's equations (E=1), the theta part of the travel time is
    int a^2 m^2 dP; each monotone segment contributes
    a * int m^2 dm / sqrt((m2m+m^2)(m2p-m^2)) = a * integral_T_m2
    (BF 213.06), folded in closed form like `_fold_pol`.  (The reference's
    own disabled draft, sim5kerr-geod.c:663-702, has a^2 * integral_T_m2,
    which counts one factor of a twice.)  Vortical rays (q < 0) use the
    dn-band integral_T_m2_dn.
    """
    qpos = g.q > 0.0
    n, dT = _theta_fold(g, P)
    m_abs = torch.abs(_theta_inv(g, torch.where(qpos, dT, 0.5 * g.Tpp)))

    m2m = torch.where(qpos, g.m2m, 1.0)             # dummy-safe
    m2p = torch.where(qpos, g.m2p, 0.5)
    x = torch.minimum(m_abs, torch.sqrt(m2p))
    M2x = integral_T_m2(m2m, m2p, x)
    M20 = integral_T_m2(m2m, m2p, torch.zeros_like(x))
    seg = torch.where(dT <= 0.5 * g.Tpp, M2x, 2.0 * M20 - M2x)
    cum_cn = g.a * (n * 2.0 * M20 + seg)

    # vortical branch: the dn-band fold of `_theta_phi_cum`
    s, j, v, c2, b2, xv = _vortical_fold(g, P)
    seg_dn = integral_T_m2_dn(c2, b2, xv)
    full_dn = 2.0 * integral_T_m2_dn(c2, b2, torch.sqrt(c2))
    segv = torch.where(v <= 0.5 * g.Tpp, seg_dn, full_dn - seg_dn)
    cum_dn = g.a * s * (j * full_dn + segv)

    return torch.where(g.q < 0.0, cum_dn, cum_cn)


def geodesic_timedelay_full(g: Geodesic, P1, r1c, m1c, P2, r2c, m2c):
    """Travel time between positions P1 and P2 including the poloidal
    (theta) term the reference leaves disabled (sim5kerr-geod.c:663-702),
    which makes light-curve delays exact at any inclination.  Vortical
    rays (q < 0) use the dn-band form of the theta term.  f64, like
    `geodesic_timedelay`.
    """
    t_rad = geodesic_timedelay(g, P1, r1c, m1c, P2, r2c, m2c)
    g = _as_f64(g)
    t_th = torch.abs(_theta_time_cum(g, _like(P2, g.a))
                     - _theta_time_cum(g, _like(P1, g.a)))
    return t_rad + t_th
