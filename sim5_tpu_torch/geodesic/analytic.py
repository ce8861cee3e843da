"""Closed-form (analytic) null-geodesic engine for Kerr spacetime.

Port of `sim5_tpu/geodesic/analytic.py`, the part that seeds the volume
march: initialisation from impact parameters at infinity, the position
integral P(r), its radial and poloidal inversions r(P), m(P), the sign of
dm/dP and the photon momentum at P.  The azimuth and time-delay integrals
wait for a later slice.

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

import math

import torch

from ..core import photon_momentum
from ..core.metric import _as_tensors
from ..special import (quartic_roots, sort_quartic_roots,
                       polish_quartic_real_roots_df, rf, elliptic_k_mc,
                       jacobi_sncndn)
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
