"""Byrd & Friedman tabulated elliptic integrals.

Port of `sim5_tpu/special/integrals.py`: vectorized closed forms of the
reference's integral_* family (sim5elliptic.c:636-1159) used by the
azimuthal and time integrals of the analytic geodesic engine.  Equation
numbers cite Byrd & Friedman, "Handbook of Elliptic Integrals" (BF).
The arguments are tensors of one dtype and device (numbers broadcast);
results follow them.

Complex-valued intermediates of the reference (sim5elliptic.c:773) are
decomposed into explicitly real branches.
"""

import torch

from .jacobi import jacobi_sncndn, jacobi_dn, jacobi_isn, jacobi_icn
from .legendre import (elliptic_e_cos, elliptic_f_cos, elliptic_pi_cos,
                       elliptic_pi_complete)


def integral_C0(u, m):
    """int du  (BF 312.00)"""
    return u


def integral_C1(u, m):
    """int cn(u) du  (BF 312.01)"""
    dn = jacobi_dn(u, m)
    return torch.arccos(torch.clamp(dn, -1.0, 1.0)) / torch.sqrt(m)


def integral_C2(u, m):
    """int cn(u)^2 du  (BF 312.02)"""
    _, cn, _ = jacobi_sncndn(u, m)
    return (elliptic_e_cos(cn, m) - (1.0 - m) * u) / m


def integral_C2_cos(cn_u, m):
    """int cn(u)^2 du expressed via cn(u)  (BF 312.02)"""
    return (elliptic_e_cos(cn_u, m) - (1.0 - m) * elliptic_f_cos(cn_u, m)) / m


def integral_Z1(a, b, u, m):
    """int (1-b sn^2)/(1-a sn^2) du  (BF 340.01)"""
    _, cn, _ = jacobi_sncndn(u, m)
    return ((a - b) * elliptic_pi_cos(cn, a, m) + b * u) / a


def integral_Z2(a, b, u, m):
    """int (1-b sn^2)^2/(1-a sn^2)^2 du  (BF 340.02)"""
    sn, cn, dn = jacobi_sncndn(u, m)
    V1 = elliptic_pi_cos(cn, a, m)
    V2 = 0.5 / ((a - 1.0) * (m - a)) * (
        a * elliptic_e_cos(cn, m) + (m - a) * u
        + (2.0 * a * m + 2.0 * a - a * a - 3.0 * m) * V1
        - (a * a * sn * cn * dn) / (1.0 - a * sn * sn))
    ab = a - b
    return (b * b * u + 2.0 * b * ab * V1 + ab * ab * V2) / (a * a)


def integral_Rm1(a, u, m):
    """int (1 + a cn(u)) du  (BF 341.00)"""
    dn = jacobi_dn(u, m)
    return u + a / torch.sqrt(m) * torch.arccos(torch.clamp(dn, -1.0, 1.0))


def integral_Rm2(a, u, m):
    """int (1 + a cn(u))^2 du  (BF 341.01)"""
    a2 = a * a
    sn, cn, dn = jacobi_sncndn(u, m)
    acos_dn = torch.arccos(torch.clamp(dn, -1.0, 1.0))
    return ((m - a2 * (1.0 - m)) * u + a2 * elliptic_e_cos(cn, m)
            + 2.0 * a * torch.sqrt(m) * acos_dn) / m


def integral_R0(u, m):
    """int du"""
    return u


def integral_R1(a, u, m):
    """int 1/(1 + a cn(u)) du, a != 1  (BF 341.03, 361.54; see reference note
    sim5elliptic.c:755-792 about the sign of the a*f1 term)."""
    a2 = a * a
    n = a2 / (a2 - 1.0)
    sn, cn, dn = jacobi_sncndn(u, m)
    mma = (m + (1.0 - m) * a2) / (1.0 - a2)
    t = sn / dn
    # f1 = sqrt(1/mma) * atan(sqrt(mma) * t), decomposed over the sign of mma
    small = torch.abs(mma) <= 1e-5
    pos = mma > 0.0
    sp = torch.sqrt(torch.where(pos, mma, 1.0))
    f1_pos = torch.arctan(sp * t) / sp
    sn_ = torch.sqrt(torch.where(pos, 1.0, -mma))
    y = sn_ * t
    # principal branch of atanh: fold |y|>1 into atanh(1/y)
    y_in = torch.where(torch.abs(y) < 1.0, y, 1.0 / torch.where(y == 0.0, 1.0, y))
    f1_neg = -torch.arctanh(torch.clamp(y_in, -1.0 + 1e-300, 1.0 - 1e-300)) / sn_
    f1 = torch.where(small, t, torch.where(pos, f1_pos, f1_neg))
    ellpi = elliptic_pi_cos(cn, n, m)
    return (ellpi + a * f1) / (1.0 - a2)


def integral_R2(a, u, m):
    """int 1/(1 + a cn(u))^2 du, a != 1  (BF 341.04)"""
    a2 = a * a
    mma = m + (1.0 - m) * a2
    sn, cn, dn = jacobi_sncndn(u, m)
    return 1.0 / (a2 - 1.0) / mma * (
        (a2 * (2.0 * m - 1.0) - 2.0 * m) * integral_R1(a, u, m)
        + 2.0 * m * integral_Rm1(a, u, m)
        - m * integral_Rm2(a, u, m)
        + a * a2 * sn * dn / (1.0 + a * cn))


# ---------------------------------------------------------------------------
# quartic-denominator radial integrals int dx / [(x-p)^k sqrt(prod (x-r_i))]
# ---------------------------------------------------------------------------

def integral_R_r0_re(a, b, c, d, X):
    """int_a^X dx/sqrt((x-a)(x-b)(x-c)(x-d)), X > a > b > c > d  (BF 258.00)"""
    m4 = ((b - c) * (a - d)) / ((a - c) * (b - d))
    sn = torch.sqrt(((b - d) * (X - a)) / ((a - d) * (X - b)))
    return 2.0 / torch.sqrt((a - c) * (b - d)) * jacobi_isn(sn, m4)


def integral_R_r0_re_inf(a, b, c, d):
    """int_a^inf dx/sqrt((x-a)(x-b)(x-c)(x-d))  (BF 258.00)"""
    m4 = ((b - c) * (a - d)) / ((a - c) * (b - d))
    sn = torch.sqrt((b - d) / (a - d))
    return 2.0 / torch.sqrt((a - c) * (b - d)) * jacobi_isn(sn, m4)


def integral_R_r0_cc(a, b, u, v, X):
    """int_a^X dx/sqrt((x-a)(x-b)|x-c|^2), c = u+iv, X > a > b  (BF 260.00)"""
    v2 = v * v
    A = torch.sqrt((a - u) ** 2 + v2)
    B = torch.sqrt((b - u) ** 2 + v2)
    m2 = ((A + B) ** 2 - (a - b) ** 2) / (4.0 * A * B)
    cn = (X * (A - B) + a * B - b * A) / (X * (A + B) - a * B - b * A)
    return jacobi_icn(cn, m2) / torch.sqrt(A * B)


def integral_R_r0_cc_inf(a, b, u, v):
    """int_a^inf dx/sqrt((x-a)(x-b)|x-c|^2), c = u+iv  (BF 260.00)"""
    v2 = v * v
    A = torch.sqrt((a - u) ** 2 + v2)
    B = torch.sqrt((b - u) ** 2 + v2)
    m2 = ((A + B) ** 2 - (a - b) ** 2) / (4.0 * A * B)
    cn = (A - B) / (A + B)
    return jacobi_icn(cn, m2) / torch.sqrt(A * B)


def integral_R_r1_re(a, b, c, d, X):
    """int_a^X x dx/sqrt(...)  (BF 258.11)"""
    m2 = ((b - c) * (a - d)) / ((a - c) * (b - d))
    sn = torch.sqrt(((b - d) * (X - a)) / ((a - d) * (X - b)))
    u = jacobi_isn(sn, m2)
    a2 = (a - d) / (b - d)
    b2 = ((a - d) * b) / (a * (b - d))
    Z = integral_Z1(a2, b2, u, m2) - integral_Z1(a2, b2, torch.zeros_like(u), m2)
    return a * 2.0 / torch.sqrt((a - c) * (b - d)) * Z


def integral_R_r1_cc(a, b, u, v, X1, X2):
    """int_X1^X2 x dx/sqrt((x-a)(x-b)|x-c|^2), c = u+iv  (BF 260.03)"""
    v2 = v * v
    A = torch.sqrt((a - u) ** 2 + v2)
    B = torch.sqrt((b - u) ** 2 + v2)
    m = ((A + B) ** 2 - (a - b) ** 2) / (4.0 * A * B)
    g = 1.0 / torch.sqrt(A * B)
    alpha1 = (B * a + b * A) / (B * a - b * A)
    alpha2 = (B + A) / (B - A)
    u1 = elliptic_f_cos((X1 * (A - B) + a * B - b * A) / (X1 * (A + B) - a * B - b * A), m)
    u2 = elliptic_f_cos((X2 * (A - B) + a * B - b * A) / (X2 * (A + B) - a * B - b * A), m)
    t0 = alpha1 * (u2 - u1)
    t1 = (alpha2 - alpha1) * (integral_R1(alpha2, u2, m) - integral_R1(alpha2, u1, m))
    return (B * a - b * A) / (B + A) * g * (t0 + t1)


def integral_R_r2_re(a, b, c, d, X):
    """int_a^X x^2 dx/sqrt(...)  (BF 258.11)"""
    m2 = ((b - c) * (a - d)) / ((a - c) * (b - d))
    sn = torch.sqrt(((b - d) * (X - a)) / ((a - d) * (X - b)))
    u = jacobi_isn(sn, m2)
    a2 = (a - d) / (b - d)
    b2 = ((a - d) * b) / (a * (b - d))
    Z = integral_Z2(a2, b2, u, m2) - integral_Z2(a2, b2, torch.zeros_like(u), m2)
    return a * a * 2.0 / torch.sqrt((a - c) * (b - d)) * Z


def integral_R_r2_cc(a, b, u, v, X1, X2):
    """int_X1^X2 x^2 dx/sqrt((x-a)(x-b)|x-c|^2), c = u+iv  (BF 260.03)"""
    v2 = v * v
    A = torch.sqrt((a - u) ** 2 + v2)
    B = torch.sqrt((b - u) ** 2 + v2)
    m = ((A + B) ** 2 - (a - b) ** 2) / (4.0 * A * B)
    g = 1.0 / torch.sqrt(A * B)
    alpha1 = (B * a + b * A) / (B * a - b * A)
    alpha2 = (B + A) / (B - A)
    u1 = elliptic_f_cos((X1 * (A - B) + a * B - b * A) / (X1 * (A + B) - a * B - b * A), m)
    u2 = elliptic_f_cos((X2 * (A - B) + a * B - b * A) / (X2 * (A + B) - a * B - b * A), m)
    t0 = alpha1 ** 2 * (u2 - u1)
    t1 = 2.0 * alpha1 * (alpha2 - alpha1) * (integral_R1(alpha2, u2, m) - integral_R1(alpha2, u1, m))
    t2 = (alpha2 - alpha1) ** 2 * (integral_R2(alpha2, u2, m) - integral_R2(alpha2, u1, m))
    return ((B * a - b * A) / (B + A)) ** 2 * g * (t0 + t1 + t2)


def integral_R_rp_re(a, b, c, d, p, X):
    """int_a^X dx/[(x-p) sqrt((x-a)(x-b)(x-c)(x-d))]  (BF 258.39)"""
    m2 = ((b - c) * (a - d)) / ((a - c) * (b - d))
    sn = torch.sqrt(((b - d) * (X - a)) / ((a - d) * (X - b)))
    u1 = jacobi_isn(sn, m2)
    a2 = (a - d) / (b - d)
    c2 = ((p - b) * (a - d)) / ((p - a) * (b - d))
    Z = integral_Z1(c2, a2, u1, m2) - integral_Z1(c2, a2, torch.zeros_like(u1), m2)
    return -2.0 / torch.sqrt((a - c) * (b - d)) / (p - a) * Z


def integral_R_rp_re_inf(a, b, c, d, p):
    """int_a^inf dx/[(x-p) sqrt((x-a)(x-b)(x-c)(x-d))]  (BF 258.39)"""
    m2 = ((b - c) * (a - d)) / ((a - c) * (b - d))
    sn = torch.sqrt((b - d) / (a - d))
    u1 = jacobi_isn(sn, m2)
    a2 = (a - d) / (b - d)
    c2 = ((p - b) * (a - d)) / ((p - a) * (b - d))
    Z = integral_Z1(c2, a2, u1, m2) - integral_Z1(c2, a2, torch.zeros_like(u1), m2)
    return -2.0 / torch.sqrt((a - c) * (b - d)) / (p - a) * Z


def integral_R_rp_cc2(a, b, u, v, p, X1, X2):
    """int_X1^X2 dx/[(x-p) sqrt((x-a)(x-b)|x-c|^2)], c = u+iv  (BF 260.04)"""
    v2 = v * v
    A = torch.sqrt((a - u) ** 2 + v2)
    B = torch.sqrt((b - u) ** 2 + v2)
    m = ((A + B) ** 2 - (a - b) ** 2) / (4.0 * A * B)
    g = 1.0 / torch.sqrt(A * B)
    alpha1 = (B * a + b * A - p * A - p * B) / (B * a - b * A + p * A - p * B)
    alpha2 = (B + A) / (B - A)
    u1 = elliptic_f_cos((X1 * (A - B) + a * B - b * A) / (X1 * (A + B) - a * B - b * A), m)
    u2 = elliptic_f_cos((X2 * (A - B) + a * B - b * A) / (X2 * (A + B) - a * B - b * A), m)
    t0 = alpha2 * (u2 - u1)
    t1 = (alpha1 - alpha2) * (integral_R1(alpha1, u2, m) - integral_R1(alpha1, u1, m))
    return (B - A) * g / (B * a + b * A - p * A - p * B) * (t0 + t1)


def integral_R_rp_cc2_inf(a, b, u, v, p, X1):
    """int_X1^inf dx/[(x-p) sqrt((x-a)(x-b)|x-c|^2)], c = u+iv  (BF 260.04)"""
    v2 = v * v
    A = torch.sqrt((a - u) ** 2 + v2)
    B = torch.sqrt((b - u) ** 2 + v2)
    m = ((A + B) ** 2 - (a - b) ** 2) / (4.0 * A * B)
    g = 1.0 / torch.sqrt(A * B)
    alpha1 = (B * a + b * A - p * A - p * B) / (B * a - b * A + p * A - p * B)
    alpha2 = (B + A) / (B - A)
    u1 = elliptic_f_cos((X1 * (A - B) + a * B - b * A) / (X1 * (A + B) - a * B - b * A), m)
    u2 = elliptic_f_cos((A - B) / (A + B), m)
    t0 = alpha2 * (u2 - u1)
    t1 = (alpha1 - alpha2) * (integral_R1(alpha1, u2, m) - integral_R1(alpha1, u1, m))
    return (B - A) * g / (B * a + b * A - p * A - p * B) * (t0 + t1)


# ---------------------------------------------------------------------------
# bound-band radial integrals (four real roots r1 > r2 >= Y >= r3 > r4,
# integration on the inner band [Y, r2] where R(x) =
# (r1-x)(r2-x)(x-r3)(x-r4) >= 0).  BF 256-series via the rational sn^2 map
# w = kappa sn^2, r = (r2 - w r1)/(1 - w), kappa = (r2-r3)/(r1-r3)
# (the map of geodesic_position_rad's RR_BH inversion), under which
# dx/sqrt(R) = c4 du and every integrand becomes a Z1/Z2 form.
# No reference equivalent: sim5elliptic.c has only the from-infinity
# r >= r1 forms, and the engine NaNs the RR_BH type outright
# (sim5kerr-geod.c:322,489,600).
# ---------------------------------------------------------------------------

def _band_setup(r1, r2, r3, r4, Y):
    mm4 = ((r2 - r3) * (r1 - r4)) / ((r2 - r4) * (r1 - r3))
    c4 = 2.0 / torch.sqrt((r1 - r3) * (r2 - r4))
    kappa = (r2 - r3) / (r1 - r3)
    sn = torch.sqrt(torch.clamp(
        (r1 - r3) / (r2 - r3) * (r2 - Y) / (r1 - Y), 0.0, 1.0))
    u = jacobi_isn(sn, mm4)
    return mm4, c4, kappa, u


def integral_R_r0_bh(r1, r2, r3, r4, Y):
    """int_Y^r2 dx/sqrt(R) on the bound band (BF 256.00)."""
    _, c4, _, u = _band_setup(r1, r2, r3, r4, Y)
    return c4 * u


def integral_R_r1_bh(r1, r2, r3, r4, Y):
    """int_Y^r2 x dx/sqrt(R) on the bound band."""
    mm4, c4, kappa, u = _band_setup(r1, r2, r3, r4, Y)
    return c4 * r2 * integral_Z1(kappa, kappa * r1 / r2, u, mm4)


def integral_R_r2_bh(r1, r2, r3, r4, Y):
    """int_Y^r2 x^2 dx/sqrt(R) on the bound band."""
    mm4, c4, kappa, u = _band_setup(r1, r2, r3, r4, Y)
    return c4 * r2 ** 2 * integral_Z2(kappa, kappa * r1 / r2, u, mm4)


def integral_R_rp_bh(r1, r2, r3, r4, p, Y):
    """int_Y^r2 dx/[(x-p) sqrt(R)] on the bound band.

    1/(x-p) maps to (1 - kappa sn^2)/((r2-p)(1 - n sn^2)) with
    n = kappa (r1-p)/(r2-p); diverges (physically) iff p lies inside
    [Y, r2] -- a horizon crossing.
    """
    mm4, c4, kappa, u = _band_setup(r1, r2, r3, r4, Y)
    n = kappa * (r1 - p) / (r2 - p)
    return c4 / (r2 - p) * integral_Z1(n, kappa, u, mm4)


# ---------------------------------------------------------------------------
# angular (T) integrals int dx / [(p - x^2)^k sqrt((a^2+x^2)(b^2-x^2))]
# ---------------------------------------------------------------------------

def integral_T_m0(a2, b2, X):
    """int_X^b dx/sqrt((a^2+x^2)(b^2-x^2)), b > X >= 0  (BF 213.00)"""
    m = b2 / (a2 + b2)
    return jacobi_icn(X / torch.sqrt(b2), m) / torch.sqrt(a2 + b2)


def integral_T_m2(a2, b2, X):
    """int_X^b x^2 dx/sqrt((a^2+x^2)(b^2-x^2)), b > X >= 0  (BF 213.06)"""
    m = b2 / (a2 + b2)
    cn = X / torch.sqrt(b2)
    return b2 / torch.sqrt(a2 + b2) * (integral_C2_cos(cn, m)
                                     - integral_C2(torch.zeros_like(cn), m))


# --- dn-form angular integrals for vortical (q < 0) poloidal motion:
# int dx / [(p - x^2)^k sqrt((x^2 - c^2)(b^2 - x^2))], 0 < c <= X <= b.
# The oscillation variable is x = b*dn(u | mm) with mm = (b^2-c^2)/b^2
# (BF 233.00 band b >= x >= c), so sn^2(u) = (1 - x^2/b^2)/mm and
# dx/sqrt((x^2-c^2)(b^2-x^2)) = -du/b.  The reference has no q < 0
# machinery at all (its cn-form integral_T_* are invalid there,
# sim5elliptic.c:1119-1159); these close that gap.

def _dn_amplitude_cos(c2, b2, X):
    """cos(am(u)) for the dn-band map x = b*dn(u|mm) at x = X."""
    mm = (b2 - c2) / b2
    sn2 = torch.clamp((1.0 - X * X / b2) / mm, 0.0, 1.0)
    return torch.sqrt(1.0 - sn2), mm


def integral_T_m0_dn(c2, b2, X):
    """int_X^b dx/sqrt((x^2-c^2)(b^2-x^2)), c <= X <= b  (BF 233.00)"""
    cn, mm = _dn_amplitude_cos(c2, b2, X)
    return elliptic_f_cos(cn, mm) / torch.sqrt(b2)


def integral_T_m2_dn(c2, b2, X):
    """int_X^b x^2 dx/sqrt((x^2-c^2)(b^2-x^2))  (BF 233.03: b^2 int dn^2 du
    = b^2 E(am u)); equals b*E(am(u(X)) | mm)."""
    cn, mm = _dn_amplitude_cos(c2, b2, X)
    return torch.sqrt(b2) * elliptic_e_cos(cn, mm)


def integral_T_mp_dn(c2, b2, p, X):
    """int_X^b dx/[(p-x^2) sqrt((x^2-c^2)(b^2-x^2))], p > b^2 or p < c^2
    (BF 233.02).  p - x^2 = (p-b^2)(1 - n sn^2) with n = -b^2 mm/(p-b^2)."""
    cn, mm = _dn_amplitude_cos(c2, b2, X)
    n = -b2 * mm / (p - b2)
    return elliptic_pi_cos(cn, n, mm) / (torch.sqrt(b2) * (p - b2))


def integral_T_mp(a2, b2, p, X):
    """int_X^b dx/[(p-x^2) sqrt((a^2+x^2)(b^2-x^2))], -b <= X <= b  (BF 213.02)"""
    m = b2 / (a2 + b2)
    n = b2 / (b2 - p)
    pos = X >= 0.0
    aX = torch.abs(X) / torch.sqrt(b2)
    pi_pos = elliptic_pi_cos(aX, n, m)
    val_pos = pi_pos / torch.sqrt(a2 + b2) / (p - b2)
    val_neg = (2.0 * elliptic_pi_complete(n, m) - pi_pos) / torch.sqrt(a2 + b2) / (p - b2)
    return torch.where(pos, val_pos, val_neg)
