"""Jacobi elliptic functions sn, cn, dn and their inverses.

Port of `sim5_tpu/special/jacobi.py`.  The Gauss/AGM scheme of the
reference (sim5elliptic.c:536-598) runs to a fixed depth chosen by dtype
(13 levels in f64, 8 in f32) with per-element convergence masks, so a
batch evaluates in lockstep.  The inverse functions are closed forms in
Carlson RF (sim5elliptic.c:480-528).

Derivatives: `_sncndn_core` is a `torch.autograd.Function` carrying the
JAX package's rule, so a gradient never differentiates through the AGM.
The u-derivatives are algebraic in (sn, cn, dn):

    d sn/du = cn dn,   d cn/du = -sn dn,   d dn/du = -m sn cn

and the m-derivatives follow from the Jacobi epsilon function
eps(u, m) = E(am u, m):

    d sn/dm =  cn ((u(1-m) - eps) dn + m sn cn) / (2 m (1-m))
    d cn/dm = -sn ((u(1-m) - eps) dn + m sn cn) / (2 m (1-m))
    d dn/dm = -sn (sn dn + cn (u(1-m) - eps)) / (2 (1-m))

with eps from Carlson RF/RD of (cn^2, dn^2, 1) plus the quasi-period
reduction eps(u + 2nK) = eps(u) + 2nE, K and E from a second shared
chain.  Within sqrt(eps) of m = 0 or m = 1 the closed forms cancel, and
the rule takes the exact endpoint asymptotics there.  The inverse
functions differentiate through rf's rule.

Conventions: the modulus argument is m = k^2 (Byrd & Friedman), 0 <= m < 1.
"""

import math

import torch

from ..core.metric import _as_tensors
from .carlson import rf, _rd_chain, _rd_tail, _rf_tail, _tiny_for

_NAGM = 13      # f64 AGM depth (the reference's array size)
_NAGM_F32 = 8   # f32 AGM depth
_CA = 1.0e-8    # AGM convergence tolerance (reference sim5elliptic.c:544)


class _SnCnDn(torch.autograd.Function):
    """(sn, cn, dn)(u | m = 1 - emc), with the rule of the module
    docstring for backward and jvp."""

    @staticmethod
    def forward(u, emc):
        depth = _NAGM if u.dtype == torch.float64 else _NAGM_F32
        a = a0 = torch.ones_like(u)
        done = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
        l = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        c_sel = a0
        em_list, en_list = [], []
        # ascending AGM with a convergence freeze
        for i in range(depth):
            emc_s = torch.sqrt(emc)
            c = 0.5 * (a + emc_s)
            newly = torch.abs(a - emc_s) <= _CA * a
            c_sel = torch.where(done, c_sel, c)
            l = torch.where(done, l, i)
            stop = done | newly
            em_list.append(a)
            en_list.append(emc_s)
            emc = torch.where(stop, emc, emc_s * a)
            a = torch.where(stop, a, c)
            done = stop

        uu = u * c_sel
        sn = torch.sin(uu)
        cn = torch.cos(uu)
        dn = torch.ones_like(u)

        # descending Landen recurrence (masked to levels <= l)
        sn_zero = sn == 0.0
        sn_safe = torch.where(sn_zero, 1.0, sn)
        aa = cn / sn_safe
        cc = c_sel * aa
        for ii in range(depth - 1, -1, -1):
            b, en = em_list[ii], en_list[ii]
            act = (ii <= l) & ~sn_zero
            aa_n = aa * cc
            cc_n = cc * dn
            dn_n = (en + aa_n) / (b + aa_n)
            aa2 = cc_n / b
            aa = torch.where(act, aa2, aa)
            cc = torch.where(act, cc_n, cc)
            dn = torch.where(act, dn_n, dn)
        amp = 1.0 / torch.sqrt(cc * cc + 1.0)
        sn_out = torch.where(sn >= 0.0, amp, -amp)
        cn_out = cc * sn_out
        sn_out = torch.where(sn_zero, sn, sn_out)
        cn_out = torch.where(sn_zero, cn, cn_out)
        return sn_out, cn_out, dn

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)
        ctx.save_for_forward(*inputs, *output)

    @staticmethod
    def backward(ctx, g_sn, g_cn, g_dn):
        u, emc, sn, cn, dn = ctx.saved_tensors
        need_u, need_emc = ctx.needs_input_grad
        du, demc = _sncndn_partials(u, emc, sn, cn, dn, need_emc)
        gu = ((g_sn * du[0] + g_cn * du[1] + g_dn * du[2]) if need_u
              else None)
        gemc = ((g_sn * demc[0] + g_cn * demc[1] + g_dn * demc[2])
                if need_emc else None)
        return gu, gemc

    @staticmethod
    def jvp(ctx, t_u, t_emc):
        u, emc, sn, cn, dn = ctx.saved_tensors
        du, demc = _sncndn_partials(u, emc, sn, cn, dn, True)
        return tuple(a * t_u + b * t_emc for a, b in zip(du, demc))


def _sncndn_partials(u, emc, sn, cn, dn, with_emc):
    """The partial derivatives of (sn, cn, dn) in u, and in emc if
    `with_emc` (else None): the JAX package's rule (module docstring)."""
    m = 1.0 - emc
    du = (cn * dn, -sn * dn, -m * sn * cn)
    if not with_emc:
        return du, None
    dt = sn.dtype
    feps = torch.finfo(dt).eps
    # eps(u, m) via Carlson and the quasi-period reduction; each RF + RD
    # pair at shared arguments comes from one duplication chain
    one = torch.ones_like(sn)
    tiny = _tiny_for(dt)
    ct, et, ot, fac_c, s_c, _ = _rd_chain(
        torch.full_like(sn, tiny), torch.clamp(emc, min=tiny), one,
        slots=(2,))
    K = _rf_tail(ct, et, ot)
    E = K - m * (3.0 * s_c[2] + fac_c * _rd_tail(ct, et, ot)) / 3.0
    cn2, dn2 = cn * cn, dn * dn
    it_, jt_, kt_, fac_i, s_i, _ = _rd_chain(
        torch.clamp(cn2, min=tiny), torch.clamp(dn2, min=tiny), one,
        slots=(2,))
    F_inc = _rf_tail(it_, jt_, kt_)
    D_inc = 3.0 * s_i[2] + fac_i * _rd_tail(it_, jt_, kt_)
    eps_inc = sn * F_inc - (m / 3.0) * sn ** 3 * D_inc
    n = torch.floor((u + K) / (2.0 * K))
    sgn = torch.where(torch.remainder(n, 2.0) == 0.0, 1.0, -1.0)
    eps_u = 2.0 * n * E + sgn * eps_inc

    W = u * emc - eps_u
    m_s = torch.clamp(m, min=1e-30)
    emc_s = torch.clamp(emc, min=1e-30)
    N = W * dn + m * sn * cn
    g_sn = cn * N / (2.0 * m_s * emc_s)
    g_cn = -sn * N / (2.0 * m_s * emc_s)
    g_dn = -sn * (sn * dn + cn * W) / (2.0 * emc_s)

    # the exact endpoint asymptotics, O(m) and O(emc)
    ucd = u * cn * dn
    a0_sn = -(u - sn * cn) * cn / 4.0           # m -> 0
    a0_cn = sn * (u - sn * cn) / 4.0
    a0_dn = -sn * sn / 2.0
    cn_g = torch.where(torch.abs(cn) > 1e-30, cn,
                       torch.where(cn >= 0.0, 1e-30, -1e-30))
    a1_sn = -(sn - ucd) / 4.0                   # m -> 1
    a1_cn = (sn / cn_g) * (sn - ucd) / 4.0
    a1_dn = -sn * (sn + ucd) / (4.0 * torch.clamp(dn, min=1e-30))

    th = feps ** 0.5
    lo, hi = m < th, emc < th
    # d/d emc = -d/dm
    demc = tuple(-torch.where(lo, a0, torch.where(hi, a1, gm))
                 for a0, a1, gm in ((a0_sn, a1_sn, g_sn),
                                    (a0_cn, a1_cn, g_cn),
                                    (a0_dn, a1_dn, g_dn)))
    return du, demc


def _sncndn_core(u, emc):
    """(sn, cn, dn)(u | m = 1 - emc) with the complement emc as the
    parameter argument (pre-clamped to (0, 1] by the caller).

    The AGM consumes the complement directly (its seed is (1, k' =
    sqrt(emc))), so for m -> 1 the result keeps the complement's full
    relative accuracy.  (reference: sim5elliptic.c:536-598)
    """
    return _SnCnDn.apply(*torch.broadcast_tensors(u, emc))


def jacobi_sncndn(u, m, mc=None):
    """Jacobi elliptic functions (sn, cn, dn)(u | m) for 0 <= m < 1, any
    real u.  (reference: sim5elliptic.c:536-598)

    `mc`, when given, is the exact complementary parameter 1 - m computed
    cancellation-free by the caller; the AGM consumes it directly, so for
    m -> 1 the result keeps the complement's full relative accuracy.
    Broadcasts; dtype and device follow the inputs.
    """
    if mc is None:
        u, m = _as_tensors(u, m)
        # clamp m == 1 like the reference (sim5elliptic.c:542)
        m = torch.where(m >= 1.0, 0.999999999, m)
        emc = 1.0 - m
    else:
        u, m, mc = _as_tensors(u, m, mc)
        emc = torch.where(mc <= 0.0, 1e-9, mc)
    return _sncndn_core(u, emc)


def jacobi_sn(u, m):
    return jacobi_sncndn(u, m)[0]


def jacobi_cn(u, m):
    return jacobi_sncndn(u, m)[1]


def jacobi_dn(u, m):
    return jacobi_sncndn(u, m)[2]


def jacobi_isn(z, m):
    """Inverse Jacobi sn: u with sn(u|m)=z, for -1 < z < 1, 0 <= m < 1.

    (reference: sim5elliptic.c:480-486; BF 132.02/132.01 limits included)
    """
    z, m = _as_tensors(z, m)
    gen = z * rf(1.0 - z * z, 1.0 - m * z * z, torch.ones_like(z))
    m0 = torch.abs(m) < 1e-8
    m1 = torch.abs(m - 1.0) < 1e-8
    z_c = torch.clamp(z, -1.0 + 1e-15, 1.0 - 1e-15)
    return torch.where(
        m0, torch.arcsin(torch.clamp(z, -1.0, 1.0)),
        torch.where(m1, torch.log(torch.sqrt((1.0 + z_c) / (1.0 - z_c))),
                    gen))


def _elliptic_k_raw(m):
    """The complete integral K(m) by RF (legendre.py imports this module)."""
    m = torch.where(m >= 1.0, 1.0 - 1e-8, m)
    return rf(torch.zeros_like(m), 1.0 - m, torch.ones_like(m))


def _elliptic_f_sin_raw(sin_phi, m):
    s2 = sin_phi * sin_phi
    return sin_phi * rf(1.0 - s2, 1.0 - s2 * m, torch.ones_like(s2))


def jacobi_icn(z, m):
    """Inverse Jacobi cn: u with cn(u|m)=z, for -1 <= z <= 1, 0 <= m < 1.

    (reference: sim5elliptic.c:492-514; the z<0 branch follows
    functions.wolfram.com InverseJacobiCN 05)  Every special branch is
    evaluated at safe arguments, as in the JAX package.
    """
    z, m = _as_tensors(z, m)
    # snap values that are within 1e-8 outside the domain (reference
    # behaviour)
    z = torch.where((z > 1.0) & (z < 1.0 + 1e-8), 1.0, z)
    z = torch.where((z < -1.0) & (z > -1.0 - 1e-8), -1.0, z)
    m = torch.where((m > 1.0) & (m < 1.0 + 1e-8), 1.0, m)
    m = torch.where((m < 0.0) & (m > -1e-8), 0.0, m)

    az = torch.abs(z)
    az_c = torch.clamp(az, max=1.0)
    edge = (az_c >= 1.0 - 1e-15) | (az_c == 0.0)
    az_g = torch.where(edge, 0.5, az_c)
    icn1 = (torch.sqrt(1.0 - az_g * az_g)
            * rf(az_g * az_g, 1.0 - m * (1.0 - az_g * az_g),
                 torch.ones_like(az_g)))
    icn1 = torch.where(az_c >= 1.0 - 1e-15, 0.0,
                       torch.where(az_c == 0.0, _elliptic_k_raw(m), icn1))
    # z<0: icn(z) = 2/sqrt(1-m) F_sin(-z | m/(m-1)) + icn(|z|)
    m_safe = torch.where(m >= 1.0, 1.0 - 1e-12, m)
    mp = m_safe / (m_safe - 1.0 - torch.where(m_safe == 1.0, 1e-300, 0.0))
    f_gen = _elliptic_f_sin_raw(az_g, mp)
    f_lim = rf(torch.zeros_like(mp), 1.0 - mp, torch.ones_like(mp))
    neg_term = 2.0 / torch.sqrt(1.0 - m_safe) * torch.where(
        az_c >= 1.0 - 1e-15, f_lim, f_gen)
    gen = torch.where(z > 0.0, icn1, neg_term + icn1)

    m0 = m == 0.0
    m1 = m == 1.0
    z_s = torch.where(edge, 0.5, az_c)
    m1val = torch.where(az_c >= 1.0 - 1e-15, 0.0,
                        torch.log((1.0 + torch.sqrt(1.0 - z_s)) / z_s))
    acos_arg = torch.where(torch.abs(z) >= 1.0 - 1e-15, 0.0,
                           torch.clamp(z, -1.0, 1.0))
    m0val = torch.where(z >= 1.0 - 1e-15, 0.0,
                        torch.where(z <= -1.0 + 1e-15, math.pi,
                                    torch.arccos(acos_arg)))
    return torch.where(z == 0.0, _elliptic_k_raw(m),
                       torch.where(z == 1.0, 0.0,
                                   torch.where(m0, m0val,
                                               torch.where(m1, m1val, gen))))


def icn_signed(z, m):
    """Inverse Jacobi cn restricted to -1 < z < 1 and 0 < m < 1: the
    generic branches of `jacobi_icn` only (2 RF evaluations instead of 4),
    for callers that never reach the special branches."""
    z, m = _as_tensors(z, m)
    # dtype-aware domain guard (1 - 1e-12 rounds to 1 in f32)
    feps = 8.0 * torch.finfo(z.dtype).eps
    az = torch.clamp(torch.abs(z), feps, 1.0 - feps)
    icn1 = (torch.sqrt(1.0 - az * az)
            * rf(az * az, 1.0 - m * (1.0 - az * az), torch.ones_like(az)))
    m_safe = torch.clamp(m, 0.0, 1.0 - feps)
    mp = m_safe / (m_safe - 1.0)
    neg_term = 2.0 / torch.sqrt(1.0 - m_safe) * _elliptic_f_sin_raw(az, mp)
    return torch.where(z >= 0.0, icn1, neg_term + icn1)


def jacobi_itn(z, m):
    """Inverse Jacobi tn (= sn/cn): BF 131.00.  Like the reference, the
    generic branch is even in z.  (reference: sim5elliptic.c:522-528)"""
    z, m = _as_tensors(z, m)
    gen = jacobi_isn(torch.sqrt(z * z / (1.0 + z * z)), m)
    m0 = m == 0.0
    m1 = m == 1.0
    return torch.where(m0, torch.arctan(z),
                       torch.where(m1, torch.log(z + torch.sqrt(1.0 + z * z)),
                                   gen))
