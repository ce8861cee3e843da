"""Jacobi elliptic functions sn, cn, dn.

Port of `sim5_tpu/special/jacobi.py` (the forward functions; their
analytic derivative rules and the inverse functions wait for later
slices).  The Gauss/AGM scheme of the reference (sim5elliptic.c:536-598)
runs to a fixed depth chosen by dtype (13 levels in f64, 8 in f32) with
per-element convergence masks, so a batch evaluates in lockstep.

Conventions: the modulus argument is m = k^2 (Byrd & Friedman), 0 <= m < 1.
"""

import torch

from ..core.metric import _as_tensors

_NAGM = 13      # f64 AGM depth (the reference's array size)
_NAGM_F32 = 8   # f32 AGM depth
_CA = 1.0e-8    # AGM convergence tolerance (reference sim5elliptic.c:544)


def _sncndn_core(u, emc):
    """(sn, cn, dn)(u | m = 1 - emc) with the complement emc as the
    parameter argument (pre-clamped to (0, 1] by the caller).

    The AGM consumes the complement directly (its seed is (1, k' =
    sqrt(emc))), so for m -> 1 the result keeps the complement's full
    relative accuracy.  (reference: sim5elliptic.c:536-598)
    """
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
