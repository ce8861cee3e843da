"""Carlson's symmetric elliptic integrals RF, RD, RC and RJ.

Port of `sim5_tpu/special/carlson.py`.  The duplication runs to a fixed
depth chosen by dtype, so a batch evaluates in lockstep: 16 levels bring
any f64 argument triple to spread < 3e-4, where the 5th-order tail is
exact to f64 epsilon; 7 levels reach the f32 noise floor.
(reference: sim5elliptic.c:19-206)

Forward only: the analytic derivative rules (the JAX package's custom
JVPs) wait for the derivative layer.  The JAX package's choice between an
unrolled and a looped duplication chain is a compile-time matter there;
here both are the same Python loop.
"""

import torch

from ..core.metric import _as_tensors

_NDUP = 16        # f64 duplication depth
_NDUP_F32 = 7     # f32 duplication depth
_TINY = 1e-300    # zero floor in f64
_TINY_F32 = 1e-37


def _ndup(dtype):
    """Duplication depth for the working precision."""
    return _NDUP if dtype == torch.float64 else _NDUP_F32


def _tiny_for(dtype):
    """Zero floor of the arguments: 1e-300 in f64, 1e-37 in f32."""
    return _TINY if dtype == torch.float64 else _TINY_F32


def _rf_tail(xt, yt, zt):
    """5th-order RF series tail at the converged triple."""
    ave = (xt + yt + zt) / 3.0
    dx = (ave - xt) / ave
    dy = (ave - yt) / ave
    dz = (ave - zt) / ave
    e2 = dx * dy - dz * dz
    e3 = dx * dy * dz
    C1, C2, C3, C4 = 1.0 / 24.0, 0.1, 3.0 / 44.0, 1.0 / 14.0
    return (1.0 + (C1 * e2 - C2 - C3 * e3) * e2 + C4 * e3) / torch.sqrt(ave)


def rf(x, y, z):
    """Carlson RF(x,y,z) = 1/2 int_0^inf dt/sqrt((t+x)(t+y)(t+z)).

    x,y,z >= 0, at most one zero.  Broadcasts; dtype and device follow the
    inputs.  (reference: sim5elliptic.c:19-52)
    """
    xt, yt, zt = _as_tensors(x, y, z)
    # floor exactly-zero arguments at the zero floor (e.g. every complete
    # integral RF(0, y, 1))
    tiny = _tiny_for(xt.dtype)
    xt = torch.clamp(xt, min=tiny)
    yt = torch.clamp(yt, min=tiny)
    for _ in range(_ndup(xt.dtype)):
        sx, sy, sz = torch.sqrt(xt), torch.sqrt(yt), torch.sqrt(zt)
        lam = sx * (sy + sz) + sy * sz
        xt, yt, zt = 0.25 * (xt + lam), 0.25 * (yt + lam), 0.25 * (zt + lam)
    return _rf_tail(xt, yt, zt)


def _rd_tail(xa, xb, xc):
    """RD series tail T at the converged triple, with xc the -3/2 slot:
    RD(a,b,c) = 3*s + fac * T(a_final, b_final, c_final)."""
    ave = 0.2 * (xa + xb + 3.0 * xc)
    dx = (ave - xa) / ave
    dy = (ave - xb) / ave
    dz = (ave - xc) / ave
    C1, C2, C3, C4 = 3.0 / 14.0, 1.0 / 6.0, 9.0 / 22.0, 3.0 / 26.0
    C5, C6 = 0.25 * C3, 1.5 * C4
    ea = dx * dy
    eb = dz * dz
    ec = ea - eb
    ed = ea - 6.0 * eb
    ee = ed + ec + ec
    tail = (1.0 + ed * (-C1 + C5 * ed - C6 * dz * ee)
            + dz * (C2 * ee + dz * (-C3 * ec + dz * C4 * ea)))
    return tail / (ave * torch.sqrt(ave))


def _rd_chain(x, y, z, slots=()):
    """Duplication chain on the triple (x, y, z) carrying, for each index
    i in `slots`, the RD series accumulator
        s_i = sum_n fac_n / (sqrt(v_i) (v_i + lam)),
    so that RD with v_i in the -3/2 slot is 3 s_i + fac * tail_i.

    Returns (xt, yt, zt, fac, {i: s_i}).  (The JAX package's chain also
    carries the divided differences of its derivative rules.)
    """
    xt, yt, zt = x, y, z
    s = {i: torch.zeros_like(x) for i in slots}
    fac = torch.ones_like(x)
    for _ in range(_ndup(x.dtype)):
        vt = (xt, yt, zt)
        sq = tuple(torch.sqrt(t) for t in vt)
        lam = sq[0] * (sq[1] + sq[2]) + sq[1] * sq[2]
        s = {i: s[i] + fac / (sq[i] * (vt[i] + lam)) for i in s}
        xt, yt, zt = 0.25 * (xt + lam), 0.25 * (yt + lam), 0.25 * (zt + lam)
        fac = 0.25 * fac
    return xt, yt, zt, fac, s


def _perm_tail(xt, yt, zt, i):
    """RD tail with slot i of the (original-order) triple in the -3/2 slot
    (the derivative layer's RD coefficients come from one chain)."""
    vt = (xt, yt, zt)
    j, k = [a for a in (0, 1, 2) if a != i]
    return _rd_tail(vt[j], vt[k], vt[i])


def rd(x, y, z):
    """Carlson RD(x,y,z) = 3/2 int_0^inf dt/[(t+z)sqrt((t+x)(t+y)(t+z))].

    x,y >= 0 (at most one zero), z > 0.  (reference: sim5elliptic.c:58-98)
    """
    xt, yt, zt = _as_tensors(x, y, z)
    tiny = _tiny_for(xt.dtype)
    xt = torch.clamp(xt, min=tiny)
    yt = torch.clamp(yt, min=tiny)
    xt, yt, zt, fac, s = _rd_chain(xt, yt, zt, slots=(2,))
    return 3.0 * s[2] + fac * _perm_tail(xt, yt, zt, 2)


def _rc_pos(x, y):
    """RC core for x >= tiny, y > 0 (pre-floored by the callers)."""
    xt, yt = x, y
    for _ in range(_ndup(x.dtype)):
        lam = 2.0 * torch.sqrt(xt) * torch.sqrt(yt) + yt
        xt, yt = 0.25 * (xt + lam), 0.25 * (yt + lam)
    ave = (xt + yt + yt) / 3.0
    sv = (yt - ave) / ave
    C1, C2, C3, C4 = 0.3, 1.0 / 7.0, 0.375, 9.0 / 22.0
    return ((1.0 + sv * sv * (C1 + sv * (C2 + sv * (C3 + sv * C4))))
            / torch.sqrt(ave))


def rc(x, y):
    """Carlson degenerate RC(x,y) = RF(x,y,y).

    x >= 0, y != 0; for y < 0 the Cauchy principal value
    RC(x,y) = sqrt(x/(x-y)) RC(x-y,-y) is returned.
    (reference: sim5elliptic.c:104-137)
    """
    x, y = _as_tensors(x, y)
    neg = y < 0.0
    tiny = _tiny_for(x.dtype)
    xt0 = torch.clamp(torch.where(neg, x - y, x), min=tiny)
    yt0 = torch.where(neg, -y, torch.where(y == 0.0, tiny, y))
    w = torch.where(neg, torch.sqrt(x) / torch.sqrt(xt0), 1.0)
    return w * _rc_pos(xt0, yt0)


def _rj_pos(x, y, z, p):
    """RJ core for x,y,z >= tiny, p > 0 (pre-floored/transformed by rj)."""
    xt, yt, zt, pt = x, y, z, p
    s = torch.zeros_like(x)
    fac = torch.ones_like(x)
    for _ in range(_ndup(x.dtype)):
        sx, sy, sz = torch.sqrt(xt), torch.sqrt(yt), torch.sqrt(zt)
        lam = sx * (sy + sz) + sy * sz
        alpha = (pt * (sx + sy + sz) + sx * sy * sz) ** 2
        beta = pt * (pt + lam) ** 2
        s = s + fac * rc(alpha, beta)
        xt, yt, zt, pt = (0.25 * (xt + lam), 0.25 * (yt + lam),
                          0.25 * (zt + lam), 0.25 * (pt + lam))
        fac = 0.25 * fac
    ave = 0.2 * (xt + yt + zt + pt + pt)
    dx = (ave - xt) / ave
    dy = (ave - yt) / ave
    dz = (ave - zt) / ave
    dp = (ave - pt) / ave
    C1, C2, C3, C4 = 3.0 / 14.0, 1.0 / 3.0, 3.0 / 22.0, 3.0 / 26.0
    C5, C6, C7, C8 = 0.75 * C3, 1.5 * C4, 0.5 * C2, C3 + C3
    ea = dx * (dy + dz) + dy * dz
    eb = dx * dy * dz
    ec = dp * dp
    ed = ea - 3.0 * ec
    ee = eb + 2.0 * dp * (ea - ec)
    return 3.0 * s + fac * (1.0 + ed * (-C1 + C5 * ed - C6 * ee)
                            + eb * (C7 + dp * (-C8 + dp * C4))
                            + dp * ea * (C2 - dp * C3)
                            - C2 * dp * ec) / (ave * torch.sqrt(ave))


def rj(x, y, z, p):
    """Carlson RJ(x,y,z,p).

    x,y,z >= 0 (at most one zero), p != 0; for p < 0 the Cauchy principal
    value is returned (Carlson 1977, NR 6.11).
    (reference: sim5elliptic.c:144-206)
    """
    x, y, z, p = _as_tensors(x, y, z, p)
    neg = p < 0.0
    # p_neg is a guarded copy so the untaken branch stays finite
    p_neg = torch.where(neg, p, -1.0)
    xs = torch.minimum(torch.minimum(x, y), z)
    zs = torch.maximum(torch.maximum(x, y), z)
    ys = x + y + z - xs - zs
    ys_safe = torch.where(ys > 0.0, ys, 1.0)
    a_ = 1.0 / (ys - p_neg)
    b_ = a_ * (zs - ys) * (ys - xs)
    pt_neg = ys + b_
    rho = xs * zs / ys_safe
    tau = p_neg * pt_neg / ys_safe
    rcx = torch.where(neg, rc(rho, tau), 0.0)

    tiny = _tiny_for(x.dtype)
    xt = torch.clamp(torch.where(neg, xs, x), min=tiny)
    yt = torch.clamp(torch.where(neg, ys, y), min=tiny)
    zt = torch.clamp(torch.where(neg, zs, z), min=tiny)
    pt = torch.where(neg, pt_neg, torch.where(p == 0.0, tiny, p))

    ans = _rj_pos(xt, yt, zt, pt)
    ans_neg = a_ * (b_ * ans + 3.0 * (rcx - rf(xt, yt, zt)))
    return torch.where(neg, ans_neg, ans)
