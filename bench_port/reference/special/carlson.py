"""Carlson's symmetric elliptic integrals RF, RD, RC and RJ.

Port of `sim5_tpu/special/carlson.py`.  The duplication runs to a fixed
depth chosen by dtype, so a batch evaluates in lockstep: 16 levels bring
any f64 argument triple to spread < 3e-4, where the 5th-order tail is
exact to f64 epsilon; 7 levels reach the f32 noise floor.
(reference: sim5elliptic.c:19-206)

Derivatives: `rf`, `rd` and the cores of `rc` and `rj` are
`torch.autograd.Function`s whose backward and forward-mode (jvp) rules are
the JAX package's custom JVPs, built on the closed forms

    dRF/dx = -RD(y,z,x)/6              (DLMF 19.18.1)
    dRC/dx = -RD(y,y,x)/6,  dRC/dy = -RD(x,y,y)/3
    dRD/dx = -(RD(y,z,x) - RD(x,y,z)) / (2(z-x))   (partial fractions)
    dRJ/dx = -(RD(y,z,x) - RJ) / (2(p-x)),  dRJ/dp by Euler homogeneity

so a gradient evaluates O(1) extra special functions instead of
differentiating through the duplication chain.  Every RD coefficient of a
rule comes from ONE shared duplication chain (`_rd_chain`), and the RD
divided difference of `rd`'s rule is carried through the chain free of
cancellation: (RD(y,z,x) - RD(x,y,z))/(z-x) = 3 G + fac (T_x - T_z)/(z-x)
with every term of G positive (see the JAX package's module docstring).
A slot floored at the zero floor gets a zero coefficient, as under
`jnp.maximum`.  The rules are linear in the tangents, so one coefficient
function serves backward and jvp.  The JAX package's choice between an
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


def _rd_chain(x, y, z, slots=(), diffs=()):
    """Shared duplication chain on the triple (x, y, z).

    slots: indices i in (0,1,2) whose RD series accumulator
        s_i = sum_n fac_n / (sqrt(v_i) (v_i + lam))
    is carried (RD with v_i in the -3/2 slot is 3 s_i + fac * tail_i).

    diffs: pairs (i, j) for which the cancellation-free divided-difference
    accumulator G_ij is carried, with
        s_i - s_j = (v_j0 - v_i0) * G_ij
    exactly in real arithmetic (module docstring).

    Returns (xt, yt, zt, fac, {i: s_i}, {(i,j): G_ij}).
    """
    xt, yt, zt = x, y, z
    s = {i: torch.zeros_like(x) for i in slots}
    g = {ij: torch.zeros_like(x) for ij in diffs}
    fac = torch.ones_like(x)
    gfac = torch.ones_like(x)
    for _ in range(_ndup(x.dtype)):
        vt = (xt, yt, zt)
        sq = tuple(torch.sqrt(t) for t in vt)
        lam = sq[0] * (sq[1] + sq[2]) + sq[1] * sq[2]
        s = {i: s[i] + fac / (sq[i] * (vt[i] + lam)) for i in s}
        gn = {}
        for (i, j) in g:
            num = lam + vt[i] + vt[j] + sq[i] * sq[j]
            den = ((sq[i] + sq[j]) * sq[i] * sq[j]
                   * (vt[i] + lam) * (vt[j] + lam))
            gn[(i, j)] = g[(i, j)] + gfac * num / den
        g = gn
        xt, yt, zt = 0.25 * (xt + lam), 0.25 * (yt + lam), 0.25 * (zt + lam)
        fac = 0.25 * fac
        gfac = gfac / 16.0
    return xt, yt, zt, fac, s, g


def _perm_tail(xt, yt, zt, i):
    """RD tail with slot i of the (original-order) triple in the -3/2 slot
    (the derivative rules' RD coefficients come from one chain)."""
    vt = (xt, yt, zt)
    j, k = [a for a in (0, 1, 2) if a != i]
    return _rd_tail(vt[j], vt[k], vt[i])


class _Rule(torch.autograd.Function):
    """A function with a closed-form derivative rule: `forward(*args)` is
    the value and `coefs(*args, value)` its partial derivatives, one a
    tensor argument (the inputs are broadcast to one shape first).  The
    rule is linear in the tangents, so `backward` and `jvp` share it."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)
        ctx.save_for_forward(*inputs, output)

    @classmethod
    def backward(cls, ctx, grad):
        *args, val = ctx.saved_tensors
        cs = cls.coefs(*args, val)
        return tuple(grad * c if need else None
                     for c, need in zip(cs, ctx.needs_input_grad))

    @classmethod
    def jvp(cls, ctx, *tangents):
        *args, val = ctx.saved_tensors
        out = torch.zeros_like(val)
        for c, t in zip(cls.coefs(*args, val), tangents):
            out = out + c * t
        return out

    @classmethod
    def call(cls, *args):
        return cls.apply(*torch.broadcast_tensors(*args))


class _RF(_Rule):
    @staticmethod
    def forward(x, y, z):
        # floor exactly-zero arguments at the zero floor (e.g. every
        # complete integral RF(0, y, 1)); the rule zeroes the coefficient
        # of a floored slot
        tiny = _tiny_for(x.dtype)
        xt = torch.clamp(x, min=tiny)
        yt = torch.clamp(y, min=tiny)
        zt = z
        for _ in range(_ndup(xt.dtype)):
            sx, sy, sz = torch.sqrt(xt), torch.sqrt(yt), torch.sqrt(zt)
            lam = sx * (sy + sz) + sy * sz
            xt, yt, zt = (0.25 * (xt + lam), 0.25 * (yt + lam),
                          0.25 * (zt + lam))
        return _rf_tail(xt, yt, zt)

    @staticmethod
    def coefs(x, y, z, val):
        """dRF/dx_i = -RD(., ., x_i)/6, the three RDs from one chain."""
        tiny = _tiny_for(x.dtype)
        x0 = torch.clamp(x, min=tiny)
        y0 = torch.clamp(y, min=tiny)
        xt, yt, zt, fac, s, _ = _rd_chain(x0, y0, z, slots=(0, 1, 2))
        cs = [-(3.0 * s[i] + fac * _perm_tail(xt, yt, zt, i)) / 6.0
              for i in range(3)]
        cs[0] = torch.where(x < tiny, 0.0, cs[0])
        cs[1] = torch.where(y < tiny, 0.0, cs[1])
        return cs


def rf(x, y, z):
    """Carlson RF(x,y,z) = 1/2 int_0^inf dt/sqrt((t+x)(t+y)(t+z)).

    x,y,z >= 0, at most one zero.  Broadcasts; dtype and device follow the
    inputs.  Derivatives: dRF/dx_i = -RD(.,.,x_i)/6 (module docstring).
    (reference: sim5elliptic.c:19-52)
    """
    return _RF.call(*_as_tensors(x, y, z))


class _RD(_Rule):
    @staticmethod
    def forward(x, y, z):
        tiny = _tiny_for(x.dtype)
        xt = torch.clamp(x, min=tiny)
        yt = torch.clamp(y, min=tiny)
        xt, yt, zt, fac, s, _ = _rd_chain(xt, yt, z, slots=(2,))
        return 3.0 * s[2] + fac * _perm_tail(xt, yt, zt, 2)

    @staticmethod
    def coefs(x, y, z, val):
        """Divided differences through the shared chain, free of
        cancellation, and Euler homogeneity for the z slot."""
        tiny = _tiny_for(x.dtype)
        x0 = torch.clamp(x, min=tiny)
        y0 = torch.clamp(y, min=tiny)
        xt, yt, zt, fac, s, g = _rd_chain(
            x0, y0, z, slots=(0, 1, 2), diffs=((0, 2), (1, 2)))
        T = [_perm_tail(xt, yt, zt, i) for i in range(3)]

        def ddiff(i):
            # (RD(.., x_i in the -3/2 slot) - RD)/(z - x_i): s_i - s_2 =
            # (z0 - v_i0) G_i2 exactly; the tail quotient is fac-suppressed
            d = z - (x0 if i == 0 else y0)
            nz = d != 0.0
            tq = torch.where(nz, (T[i] - T[2]) / torch.where(nz, d, 1.0),
                             0.0)
            return 3.0 * g[(i, 2)] + fac * tq

        cx = torch.where(x < tiny, 0.0, -0.5 * ddiff(0))
        cy = torch.where(y < tiny, 0.0, -0.5 * ddiff(1))
        cz = (-1.5 * val - x0 * cx - y0 * cy) / z
        return cx, cy, cz


def rd(x, y, z):
    """Carlson RD(x,y,z) = 3/2 int_0^inf dt/[(t+z)sqrt((t+x)(t+y)(t+z))].

    x,y >= 0 (at most one zero), z > 0.  Derivatives: partial fractions
    through the shared chain, and homogeneity for z (module docstring).
    (reference: sim5elliptic.c:58-98)
    """
    return _RD.call(*_as_tensors(x, y, z))


class _RCPos(_Rule):
    @staticmethod
    def forward(x, y):
        xt, yt = x, y
        for _ in range(_ndup(x.dtype)):
            lam = 2.0 * torch.sqrt(xt) * torch.sqrt(yt) + yt
            xt, yt = 0.25 * (xt + lam), 0.25 * (yt + lam)
        ave = (xt + yt + yt) / 3.0
        sv = (yt - ave) / ave
        C1, C2, C3, C4 = 0.3, 1.0 / 7.0, 0.375, 9.0 / 22.0
        return ((1.0 + sv * sv * (C1 + sv * (C2 + sv * (C3 + sv * C4))))
                / torch.sqrt(ave))

    @staticmethod
    def coefs(x, y, val):
        """dRC/dx = -RD(y,y,x)/6, dRC/dy = -RD(x,y,y)/3, from one chain on
        (x, y, y)."""
        xt, yt, zt, fac, s, _ = _rd_chain(x, y, y, slots=(0, 1))
        cx = -(3.0 * s[0] + fac * _perm_tail(xt, yt, zt, 0)) / 6.0
        cy = -(3.0 * s[1] + fac * _perm_tail(xt, yt, zt, 1)) / 3.0
        return cx, cy


def _rc_pos(x, y):
    """RC core for x >= tiny, y > 0 (pre-floored by the callers), with its
    derivative rule."""
    return _RCPos.call(x, y)


def rc(x, y):
    """Carlson degenerate RC(x,y) = RF(x,y,y).

    x >= 0, y != 0; for y < 0 the Cauchy principal value
    RC(x,y) = sqrt(x/(x-y)) RC(x-y,-y) is returned.  Derivatives flow
    through `_rc_pos`'s rule; the principal-value transform is plain
    differentiable algebra.  (reference: sim5elliptic.c:104-137)
    """
    x, y = _as_tensors(x, y)
    neg = y < 0.0
    tiny = _tiny_for(x.dtype)
    xt0 = torch.clamp(torch.where(neg, x - y, x), min=tiny)
    yt0 = torch.where(neg, -y, torch.where(y == 0.0, tiny, y))
    w = torch.where(neg, torch.sqrt(x) / torch.sqrt(xt0), 1.0)
    return w * _rc_pos(xt0, yt0)


class _RJPos(_Rule):
    @staticmethod
    def forward(x, y, z, p):
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

    @staticmethod
    def coefs(x, y, z, p, val):
        """dRJ/dx_i = -(RD(.,.,x_i) - RJ)/(2(p - x_i)), the RDs from one
        chain, dRJ/dp by homogeneity.  The divided differences are guarded
        at p ~ x_i (|p - x_i| < sqrt(eps) scale), as in the JAX package;
        no call site approaches that coincidence."""
        xt, yt, zt, fac, s, _ = _rd_chain(x, y, z, slots=(0, 1, 2))
        R = [3.0 * s[i] + fac * _perm_tail(xt, yt, zt, i) for i in range(3)]
        eps_c = torch.finfo(val.dtype).eps ** 0.5

        def coef(i, v):
            d = p - v
            scale = eps_c * (p + v)
            d_safe = torch.where(torch.abs(d) < scale,
                                 torch.where(d < 0.0, -scale, scale), d)
            return -0.5 * (R[i] - val) / d_safe

        cs = [coef(0, x), coef(1, y), coef(2, z)]
        cs.append((-1.5 * val - x * cs[0] - y * cs[1] - z * cs[2]) / p)
        return cs


def _rj_pos(x, y, z, p):
    """RJ core for x,y,z >= tiny, p > 0 (pre-floored/transformed by rj),
    with its derivative rule."""
    return _RJPos.call(x, y, z, p)


def rj(x, y, z, p):
    """Carlson RJ(x,y,z,p).

    x,y,z >= 0 (at most one zero), p != 0; for p < 0 the Cauchy principal
    value is returned (Carlson 1977, NR 6.11).  Derivatives flow through
    `_rj_pos`'s rule; the principal-value transform is differentiable
    algebra over rc and rf, which carry their own rules.
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
