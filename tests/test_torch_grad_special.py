"""The derivative rules of the port's special functions: the
`torch.autograd.Function`s of `rf`, `rd`, `rc`, `rj` (their cores) and
`_sncndn_core`, and `rtbis_implicit`, against central differences, against
`jax.grad` / `jax.jvp` of the same JAX function, and backward against
forward mode.

Points: those of `tests/test_grad_special.py`, the zero-argument case of
its :77-87 included.  Tolerances, and why:
* against FD: 1e-8 relative (FD's own noise floor at these steps is
  ~1e-9), the Jacobi ones as there (1e-6 midrange; 1e-4 on the endpoint
  branches, where FD is the limit);
* against JAX: 1e-10 relative (the same closed-form rules on the same f64
  chains; only the order of a few products differs);
* backward against forward mode: 1e-12 of the scale, as :49 (one rule
  serves both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from sim5_tpu import special as jsp
from sim5_tpu.special import roots as jroots
from sim5_tpu_torch import special as tsp
from sim5_tpu_torch.special import roots as troots

torch.set_num_threads(2)

GATE = 1e-8


def _t(v):
    return torch.tensor(float(v), dtype=torch.float64)


def _rev(f, p, i):
    args = [_t(v).requires_grad_(k == i) for k, v in enumerate(p)]
    g, = torch.autograd.grad(f(*args).sum(), args[i])
    return float(g)


def _fwd(f, p, i):
    with fwAD.dual_level():
        args = [fwAD.make_dual(_t(v), _t(1.0)) if k == i else _t(v)
                for k, v in enumerate(p)]
        out = fwAD.unpack_dual(f(*args)).tangent
    return float(out.sum())


def _fd(f, p, i, h):
    a = list(p)
    a[i] = p[i] + h
    fp = float(f(*map(_t, a)))
    a[i] = p[i] - h
    fm = float(f(*map(_t, a)))
    return (fp - fm) / (2.0 * h)


def _jax(fj, p, i):
    g_rev = jax.grad(lambda *a: jnp.sum(fj(*a)), argnums=i)(
        *map(jnp.float64, p))
    _, g_fwd = jax.jvp(lambda v: fj(*(p[:i] + (v,) + p[i + 1:])),
                       (jnp.float64(p[i]),), (jnp.float64(1.0),))
    return float(g_rev), float(g_fwd)


def _check(ft, fj, p, n_args, h_rel=1e-5):
    for i in range(n_args):
        rev, fwd = _rev(ft, p, i), _fwd(ft, p, i)
        h = h_rel * max(abs(p[i]), 1e-3)
        fd = _fd(ft, p, i, h)
        scale = max(abs(fd), 1e-12)
        assert abs(rev - fd) / scale < GATE, (ft.__name__, i, p, rev, fd)
        assert abs(fwd - fd) / scale < GATE, (ft.__name__, i, p, fwd, fd)
        assert abs(rev - fwd) <= 1e-12 * scale + 1e-300, (i, p, rev, fwd)
        j_rev, j_fwd = _jax(fj, p, i)
        assert abs(rev - j_rev) <= 1e-10 * abs(j_rev) + 1e-300, (
            ft.__name__, i, p, rev, j_rev)
        assert abs(fwd - j_fwd) <= 1e-10 * abs(j_fwd) + 1e-300, (
            ft.__name__, i, p, fwd, j_fwd)


CARLSON = [
    ("rf", 3, 1e-5, [(0.3, 1.7, 1.0), (2.0, 2.0, 2.0), (1e-3, 0.5, 1.0),
                     (5.0, 0.01, 1.0), (0.7, 0.7 + 1e-12, 1.0)]),
    # argument coincidences x == z and y ~ z: the divided differences
    # through the shared chain
    ("rd", 3, 1e-5, [(0.3, 1.7, 1.0), (1.0, 1.0, 1.0),
                     (2.0, 0.5, 0.5 + 1e-11), (1e-3, 3.0, 1.0),
                     (1.0, 2.0, 1.0)]),
    # positive and principal-value (y < 0) branches
    ("rc", 2, 1e-5, [(0.5, 2.0), (2.0, 0.1), (0.8, -1.5), (1e-3, 1.0)]),
    # positive and principal-value (p < 0) branches
    ("rj", 4, 1e-6, [(0.3, 1.7, 1.0, 2.5), (0.5, 1.0, 2.0, 0.25),
                     (1.0, 1.0, 1.0, 3.0), (0.2, 0.9, 1.4, -0.7)]),
]


class TestCarlsonRules:
    @pytest.mark.parametrize("name,n_args,h_rel,pts", CARLSON,
                             ids=[c[0] for c in CARLSON])
    def test_rule(self, name, n_args, h_rel, pts):
        for p in pts:
            _check(getattr(tsp, name), getattr(jsp, name), p, n_args, h_rel)

    def test_rf_zero_arg_tangent_is_zero(self):
        # RF(0, y, 1): the floored slot's coefficient is zero, so the
        # derivative through a constant zero first argument stays finite
        def k(m):
            return tsp.rf(torch.zeros_like(m), 1.0 - m, torch.ones_like(m))
        rev = _rev(k, (0.3,), 0)
        fwd = _fwd(k, (0.3,), 0)
        fd = _fd(k, (0.3,), 0, 1e-6)
        assert np.isfinite(rev) and np.isfinite(fwd)
        assert abs(rev - fd) / abs(fd) < GATE
        assert abs(rev - fwd) <= 1e-12 * abs(fd)
        jg = float(jax.grad(lambda m: jsp.rf(jnp.float64(0.0), 1.0 - m,
                                             jnp.float64(1.0)))(
            jnp.float64(0.3)))
        assert abs(rev - jg) <= 1e-10 * abs(jg)
        # and the coefficient of the floored slot itself is zero
        x = torch.zeros((), dtype=torch.float64, requires_grad=True)
        g, = torch.autograd.grad(tsp.rf(x, _t(0.7), _t(1.0)), x)
        assert float(g) == 0.0

    def test_rules_broadcast_and_batch(self):
        # a batch of points gives each point's scalar derivative
        pts = np.array(CARLSON[1][3])
        args = [torch.tensor(pts[:, k], dtype=torch.float64,
                             requires_grad=True) for k in range(3)]
        grads = torch.autograd.grad(tsp.rd(*args).sum(), args)
        for n, p in enumerate(map(tuple, pts)):
            for i in range(3):
                assert abs(float(grads[i][n]) - _rev(tsp.rd, p, i)) <= (
                    1e-15 * abs(float(grads[i][n])))


SNCNDN = [(0.3, 0.5), (1.2, 0.9), (2.5, 0.3), (-1.3, 0.4), (4.0, 0.6),
          (0.7, 0.999)]


def _sn(j):
    def f(u, m):
        return tsp.jacobi_sncndn(u, m)[j]
    return f


class TestJacobiRule:
    @pytest.mark.parametrize("u,m", SNCNDN)
    def test_sncndn_midrange(self, u, m):
        for j in range(3):
            for i in range(2):
                rev, fwd = _rev(_sn(j), (u, m), i), _fwd(_sn(j), (u, m), i)
                h = 1e-6 * max(abs((u, m)[i]), 1e-2)
                fd = _fd(_sn(j), (u, m), i, h)
                scale = max(abs(fd), 1e-6)
                assert abs(rev - fd) / scale < 1e-6, (j, i, u, m, rev, fd)
                assert abs(rev - fwd) <= 1e-12 * scale, (j, i, u, m)
                j_rev, j_fwd = _jax(
                    lambda u_, m_: jsp.jacobi_sncndn(u_, m_)[j], (u, m), i)
                assert abs(rev - j_rev) <= 1e-10 * max(abs(j_rev), 1e-6)
                assert abs(fwd - j_fwd) <= 1e-10 * max(abs(j_fwd), 1e-6)

    def test_sncndn_u_derivative_is_algebraic(self):
        u, m = 1.1, 0.7
        sn, cn, dn = (float(v) for v in tsp.jacobi_sncndn(_t(u), _t(m)))
        for j, want in [(0, cn * dn), (1, -sn * dn), (2, -m * sn * cn)]:
            assert abs(_rev(_sn(j), (u, m), 0) - want) < 1e-10

    def test_sncndn_mc_path_near_one(self):
        # the exact-complement path at mc = 1e-8: the m -> 1 branch
        u, mc = 1.5, 1e-8
        for j in range(3):
            def f(mc_):
                return tsp.jacobi_sncndn(_t(u), 1.0 - mc_, mc=mc_)[j]
            rev = _rev(f, (mc,), 0)
            h = 0.01 * mc
            fd = _fd(f, (mc,), 0, h)
            assert abs(rev - fd) / max(abs(fd), 1e-6) < 1e-4
            jg = float(jax.grad(lambda mc_: jsp.jacobi_sncndn(
                jnp.float64(u), 1.0 - mc_, mc=mc_)[j])(jnp.float64(mc)))
            assert abs(rev - jg) <= 1e-10 * max(abs(jg), 1e-6)

    def test_sncndn_small_m_series(self):
        # the m -> 0 branch (the closed form cancels there)
        for j in range(3):
            rev = _rev(_sn(j), (0.9, 1e-9), 1)
            fd = _fd(_sn(j), (0.9, 1e-9), 1, 3e-10)
            assert abs(rev - fd) / max(abs(fd), 1e-6) < 1e-4
            jg = float(jax.grad(lambda m: jsp.jacobi_sncndn(
                jnp.float64(0.9), m)[j])(jnp.float64(1e-9)))
            assert abs(rev - jg) <= 1e-10 * max(abs(jg), 1e-6)

    def test_inverse_grads_compose_through_rf(self):
        # d isn/dz = 1/sqrt((1-z^2)(1-m z^2)) falls out of rf's rule
        z, m = 0.6, 0.4
        g = _rev(tsp.jacobi_isn, (z, m), 0)
        want = 1.0 / np.sqrt((1 - z * z) * (1 - m * z * z))
        assert abs(g - want) / want < 1e-10
        g2 = _rev(tsp.jacobi_icn, (z, m), 1)
        fd = _fd(tsp.jacobi_icn, (z, m), 1, 1e-6)
        assert abs(g2 - fd) / abs(fd) < GATE
        jg = float(jax.grad(lambda m_: jsp.jacobi_icn(jnp.float64(z), m_))(
            jnp.float64(m)))
        assert abs(g2 - jg) <= 1e-10 * abs(jg)


class TestRtbisImplicit:
    """x(p) with f(p, x) = x^3 + p x - 2 p^2 = 0 on [0, 4]: the value is
    the bisection's, the derivative -f_p / f_x, against FD, against JAX's
    `rtbis_implicit` (`lax.custom_root`), and forward against reverse."""

    @staticmethod
    def _f(p, x):
        return x ** 3 + p * x - 2.0 * p * p

    @pytest.mark.parametrize("p0", [0.5, 1.3, 2.0])
    def test_implicit_rule(self, p0):
        lo, hi = _t(0.0), _t(4.0)
        p = _t(p0).requires_grad_(True)
        x = troots.rtbis_implicit(self._f, p, lo, hi)
        # the value is the bisection's, untouched by the rule
        assert float(x.detach()) == float(troots.rtbis(
            lambda v: self._f(p.detach(), v), lo, hi))
        g, = torch.autograd.grad(x, p)
        with fwAD.dual_level():
            xd = troots.rtbis_implicit(
                self._f, fwAD.make_dual(_t(p0), _t(1.0)), lo, hi)
            t = float(fwAD.unpack_dual(xd).tangent)
        xv = float(x.detach())
        want = -(xv - 4.0 * p0) / (3.0 * xv * xv + p0)
        assert abs(float(g) - want) <= 1e-12 * abs(want)
        assert abs(t - float(g)) <= 1e-12 * abs(want)
        h = 1e-6
        fd = (float(troots.rtbis(lambda v: self._f(_t(p0 + h), v), lo, hi))
              - float(troots.rtbis(lambda v: self._f(_t(p0 - h), v), lo,
                                   hi))) / (2 * h)
        assert abs(float(g) - fd) / abs(fd) < GATE
        jx, jg = jax.value_and_grad(lambda p_: jroots.rtbis_implicit(
            self._f, p_, 0.0, 4.0))(jnp.float64(p0))
        assert abs(xv - float(jx)) <= 1e-15 * abs(xv)
        assert abs(float(g) - float(jg)) <= 1e-10 * abs(float(jg))
