"""The port's special functions (`sim5_tpu_torch.special`) against
`sim5_tpu.special` on the same numpy-seeded inputs, and against the
C-reference goldens (tests/golden/special.txt).

Tolerances:
* f64: relative 1e-12 (both run the same operations in IEEE f64; the
  differences are a few roundings);
* f32 (JAX under `enable_x64(False)`, the port on f32 tensors): relative
  8 f32 ulps (8 * 2**-23 ~ 9.5e-7), the order of the roundings of a fixed
  depth chain whose last steps differ by one rounding;
* goldens: `test_special.py`'s thresholds (1e-9; sncndn 1e-6 / 1e-7, the
  reference's AGM tolerance).
"""

import jax
import numpy as np
import pytest
import torch

from sim5_tpu import special as jsp
from sim5_tpu.special import polyroots as jpoly
from sim5_tpu_torch import special as tsp
from sim5_tpu_torch.special import polyroots as tpoly

torch.set_num_threads(2)

N = 256
F32_RTOL = 8 * 2.0 ** -23


def _t(*arrays, dtype=torch.float64):
    """numpy arrays as CPU tensors of `dtype`."""
    out = [torch.tensor(np.asarray(v), dtype=dtype) for v in arrays]
    return out if len(out) > 1 else out[0]


def _close(got, want, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


def _rf_args(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x, y, z = (10.0 ** rng.uniform(-8, 3, n) for _ in range(3))
    x[::7] = 0.0                     # complete integrals RF(0, y, z)
    return x, y, z


def _sncndn_args(seed=1, n=N):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-12.0, 12.0, n)
    mc = 10.0 ** rng.uniform(-12, 0, n)
    m = 1.0 - mc
    m_plain = rng.uniform(0.0, 0.999, n)
    return u, m, mc, m_plain


def _quartic_args(seed=2, n=N):
    """Geodesic quartics R(r) = r^4 + c2 r^2 + c1 r + c0 (no cubic term),
    from random spins and motion constants, as `_R_roots` forms them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.998, n)
    l = rng.uniform(-8.0, 8.0, n)
    q = rng.uniform(-2.0, 40.0, n)
    c2 = a * a - l * l - q
    c1 = 2.0 * (q + (l - a) ** 2)
    c0 = -a * a * q
    return np.zeros(n), c2, c1, c0


def _quartic_chain(mod, a3, a2, a1, a0):
    """roots -> sort -> two-float polish, in `mod` (either package)."""
    re, im, n = mod.quartic_roots(a3, a2, a1, a0)
    rs, is_, nr = mod.sort_quartic_roots(re, im)
    hi, lo = mod.polish_quartic_real_roots_df(rs, is_, a2, a1, a0)
    return re, im, n, rs, is_, nr, hi, lo


class TestAgainstJaxF64:
    """The port against sim5_tpu.special in f64."""

    def test_rf(self):
        x, y, z = _rf_args()
        _close(tsp.rf(*_t(x, y, z)), jsp.rf(x, y, z), 1e-12)

    def test_elliptic_k_mc(self):
        mc = 10.0 ** np.random.default_rng(3).uniform(-12, 0, N)
        _close(tsp.elliptic_k_mc(_t(mc)), jsp.elliptic_k_mc(mc), 1e-12)

    @pytest.mark.parametrize("with_mc", [False, True])
    def test_jacobi_sncndn(self, with_mc):
        u, m, mc, m_plain = _sncndn_args()
        if with_mc:
            got = tsp.jacobi_sncndn(*_t(u, m, mc))
            want = jsp.jacobi_sncndn(u, m, mc=mc)
        else:
            got = tsp.jacobi_sncndn(*_t(u, m_plain))
            want = jsp.jacobi_sncndn(u, m_plain)
        for g, w in zip(got, want):
            _close(g, w, 1e-12, atol=1e-15)

    def test_quartic_chain(self):
        args = _quartic_args()
        got = _quartic_chain(tsp, *_t(*args))
        want = _quartic_chain(jsp, *args)
        re, im, n, rs, is_, nr, hi, lo = got
        jre, jim, jn, jrs, jis, jnr, jhi, jlo = (np.asarray(v) for v in want)
        np.testing.assert_array_equal(n.numpy(), jn)
        np.testing.assert_array_equal(nr.numpy(), jnr)
        scale = float(np.abs(jre).max())
        _close(re, jre, 1e-12, atol=1e-13 * scale)
        _close(im, jim, 1e-12, atol=1e-13 * scale)
        _close(rs, jrs, 1e-12, atol=1e-13 * scale)
        _close(hi, jhi, 1e-12, atol=1e-13 * scale)
        # the low parts are ulp-sized corrections of hi: the two-float
        # roots hi + lo agree to ~1e-16 of the root scale
        np.testing.assert_allclose((hi + lo).numpy(), jhi + jlo, rtol=0,
                                   atol=1e-14 * scale)
        assert (lo.numpy()[jnr[:, None] > np.arange(4)] != 0).any()

    def test_quadratic_and_cubic(self):
        rng = np.random.default_rng(4)
        a, b, c = rng.normal(size=(3, N))
        for g, w in zip(tsp.quadratic_roots(*_t(a, b, c)),
                        jsp.quadratic_roots(a, b, c)):
            _close(g, w, 1e-12, atol=1e-14)
        p, q, r = rng.normal(size=(3, N)) * 3.0
        for g, w in zip(tsp.cubic_roots(*_t(p, q, r)),
                        jsp.cubic_roots(p, q, r)):
            _close(g, w, 1e-12, atol=1e-13)

    def test_error_free_transforms(self):
        rng = np.random.default_rng(5)
        a, b = rng.normal(size=(2, N)) * 1e3
        ta, tb = _t(a, b)
        s, e = tpoly._two_sum(ta, tb)
        # a + b == s + e exactly (checked in exact rational arithmetic)
        from fractions import Fraction
        for i in range(0, N, 16):
            assert Fraction(a[i]) + Fraction(b[i]) == (Fraction(float(s[i]))
                                                       + Fraction(float(e[i])))
        p, e = tpoly._two_prod(ta, tb)
        for i in range(0, N, 16):
            assert Fraction(a[i]) * Fraction(b[i]) == (Fraction(float(p[i]))
                                                       + Fraction(float(e[i])))
        hi, lo = tpoly._split(ta)
        torch.testing.assert_close(hi + lo, ta, rtol=0, atol=0)

    def test_newton_step_compensated(self):
        """One compensated Newton step from the closed-form roots: the
        moved roots and the lanes that move, as in the JAX package."""
        a3, c2, c1, c0 = _quartic_args()
        re, im, _ = (np.asarray(v) for v in jsp.quartic_roots(a3, c2, c1, c0))
        coeffs = (c2[:, None], c1[:, None], c0[:, None])
        want = [np.asarray(v) for v in
                jpoly._newton_step_compensated(re, im, *coeffs)]
        got = tpoly._newton_step_compensated(*_t(re, im, *coeffs))
        scale = float(np.abs(re).max())
        _close(got[0], want[0], 1e-12, atol=1e-13 * scale)
        _close(got[1], want[1], 1e-12, atol=1e-13 * scale)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        assert want[2].any()


class TestAgainstJaxF32:
    """The port on f32 tensors against sim5_tpu.special under
    `jax.enable_x64(False)`: the f32 depths (RF 7, K 7, sncndn 8) and the
    f32 quartic rescale are selected by the tensors' dtype."""

    def test_rf(self):
        x, y, z = (v.astype(np.float32) for v in _rf_args())
        with jax.enable_x64(False):
            want = np.asarray(jsp.rf(x, y, z))
        got = tsp.rf(*_t(x, y, z, dtype=torch.float32))
        assert got.dtype == torch.float32
        _close(got, want, F32_RTOL)

    def test_elliptic_k_mc(self):
        mc = (10.0 ** np.random.default_rng(3).uniform(-12, 0, N)).astype(
            np.float32)
        with jax.enable_x64(False):
            want = np.asarray(jsp.elliptic_k_mc(mc))
        _close(tsp.elliptic_k_mc(_t(mc, dtype=torch.float32)), want,
               F32_RTOL)

    def test_jacobi_sncndn(self):
        u, m, mc, _ = (v.astype(np.float32) for v in _sncndn_args())
        with jax.enable_x64(False):
            want = [np.asarray(v) for v in jsp.jacobi_sncndn(u, m, mc=mc)]
        got = tsp.jacobi_sncndn(*_t(u, m, mc, dtype=torch.float32))
        for g, w in zip(got, want):
            # |sn|, |cn|, |dn| <= 1: absolute 8 ulps of 1
            _close(g, w, F32_RTOL, atol=F32_RTOL)

    def test_quartic_chain(self):
        """The f32 chain on far-field quartics (root scales up to 1e5, the
        range the power-of-two rescale exists for): identical real-root
        counts on >= 99% of lanes, and where equal, two-float roots within
        8 ulps of the root scale."""
        a3, c2, c1, c0 = _quartic_args(seed=6)
        s = 10.0 ** np.random.default_rng(7).uniform(0, 5, N)
        args = [v.astype(np.float32) for v in (a3, c2 * s * s, c1 * s ** 3,
                                               c0 * s ** 4)]
        with jax.enable_x64(False):
            want = [np.asarray(v) for v in _quartic_chain(jsp, *args)]
        got = [v.numpy() for v in _quartic_chain(
            tsp, *_t(*args, dtype=torch.float32))]
        assert got[6].dtype == np.float32
        same = got[5] == want[5]
        assert same.mean() >= 0.99
        scale = np.abs(want[3]).max(-1)[same]
        err = np.abs((got[6] + got[7]) - (want[6] + want[7]))[same].max(-1)
        assert (err <= 8 * 2.0 ** -23 * scale).all()


class TestGolden:
    """The port against the C reference at test_special.py's thresholds."""

    @staticmethod
    def _check(got, want, rtol, atol=1e-14):
        got = got.numpy()
        finite = np.isfinite(want)
        assert np.isclose(got[finite], want[finite], rtol=rtol,
                          atol=atol).all()

    def test_rf(self, golden_special):
        d = golden_special["rf"]
        self._check(tsp.rf(*_t(d[:, 0], d[:, 1], d[:, 2])), d[:, 3], 1e-9)

    def test_elliptic_k_mc(self, golden_special):
        d = golden_special["ek"]
        self._check(tsp.elliptic_k_mc(_t(1.0 - d[:, 0])), d[:, 1], 1e-9)

    def test_sncndn(self, golden_special):
        d = golden_special["sncndn"]
        sn, cn, dn = tsp.jacobi_sncndn(*_t(d[:, 0], d[:, 1]))
        for got, col in ((sn, 2), (cn, 3), (dn, 4)):
            self._check(got, d[:, col], 1e-6, atol=1e-7)

    def test_quartic_known_roots(self):
        # test_special.py's quartics: four real roots, and 1, 2, +-i
        rng = np.random.default_rng(0)
        roots = rng.uniform(-10, 10, (N, 4))
        e1 = roots.sum(1)
        e2 = sum(roots[:, i] * roots[:, j] for i in range(4)
                 for j in range(i + 1, 4))
        e3 = sum(roots[:, i] * roots[:, j] * roots[:, k] for i in range(4)
                 for j in range(i + 1, 4) for k in range(j + 1, 4))
        re, im, n = tsp.quartic_roots(*_t(-e1, e2, -e3, roots.prod(1)))
        assert (n.numpy() == 4).all()
        np.testing.assert_allclose(np.sort(re.numpy(), 1),
                                   np.sort(roots, 1), rtol=1e-6, atol=1e-6)
        re, im, n = tsp.quartic_roots(*_t([-3.0], [3.0], [-3.0], [2.0]))
        sre, sim_, nr = tsp.sort_quartic_roots(re, im)
        assert int(n[0]) == 2 and int(nr[0]) == 2
        np.testing.assert_allclose(sre[0, :2].numpy(), [2.0, 1.0], atol=1e-9)
        np.testing.assert_allclose(np.abs(sim_[0, 2:].numpy()), [1.0, 1.0],
                                   atol=1e-9)
