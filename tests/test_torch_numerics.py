"""The port's numerics layer (`sim5_tpu_torch.special` interpolation,
distributions, Gauss-Legendre quadrature, the quartic's unpacked roots
and its one-step polish; `utils.key_value_get`) against `sim5_tpu` on the
same numpy-seeded inputs, on the CPU.

Tolerances:
* interpolation, inverse CDF, quadrature: 1e-14 relative (the same f64
  operations; the spline's second derivatives are the same host sweep);
* quartic roots in f64: 1e-12 relative with an absolute floor of 1e-13 of
  the root scale (`test_torch_special.py`'s quartic chain);
* in f32 (JAX under `enable_x64(False)`): 8 f32 ulps of the root scale,
  the bound of `test_torch_special.py`'s f32 polish;
* `distrib_hit`: a Kolmogorov-Smirnov test of 200000 samples from a
  seeded `torch.Generator` against the normal CDF (the JAX package's own
  sampling test draws from `jax.random`, whose bits the port cannot
  match).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu import special as jsp
from sim5_tpu.utils import key_value_get as j_key_value_get
from sim5_tpu_torch import special as tsp
from sim5_tpu_torch.utils import key_value_get

torch.set_num_threads(2)

TYPES = {"linlin": tsp.INTERP_TYPE_LINLIN, "loglog": tsp.INTERP_TYPE_LOGLOG,
         "loglin": tsp.INTERP_TYPE_LOGLIN, "spline": tsp.INTERP_TYPE_SPLINE}
F32_ULPS = 8 * 2.0 ** -23


def _table(kind):
    """(x, y, queries) of each interpolation type: a power law on a log
    grid for the log types, a Gaussian for the linear ones; queries
    inside, on the nodes and outside the grid on both sides."""
    rng = np.random.default_rng(11)
    if kind in ("loglog", "loglin"):
        x = np.geomspace(1.0, 100.0, 64)
        y = x ** -2.5 + (0.0 if kind == "loglog" else 0.3)
        xq = np.concatenate([np.geomspace(0.5, 150.0, 301), x[::7],
                             rng.uniform(1.0, 100.0, 64)])
    else:
        x = np.sort(rng.uniform(-4.0, 4.0, 60))
        y = np.exp(-x * x / 2)
        xq = np.concatenate([np.linspace(-5.0, 5.0, 301), x[::7],
                             rng.uniform(-4.0, 4.0, 64)])
    return x, y, xq


def _close(got, want, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (np.isnan(got) == np.isnan(want)).all()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


class TestInterp:
    @pytest.mark.parametrize("kind", list(TYPES))
    @pytest.mark.parametrize("extrapolate", [False, True])
    def test_against_jax(self, kind, extrapolate):
        x, y, xq = _table(kind)
        opt = tsp.INTERP_OPT_ALLOW_EXTRAPOLATION if extrapolate else 0
        tab = tsp.interp_init(x, y, TYPES[kind], opt, device="cpu")
        jtab = jsp.interp_init(x, y, TYPES[kind], opt)
        assert tab.x.dtype == torch.float64 and tab.x.device.type == "cpu"
        got, want = tab(xq), np.asarray(jsp.interp_eval(jtab, xq))
        # outside the grid: NaN in both unless extrapolation is allowed
        outside = (xq < x[0]) | (xq > x[-1])
        assert outside.any()
        assert np.isnan(want[outside]).all() != extrapolate
        _close(got, want, 1e-14, atol=1e-300)
        # the spline's second derivatives: the same host sweep
        _close(tab.y2, jtab.y2, 1e-14, atol=1e-300)
        # a scalar query and a tensor query
        _close(tsp.interp_eval(tab, float(xq[5])),
               jsp.interp_eval(jtab, float(xq[5])), 1e-14, atol=1e-300)
        _close(tab(torch.tensor(xq[:9].reshape(3, 3))),
               np.asarray(jtab(xq[:9].reshape(3, 3))), 1e-14, atol=1e-300)

    def test_spline_gaussian(self):
        """`test_numerics.py`'s reference check: the spline of a Gaussian
        reproduces the analytic values."""
        x = np.linspace(-4, 4, 60)
        tab = tsp.interp_init(x, np.exp(-x * x / 2), tsp.INTERP_TYPE_SPLINE,
                              device="cpu")
        xq = np.linspace(-3.9, 3.9, 301)
        assert np.abs(tab(xq).numpy() - np.exp(-xq * xq / 2)).max() < 2e-4

    def test_incremental_build(self):
        """InterpBuilder gives the table interp_init gives, and rejects
        unordered pushes and a table of fewer than two points as the JAX
        package's does."""
        x = np.linspace(-4, 4, 60)
        y = np.exp(-x * x / 2)
        b = tsp.interp_init_build(tsp.INTERP_TYPE_SPLINE, device="cpu")
        jb = jsp.interp_init_build(jsp.INTERP_TYPE_SPLINE)
        for xi, yi in zip(x, y):
            b.push(xi, yi)
            jb.push(xi, yi)
        assert len(b) == len(jb) == 60
        xq = np.linspace(-3.9, 3.9, 101)
        _close(b.finalize()(xq), np.asarray(jb.finalize()(xq)), 1e-14)
        for mod in (tsp, jsp):
            with pytest.raises(ValueError, match="unordered X grid"):
                mod.interp_init_build().push(1.0, 0.0).push(0.5, 0.0)
            with pytest.raises(ValueError, match="unordered X grid"):
                mod.interp_init_build().push(1.0, 0.0).push(1.0, 0.0)
            with pytest.raises(ValueError, match="at least 2"):
                mod.interp_init_build().push(1.0, 0.0).finalize()


def _gauss_pdf(x):
    return torch.exp(-x * x / 2)


class TestDistributions:
    def test_icdf_against_jax(self):
        d = tsp.distrib_init(_gauss_pdf, -6.0, 6.0, device="cpu")
        jd = jsp.distrib_init(lambda x: jnp.exp(-x * x / 2), -6.0, 6.0)
        _close(d.x, jd.x, 1e-14, atol=1e-15)
        _close(d.cdf, jd.cdf, 1e-14, atol=1e-300)
        u = np.concatenate([np.random.default_rng(12).uniform(0, 1, 4096),
                            [0.0, 0.5, 1.0, -0.1, 1.1]])
        # the two CDFs are cumulative sums in another order, a few
        # roundings apart; where the PDF is small the inverse divides
        # that by the CDF's step: each u is held to that bound
        got, want = d.icdf(u).numpy(), np.asarray(jd.icdf(u))
        dc = float(np.abs(d.cdf.numpy() - np.asarray(jd.cdf)).max())
        i = np.clip(np.searchsorted(np.asarray(jd.cdf), np.clip(u, 0, 1))
                    - 1, 0, len(jd.cdf) - 2)
        step = np.diff(np.asarray(jd.cdf))[i]
        bound = (4.0 * dc / np.maximum(step, 1e-300) * 12.0 / 2048
                 + 1e-14 * np.abs(want) + 1e-15)
        assert (np.abs(got - want) <= bound).all()
        assert np.mean(np.abs(got - want) <= 1e-14 * np.abs(want)
                       + 1e-15) > 0.9
        # the same table in both: the same inverse to the last rounding
        same = tsp.Distrib(torch.tensor(np.asarray(jd.x)),
                           torch.tensor(np.asarray(jd.cdf)))
        _close(tsp.distrib_icdf(same, u), np.asarray(jsp.distrib_icdf(jd, u)),
               1e-15, atol=1e-15)

    def test_sampling_ks(self):
        """Samples of a seeded generator follow the normal CDF (KS distance
        below the 0.1% critical value 1.95 / sqrt(n)), repeat under the
        same seed, and have test_numerics.py's moments."""
        d = tsp.distrib_init(_gauss_pdf, -6.0, 6.0, device="cpu")
        n = 200000
        s = tsp.distrib_hit(d, torch.Generator().manual_seed(0), (n,))
        assert s.shape == (n,) and s.dtype == torch.float64
        again = d.sample(torch.Generator().manual_seed(0), (n,))
        assert torch.equal(s, again)
        xs = np.sort(s.numpy())
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(xs / math.sqrt(2.0)))
        ks = max((np.arange(1, n + 1) / n - cdf).max(),
                 (cdf - np.arange(n) / n).max())
        assert ks < 1.95 / math.sqrt(n), f"KS distance {ks:.3e}"
        assert abs(xs.mean()) < 0.02 and abs(xs.std() - 1.0) < 0.01


class TestQuadrature:
    @pytest.mark.parametrize("n", [5, 20, 64])
    def test_gauleg_against_jax(self, n):
        x, w = tsp.gauleg(0.0, 2.0, n, device="cpu")
        jx, jw = jsp.gauleg(0.0, 2.0, n)
        _close(x, jx, 1e-14)
        _close(w, jw, 1e-14)
        x32, _ = tsp.gauleg(0.0, 2.0, n, dtype=torch.float32, device="cpu")
        assert x32.dtype == torch.float32

    def test_qgaus(self):
        got = tsp.qgaus(lambda x: x ** 5, 0.0, 2.0, 20, device="cpu")
        want = float(jsp.qgaus(lambda x: x ** 5, 0.0, 2.0, 20))
        _close(got, want, 1e-14)
        assert abs(float(got) - 64.0 / 6.0) < 1e-10
        got = tsp.qgaus(torch.cos, 0.0, 1.5, device="cpu")
        _close(got, float(jsp.qgaus(jnp.cos, 0.0, 1.5)), 1e-14)


def _quartics(seed, n=256):
    """Random monic quartics with all root patterns: four real, two real
    and a complex pair, two complex pairs."""
    rng = np.random.default_rng(seed)
    re = rng.uniform(-5.0, 5.0, (n, 4))
    im = rng.uniform(0.1, 3.0, (n, 2))
    kind = np.arange(n) % 3
    roots = re.astype(complex)
    roots[kind >= 1, 2] = re[kind >= 1, 2] + 1j * im[kind >= 1, 0]
    roots[kind >= 1, 3] = re[kind >= 1, 2] - 1j * im[kind >= 1, 0]
    roots[kind == 2, 0] = re[kind == 2, 0] + 1j * im[kind == 2, 1]
    roots[kind == 2, 1] = re[kind == 2, 0] - 1j * im[kind == 2, 1]
    coef = np.array([np.poly(r).real for r in roots])
    return [coef[:, k] for k in range(1, 5)]


def _depressed(seed, n=256):
    """Geodesic quartics z^4 + c2 z^2 + c1 z + c0 (`_R_roots`'s form)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.998, n)
    l = rng.uniform(-8.0, 8.0, n)
    q = rng.uniform(-2.0, 40.0, n)
    return (a * a - l * l - q, 2.0 * (q + (l - a) ** 2), -a * a * q)


class TestQuartic:
    def test_quartic_roots_c_f64(self):
        coef = _quartics(13)
        got = tsp.quartic_roots_c(*(torch.tensor(c) for c in coef))
        want = jsp.quartic_roots_c(*coef)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert set(np.unique(got[0].numpy())) == {0, 2, 4}
        scale = np.abs(np.stack([np.asarray(w[0]) for w in want[1:]])).max()
        for g, w in zip(got[1:], want[1:]):
            for gg, ww in zip(g, w):
                _close(gg, ww, 1e-12, atol=1e-13 * scale)
        # test_special.py's quartic: roots 2, 1 and the pair +-i
        n, z1, z2, z3, z4 = tsp.quartic_roots_c(
            *(torch.tensor(v) for v in (-3.0, 3.0, -3.0, 2.0)))
        assert int(n) == 2
        assert np.allclose([float(z1[0]), float(z2[0])], [2.0, 1.0],
                           atol=1e-9)
        assert float(z1[1]) == 0.0 and float(z2[1]) == 0.0
        assert abs(float(z3[1]) + float(z4[1])) <= 1e-12

    def test_polish_f64(self):
        c2, c1, c0 = _depressed(14)
        zero = np.zeros_like(c2)
        jre, jim, _ = jsp.quartic_roots(zero, c2, c1, c0)
        jre, jim, _ = jsp.sort_quartic_roots(jre, jim)
        re, im = torch.tensor(np.asarray(jre)), torch.tensor(np.asarray(jim))
        got = tsp.polish_quartic_real_roots(re, im, *(torch.tensor(c)
                                                      for c in (c2, c1, c0)))
        want = np.asarray(jsp.polish_quartic_real_roots(jre, jim, c2, c1, c0))
        scale = float(np.abs(want).max())
        _close(got, want, 1e-12, atol=1e-13 * scale)
        # complex roots pass through
        cplx = np.asarray(jim) != 0.0
        assert cplx.any()
        np.testing.assert_array_equal(got.numpy()[cplx], np.asarray(jre)[cplx])

    def test_f32(self):
        """The unpacked roots and the one-step polish in f32 against JAX
        under enable_x64(False).  The closed form alone is ill-conditioned
        in f32: both packages' roots sit a median ~1.3 and a 99th
        percentile ~2500 ulps of the root scale off the f64 roots of the
        same coefficients (near double roots far more), each by its own
        roundings (XLA's and torch's cbrt, acos, cos differ).  So the
        unpacked roots are held to equal real-root counts on >= 99% of the
        lanes and, lane by lane, to an error against the f64 roots whose
        50th, 90th, 99th and 100th percentiles are within twice JAX's plus
        one ulp; the polished roots (well conditioned: the depressed
        geodesic quartics) agree within 8 ulps of the root scale."""
        coef = [c.astype(np.float32) for c in _quartics(15)]
        with jax.enable_x64(False):
            want = jsp.quartic_roots_c(*coef)
        got = tsp.quartic_roots_c(*(torch.tensor(c) for c in coef))
        truth = tsp.quartic_roots_c(*(torch.tensor(c, dtype=torch.float64)
                                      for c in coef))
        assert got[1][0].dtype == torch.float32
        assert (got[0].numpy() == np.asarray(want[0])).mean() >= 0.99

        def roots(r):
            return np.stack([np.stack([np.asarray(v) for v in z], -1)
                             for z in r[1:]], 1)

        t = roots(truth)
        scale = np.abs(t[..., 0]).max(-1) * 2.0 ** -23
        err, jerr = (np.abs(roots(r) - t).max((1, 2)) / scale
                     for r in (got, want))
        for q in (50, 90, 99, 100):
            assert (np.percentile(err, q)
                    <= 2.0 * np.percentile(jerr, q) + 1.0), q

        c2, c1, c0 = (c.astype(np.float32) for c in _depressed(16))
        zero = np.zeros_like(c2)
        with jax.enable_x64(False):
            jre, jim, _ = jsp.quartic_roots(zero, c2, c1, c0)
            jre, jim, _ = jsp.sort_quartic_roots(jre, jim)
            want = np.asarray(jsp.polish_quartic_real_roots(
                jre, jim, c2, c1, c0))
            jre, jim = np.asarray(jre), np.asarray(jim)
        got = tsp.polish_quartic_real_roots(
            torch.tensor(jre), torch.tensor(jim),
            *(torch.tensor(c) for c in (c2, c1, c0))).numpy()
        assert got.dtype == np.float32
        scale = np.abs(want).max(-1, keepdims=True)
        assert (np.abs(got - want) <= F32_ULPS * scale).all()


class TestOptions:
    @pytest.mark.parametrize("opts, key, default", [
        ("mdot=0.1,alpha=0.1", "alpha", None),
        ("mdot=0.1, alpha = 0.2 k=v", "alpha", None),
        ("mdot=0.1 alpha=0.2", "k", "x"),
        ("", "mdot", 3),
        (None, "mdot", None),
        ("flag mdot=1=2", "mdot", None),
    ])
    def test_key_value_get(self, opts, key, default):
        assert (key_value_get(opts, key, default)
                == j_key_value_get(opts, key, default))
        assert key_value_get("mdot=0.1,alpha=0.1", "alpha") == "0.1"
