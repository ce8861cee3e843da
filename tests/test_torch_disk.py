"""The port's disk layer (`sim5_tpu_torch.utils.fastmath`, `core.orbits`,
`special.quadrature`, `special.roots`, `disk`) against `sim5_tpu` on the
same inputs and against the C reference (tests/golden/kerr.txt,
disknt.txt).

Inputs come from numpy seeds and go to both packages in one process.

Tolerances, and why:
* error-free transforms (two_sum, two_prod): bitwise, they are exact;
* sqrt_df: hi within 1 ulp (XLA's and torch's CPU square roots differ in
  the last bit on ~1% of f64 inputs), and the pair hi + lo equal to
  ~ulp^2: relative 1e-18 in f64 (summed in long double), 1e-13 in f32
  (summed in f64);
* vlog: f32 within 2 ulp; f64 is u - log1p(u) in both packages, whose
  cancellation leaves ~ulp(u) absolute, so within 4 ulp of u;
* orbits: test_core.py's gates against C (1e-12, r_ms 1e-10), 1e-13
  relative against JAX;
* disk: test_disk_render.py's gates against C (flux rtol 1e-10, sigma
  1e-6, ell 1e-7, rms and lumi 1e-5, mdot 2e-6 absolute); 1e-12 relative
  against JAX (the same f64 operations, some in another order).
"""

import numpy as np
import pytest
import torch

import jax
from sim5_tpu import core as jcore
from sim5_tpu import disk as jdisk
from sim5_tpu.special import quadrature as jquad
from sim5_tpu.special import roots as jroots
from sim5_tpu.utils import fastmath as jfm
from sim5_tpu_torch import core as tcore
from sim5_tpu_torch import disk as tdisk
from sim5_tpu_torch.special import quadrature as tquad
from sim5_tpu_torch.special import roots as troots
from sim5_tpu_torch.utils import fastmath as tfm

torch.set_num_threads(2)

DTYPES = {"f64": (np.float64, True), "f32": (np.float32, False)}


def _t(v, dtype=torch.float64):
    return torch.tensor(np.asarray(v), dtype=dtype)


def _ulps(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got, np.float64) - want) / np.spacing(
        np.abs(want).astype(want.dtype))


def _check(got, want, rtol=1e-12, atol=1e-13):
    """test_core.py's comparison: finite reference entries only."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


class TestFastmath:

    @pytest.mark.parametrize("prec", list(DTYPES))
    def test_error_free_transforms(self, prec):
        dt, x64 = DTYPES[prec]
        rng = np.random.default_rng(0)
        a = rng.uniform(-10, 10, 1000).astype(dt)
        b = rng.uniform(-10, 10, 1000).astype(dt)
        with jax.enable_x64(x64):
            js = jfm.two_sum(a, b) + jfm.two_prod(a, b)
            js = [np.asarray(v) for v in js]
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ts = tfm.two_sum(ta, tb) + tfm.two_prod(ta, tb)
        for j, t in zip(js, ts):
            assert t.dtype == ta.dtype
            np.testing.assert_array_equal(t.numpy(), j)
        # and exactly what they claim: a + b = s + e, a * b = p + e
        s, e, p, pe = (v.numpy().astype(np.longdouble) for v in ts)
        al, bl = a.astype(np.longdouble), b.astype(np.longdouble)
        if prec == "f32":
            np.testing.assert_array_equal(s + e, al + bl)
            np.testing.assert_array_equal(p + pe, al * bl)

    @pytest.mark.parametrize("prec", list(DTYPES))
    def test_sqrt_df(self, prec):
        dt, x64 = DTYPES[prec]
        x = np.random.default_rng(1).uniform(0, 100, 1000).astype(dt)
        x[:2] = (0.0, 1.0)
        with jax.enable_x64(x64):
            jh, jl = (np.asarray(v) for v in jfm.sqrt_df(x))
        th, tl = (v.numpy() for v in tfm.sqrt_df(torch.from_numpy(x)))
        assert th.dtype == dt and tl.dtype == dt
        assert _ulps(th, jh).max() <= 1.0
        wide = np.longdouble if prec == "f64" else np.float64
        got = th.astype(wide) + tl.astype(wide)
        want = jh.astype(wide) + jl.astype(wide)
        rtol = 1e-18 if prec == "f64" else 1e-13
        assert (np.abs(got - want) <= rtol * np.abs(want)).all()

    @pytest.mark.parametrize("prec", list(DTYPES))
    def test_vlog(self, prec):
        dt, x64 = DTYPES[prec]
        rng = np.random.default_rng(2)
        u = np.concatenate([rng.uniform(0, 0.5, 500),
                            rng.uniform(0.5, 20, 500),
                            [0.0, 1e-6, 0.5]]).astype(dt)
        with jax.enable_x64(x64):
            j = np.asarray(jfm.vlog(u))
        t = tfm.vlog(torch.from_numpy(u)).numpy()
        assert t.dtype == dt
        if prec == "f32":
            assert _ulps(t, j)[j != 0].max() <= 2.0
        else:
            assert (np.abs(t - j) <= 4.0 * np.spacing(u)).all()
        np.testing.assert_array_equal(t[u == 0], 0.0)
        two = torch.tensor(2.0, dtype=torch.float64)
        assert tfm.log_accurate(two).item() == np.log(2.0)


class TestQuadratureAndRoots:

    def test_simpson_and_trapezoid(self):
        def f(x):
            return x ** 3 - 2.0 * x + 1.0
        for jfn, tfn in ((jquad.integrate_simpson, tquad.integrate_simpson),
                         (jquad.integrate_trapezoid,
                          tquad.integrate_trapezoid)):
            j = float(jfn(lambda x: f(x), 0.5, 3.0, 101))
            t = float(tfn(lambda x: f(x), 0.5, 3.0, 101))
            assert abs(t - j) <= 1e-13 * abs(j)
        # Simpson is exact on cubics
        exact = (3.0 ** 4 - 0.5 ** 4) / 4 - (9.0 - 0.25) + 2.5
        assert abs(float(tquad.integrate_simpson(f, 0.5, 3.0, 8))
                   - exact) <= 1e-12
        np.testing.assert_array_equal(
            tquad.simpson_weights(6, "cpu").numpy(),
            np.asarray(jquad.simpson_weights(6)))
        np.testing.assert_array_equal(
            tquad.trapezoid_weights(5, "cpu").numpy(),
            np.asarray(jquad.trapezoid_weights(5)))

    def test_rtbis(self):
        c = np.random.default_rng(3).uniform(1.0, 50.0, 16)
        j = np.asarray(jroots.rtbis(lambda x: x * x - c, 0.0, 60.0))
        t = troots.rtbis(lambda x: x * x - torch.from_numpy(c), 0.0,
                         60.0).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-15)
        np.testing.assert_allclose(t, np.sqrt(c), rtol=1e-14)
        # a decreasing bracket is oriented too
        t2 = troots.rtbis(lambda x: c[0] - x * x, 0.0, 60.0)
        assert abs(float(t2) - np.sqrt(c[0])) <= 1e-13


class TestOrbits:

    def test_radii_golden(self, golden_kerr):
        d = golden_kerr["orbit"]
        a = _t(d[:, 0])
        _check(tcore.r_bh(a), d[:, 1])
        _check(tcore.r_ms(a), d[:, 2], rtol=1e-10, atol=1e-10)
        _check(tcore.r_mb(a), d[:, 3])
        _check(tcore.r_ph(a), d[:, 4])

    def test_kepler_golden(self, golden_kerr):
        d = golden_kerr["kepler"]
        r, a = _t(d[:, 1]), _t(d[:, 0])
        _check(tcore.OmegaK(r, a), d[:, 2])
        _check(tcore.ellK(r, a), d[:, 3])
        _check(tcore.omega_r(r, a), d[:, 4])
        _check(tcore.omega_z(r, a), d[:, 5])
        _check(tcore.gfactorK(r, a, tcore.ellK(r, a)), d[:, 6])

    def test_against_jax(self):
        rng = np.random.default_rng(4)
        a = rng.uniform(-0.99, 0.999, 200)
        r = rng.uniform(1.5, 60.0, 200) + np.asarray(jcore.r_ms(np.abs(a)))
        l = rng.uniform(-8.0, 8.0, 200)
        ta, tr, tl = _t(a), _t(r), _t(l)
        pairs = [(tcore.r_ms(ta), jcore.r_ms(a)),
                 (tcore.r_mb(ta), jcore.r_mb(a)),
                 (tcore.r_ph(ta), jcore.r_ph(a)),
                 (tcore.OmegaK(tr, ta), jcore.OmegaK(r, a)),
                 (tcore.ellK(tr, ta), jcore.ellK(r, a)),
                 (tcore.omega_r(tr, ta), jcore.omega_r(r, a)),
                 (tcore.omega_z(tr, ta), jcore.omega_z(r, a)),
                 (tcore.gfactorK(tr, ta, tl), jcore.gfactorK(r, a, l)),
                 *zip(tcore.keplerian_EL(tr, ta), jcore.keplerian_EL(r, a))]
        m_t = tcore.kerr_metric(ta, tr, _t(np.zeros(200)))
        m_j = jcore.kerr_metric(a, r, np.zeros(200))
        om = jcore.OmegaK(r, a)
        pairs += [(tcore.Omega_from_ell(tl, m_t),
                   jcore.Omega_from_ell(l, m_j)),
                  (tcore.ell_from_Omega(_t(om), m_t),
                   jcore.ell_from_Omega(om, m_j))]
        for t, j in pairs:
            _check(t, j, rtol=1e-13, atol=1e-15)

    def test_gfactorK_f32(self):
        """The compensated bracket in f32 against JAX's f32 and the f64
        value, on the a = 0.998 inner edge where it matters."""
        r = np.linspace(1.2375, 4.0, 257).astype(np.float32)
        a, l = np.float32(0.998), np.float32(-1.5)
        with jax.enable_x64(False):
            j = np.asarray(jcore.gfactorK(r, a, l))
        t = tcore.gfactorK(torch.from_numpy(r), torch.tensor(a),
                           torch.tensor(l)).numpy()
        f64 = tcore.gfactorK(_t(r), _t(a), _t(l)).numpy()
        assert t.dtype == np.float32
        assert _ulps(t, j).max() <= 2.0
        np.testing.assert_allclose(t, f64, rtol=1e-6)


class TestNTDisk:

    def test_setup_and_lumi_golden(self, golden_disknt):
        for a, rmin_ref, lumi_ref in golden_disknt["setup"]:
            disk = tdisk.nt_setup(10.0, a, 0.1, 0.1, device="cpu")
            assert disk.a.dtype == torch.float64
            assert np.isclose(float(disk.rms), rmin_ref, rtol=1e-5)
            assert np.isclose(float(tdisk.nt_lumi(disk)), lumi_ref,
                              rtol=1e-5)

    def test_profiles_golden(self, golden_disknt):
        p = golden_disknt["prof"]
        for a in np.unique(p[:, 0]):
            rows = p[p[:, 0] == a]
            dk = tdisk.nt_setup(10.0, a, 0.1, 0.1, device="cpu")
            r = _t(rows[:, 1])
            np.testing.assert_allclose(tdisk.nt_flux(dk, r).numpy(),
                                       rows[:, 2], rtol=1e-10)
            np.testing.assert_allclose(tdisk.nt_sigma(dk, r).numpy(),
                                       rows[:, 3], rtol=1e-6)
            np.testing.assert_allclose(tdisk.nt_ell(dk, r).numpy(),
                                       rows[:, 4], rtol=1e-7)

    def test_luminosity_mode_golden(self, golden_disknt):
        ref = golden_disknt["lmode"][0]
        dk = tdisk.nt_setup(10.0, ref[0], 0.1, 0.1,
                            tdisk.DISK_NT_OPTION_LUMINOSITY, device="cpu")
        assert abs(float(dk.mdot) - ref[1]) < 2e-6
        assert dk.options == tdisk.DISK_NT_OPTION_LUMINOSITY

    def test_against_jax(self):
        rng = np.random.default_rng(5)
        for a in (0.0, 0.5, 0.998, -0.3):
            jd = jdisk.nt_setup(10.0, a, 0.1, 0.1)
            td = tdisk.nt_setup(10.0, a, 0.1, 0.1, device="cpu")
            r = float(jd.rms) * np.concatenate([
                [0.5, 1.0, 1.0 + 1e-7], 1.0 + rng.uniform(0, 1e-3, 20),
                np.exp(rng.uniform(0.0, np.log(1e4), 60))])
            tr = _t(r)
            for tf, jf, rtol in ((tdisk.nt_flux, jdisk.nt_flux, 1e-12),
                                 (tdisk.nt_temp, jdisk.nt_temp, 1e-12),
                                 (tdisk.nt_sigma, jdisk.nt_sigma, 1e-11),
                                 (tdisk.nt_ell, jdisk.nt_ell, 1e-13),
                                 (tdisk.nt_vr, jdisk.nt_vr, 0.0),
                                 (tdisk.nt_h, jdisk.nt_h, 0.0),
                                 (tdisk.nt_dhdr, jdisk.nt_dhdr, 0.0)):
                _check(tf(td, tr), jf(jd, r), rtol=rtol, atol=0.0)
            _check(tdisk.nt_lumi(td), jdisk.nt_lumi(jd), rtol=1e-12,
                   atol=0.0)

    def test_from_numpy_matches_setup(self):
        for a, opts, L in ((0.998, 0, 0.1), (0.7, 1, 0.1)):
            jd = jdisk.nt_setup(10.0, a, L, 0.1, opts)
            d = {k: np.asarray(v) for k, v in jd._asdict().items()}
            carried = tdisk.NTDisk.from_numpy(d, device="cpu")
            ours = tdisk.nt_setup(10.0, a, L, 0.1, opts, device="cpu")
            assert carried.options == ours.options == opts
            for name in ("M", "a", "rms", "alpha"):
                assert getattr(carried, name).dtype == torch.float64
                np.testing.assert_array_equal(
                    getattr(carried, name).numpy(),
                    getattr(ours, name).numpy(), err_msg=name)
            # the luminosity-mode mdot is a 40-halving bisection over a
            # sum taken in another order: equal to its f32 quantum
            np.testing.assert_allclose(carried.mdot.numpy(),
                                       ours.mdot.numpy(),
                                       rtol=0 if opts == 0 else 1e-6)
            back = carried.numpy()
            for k, v in d.items():
                np.testing.assert_array_equal(back[k], v)

    def test_f32_disk(self):
        """An nt_setup of f32 tensors is the f32 disk of the JAX package
        under enable_x64(False), and nt_flux on it is JAX's f32 nt_flux.

        r_ms cancels at high spin (3 + z2 - sqrt(...)), so the two
        packages' f32 inner edges differ by a few ulp (each is ~8 ulp from
        the f64 value); the flux is compared on one disk, the port's."""
        with jax.enable_x64(False):
            jd = jdisk.nt_setup(10.0, 0.998, 0.1, 0.1)
        td = tdisk.nt_setup(*(torch.tensor(v, dtype=torch.float32)
                              for v in (10.0, 0.998, 0.1, 0.1)))
        assert td.rms.dtype == torch.float32
        f64 = float(tdisk.nt_setup(10.0, 0.998, 0.1, 0.1, f32_state=False,
                                   device="cpu").rms)
        assert _ulps(td.rms.numpy(), np.asarray(jd.rms)) <= 4.0
        assert _ulps(td.rms.numpy(), np.float32(f64)) <= 16.0
        for name in ("M", "a", "mdot", "alpha"):
            assert float(getattr(td, name)) == float(getattr(jd, name))
        r = np.linspace(float(td.rms) * 1.0001, 30.0, 200).astype(np.float32)
        with jax.enable_x64(False):
            jd = jd._replace(rms=td.rms.numpy())
            jf = np.asarray(jdisk.nt_flux(jd, r))
        tf = tdisk.nt_flux(td, torch.from_numpy(r)).numpy()
        assert tf.dtype == np.float32
        # f32 chains of ~100 roundings: 1e-6 of the peak
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6 * jf.max())

    def test_dump(self, tmp_path, capsys):
        jd = jdisk.nt_setup(10.0, 0.9, 0.1, 0.1)
        td = tdisk.nt_setup(10.0, 0.9, 0.1, 0.1, device="cpu")
        jdisk.nt_dump(jd, str(tmp_path / "j.txt"), rmax=100.0)
        tdisk.nt_dump(td, str(tmp_path / "t.txt"), rmax=100.0)
        j = np.loadtxt(tmp_path / "j.txt")
        t = np.loadtxt(tmp_path / "t.txt")
        assert t.shape == j.shape and t.shape[1] == 7
        np.testing.assert_allclose(t, j, rtol=1e-6)
        tdisk.nt_dump(td, rmax=10.0)
        assert "# (sim5_tpu disk.nt) dump" in capsys.readouterr().out
