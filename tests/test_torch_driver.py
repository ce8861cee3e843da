"""The port's disk raytracing driver (`sim5_tpu_torch.render.DiskRaytrace`:
images and spectra of thin and thick disks) against `sim5_tpu` on the same
disk and grid, against the reference Python layer's goldens, and
tests/test_driver.py's gates, on the CPU.

Both packages get the same NT disk: its parameters are built once by the
JAX package and handed to the port (`NTDisk.from_numpy`), which keeps
XLA's f32 `cbrt` ulp (core/orbits.py:26) out of the comparison.  The
thick disk is test_driver.py's toy cone, written once in jnp and once in
torch.

Tolerances, and why:
* images against JAX: NaN masks equal; each map within 1e-10 of its peak
  (the same f64 algebra; the thick disk adds a 24-step bisection);
* the goldens: test_driver.py's own (image maps rtol 1e-4, mue 1e-3 on
  > 99% of the pixels; the odd-grid spectrum rtol 3e-2; the even grid's
  one-sided bound);
* spectra against JAX at radres 2, angres 10: relative 1e-10 where the
  spectrum is above 1e-6 of its peak; domega_err and domega_tot relative
  1e-12 (sums of the same terms in another order);
* the distance scaling: 4 to rtol 1e-10 (test_driver.py);
* the f32 spectrum against f64: < 1e-5 relative (test_driver.py).
"""


import numpy as np
import jax.numpy as jnp
import torch

from sim5_tpu.disk import ThinDisk as JThinDisk
from sim5_tpu.render import (DiskRaytrace as JDiskRaytrace,
                             DiskSpectrum_BlackBody as JBlackBody)
from sim5_tpu_torch.disk import ThinDisk, NTDisk
from sim5_tpu_torch.render import DiskRaytrace, DiskSpectrum_BlackBody
from tests.conftest import GOLDEN

torch.set_num_threads(2)

KEYS = ("flux", "gfactor", "mue", "T", "R", "H", "V")


def _thin(a=0.7, alpha=0.1, dtype=torch.float64):
    """(JAX ThinDisk, the port's ThinDisk with the same parameters)."""
    jd = JThinDisk.create(10.0, a, 0.1, alpha)
    d = {k: np.asarray(v, np.float64) for k, v in jd.params._asdict().items()
         if k != "options"}
    td = NTDisk.from_numpy(d, device="cpu")
    td = td._replace(**{k: getattr(td, k).to(dtype)
                        for k in ("M", "a", "mdot", "rms", "alpha")})
    return jd, ThinDisk(td)


def _drivers(dist=10.0, alpha=0.1):
    jd, td = _thin(alpha=alpha)
    return (JDiskRaytrace(10.0, 0.7, dist, jd, JBlackBody()),
            DiskRaytrace(10.0, 0.7, dist, td, DiskSpectrum_BlackBody(),
                         device="cpu"))


class JaxCone:
    """tests/test_driver.py's toy thick disk (H = 0.05 R, inner edge 6)."""
    slope = 0.05

    def r_min(self):
        return 6.0

    def mdot(self):
        return jnp.asarray(0.1)

    def flux(self, r):
        return jnp.where(r > 6.0, 1.0 / jnp.maximum(r, 1.0) ** 3, 0.0)

    def t_eff(self, r):
        return jnp.where(r > 6.0, 1e7 / jnp.maximum(r, 1.0) ** 0.75, 0.0)

    def ell(self, r):
        from sim5_tpu.core import ellK
        return ellK(jnp.maximum(r, 6.0), 0.5)

    def vr(self, r):
        return jnp.zeros_like(r)

    def h(self, r):
        return self.slope * r

    def dhdr(self, r):
        return jnp.full_like(r, self.slope)


class TorchCone:
    """The same cone on tensors."""
    slope = 0.05

    def r_min(self):
        return 6.0

    def mdot(self):
        return torch.tensor(0.1, dtype=torch.float64)

    def flux(self, r):
        return torch.where(r > 6.0, 1.0 / torch.clamp(r, min=1.0) ** 3, 0.0)

    def t_eff(self, r):
        return torch.where(r > 6.0, 1e7 / torch.clamp(r, min=1.0) ** 0.75,
                           0.0)

    def ell(self, r):
        from sim5_tpu_torch.core import ellK
        return ellK(torch.clamp(r, min=6.0), 0.5)

    def vr(self, r):
        return torch.zeros_like(r)

    def h(self, r):
        return self.slope * r

    def dhdr(self, r):
        return torch.full_like(r, self.slope)


def _same_image(got, want):
    for k in KEYS:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.array_equal(np.isnan(g), np.isnan(w)), f"{k}: NaN mask"
        f = ~np.isnan(w)
        peak = np.abs(w[f]).max()
        err = np.abs(g[f] - w[f]).max()
        assert err <= 1e-10 * peak, f"{k}: {err:.3e} of peak {peak:.3e}"


class TestImage:
    def test_thin_against_jax(self):
        jrt, trt = _drivers()
        got = trt.image(60.0, 20.0, 16)
        _same_image(got, jrt.image(60.0, 20.0, 16))
        hit = np.isfinite(got["flux"].numpy())
        assert hit.mean() > 0.2
        assert got["flux"].device.type == "cpu"

    def test_thick_against_jax(self):
        jrt = JDiskRaytrace(10.0, 0.5, 10.0, JaxCone(), JBlackBody())
        trt = DiskRaytrace(10.0, 0.5, 10.0, TorchCone(),
                           DiskSpectrum_BlackBody(), device="cpu")
        got = trt.image(55.0, 25.0, 24)
        _same_image(got, jrt.image(55.0, 25.0, 24))
        # tests/test_driver.py's gates
        F, H = got["flux"].numpy(), got["H"].numpy()
        assert np.isfinite(F).mean() > 0.2
        assert np.nanmax(np.abs(H)) > 0.1

    def test_matches_reference_python_layer(self):
        """test_driver.py's golden image and tolerances."""
        ref = np.load(GOLDEN / "driver_image_a07.npy")
        _, trt = _drivers()
        im = trt.image(60.0, 20.0, 32, limbdk=1)
        for i, k in enumerate(KEYS):
            got = im[k].numpy()
            want = ref[i]
            hit_g, hit_w = np.isfinite(got), np.isfinite(want)
            assert (hit_g == hit_w).mean() > 0.99, f"{k}: hit footprint"
            both = hit_g & hit_w
            tol = (dict(rtol=1e-3, atol=1e-3) if k == "mue"
                   else dict(rtol=1e-4, atol=1e-12))
            assert np.isclose(got[both], want[both], **tol).mean() > 0.99, k
        assert np.allclose(im["H"].numpy()[np.isfinite(im["H"].numpy())],
                           0.0, atol=1e-10)


class TestSpectrum:
    def test_against_jax(self):
        E = np.geomspace(0.5, 10.0, 8)
        jrt, trt = _drivers()
        kw = dict(radres=2.0, angres=10, hardening=1.7,
                  return_diagnostics=True)
        jf, j0, jdiag = jrt.spectrum(60.0, E, **kw)
        tf, t0, tdiag = trt.spectrum(60.0, E, batch=1000, **kw)
        for got, want in ((tf, jf), (t0, j0)):
            got = got.numpy()
            nz = want > 1e-6 * want.max()
            np.testing.assert_allclose(got[nz], want[nz], rtol=1e-10)
        for k in ("domega_err", "domega_tot"):
            np.testing.assert_allclose(tdiag[k], jdiag[k], rtol=1e-12)
        # unhardened, no limb darkening: the other branches of the batch
        jf, _ = jrt.spectrum(60.0, E, radres=2.0, angres=10, limbdk=0)
        tf, _ = trt.spectrum(60.0, E, radres=2.0, angres=10, limbdk=0)
        nz = jf > 1e-6 * jf.max()
        np.testing.assert_allclose(tf.numpy()[nz], jf[nz], rtol=1e-10)

    def test_coverage_warning(self, caplog):
        """A grid that ends at r = 30 puts the shadow and the plunging
        region at > 1% of the solid angle: both packages report the same
        coverage error, and the port logs its warning."""
        E = np.geomspace(0.5, 10.0, 8)
        jd, td = _thin()
        jrt = JDiskRaytrace(10.0, 0.7, 10.0, jd, JBlackBody(), r_max=30.0)
        trt = DiskRaytrace(10.0, 0.7, 10.0, td, DiskSpectrum_BlackBody(),
                           r_max=30.0, device="cpu")
        kw = dict(radres=2.0, angres=10, return_diagnostics=True)
        *_, jdiag = jrt.spectrum(60.0, E, **kw)
        with caplog.at_level("INFO", logger="sim5_tpu_torch"):
            *_, tdiag = trt.spectrum(60.0, E, **kw)
        assert tdiag["domega_err"] > 0.01 * tdiag["domega_tot"]
        for k in ("domega_err", "domega_tot"):
            np.testing.assert_allclose(tdiag[k], jdiag[k], rtol=1e-12)
        assert "spectrum_coverage_warning" in caplog.text

    def test_default_device_is_the_card(self):
        _, td = _thin()
        rt = DiskRaytrace(10.0, 0.7, 10.0, td, DiskSpectrum_BlackBody())
        assert rt.device == torch.device("cuda")
        assert rt.dtype == torch.float64
        assert DiskRaytrace(10.0, 0.0, 10.0, td, DiskSpectrum_BlackBody(),
                            device="cpu").bh_spin == 1e-4

    def test_distance_scaling(self):
        E = np.geomspace(0.5, 10.0, 8)
        s1, _ = _drivers(10.0)[1].spectrum(60.0, E, radres=2.0, angres=10,
                                           hardening=1.7)
        s2, _ = _drivers(20.0)[1].spectrum(60.0, E, radres=2.0, angres=10,
                                           hardening=1.7)
        np.testing.assert_allclose((s1 / s2).numpy(), 4.0, rtol=1e-10)

    def test_matches_reference_python_layer(self):
        """test_driver.py's odd-grid golden (rtol 3e-2) and the even grid's
        one-sided bound."""
        _, trt = _drivers()
        E, sf_ref, s0_ref = np.load(GOLDEN / "driver_spectrum_a07_odd.npy")
        sf, s0 = trt.spectrum(60.0, E, limbdk=1, flat=1, radres=2.0,
                              angres=11.0, hardening=1.7)
        nz = sf_ref > 1e-3 * sf_ref.max()
        np.testing.assert_allclose(sf.numpy()[nz], sf_ref[nz], rtol=3e-2)
        np.testing.assert_allclose(s0.numpy()[nz], s0_ref[nz], rtol=3e-2)
        E, sf_ref, s0_ref = np.load(GOLDEN / "driver_spectrum_a07.npy")
        sf, s0 = trt.spectrum(60.0, E, limbdk=1, flat=1, radres=2.0,
                              angres=10.0, hardening=1.7)
        sf = sf.numpy()
        nz = sf_ref > 1e-3 * sf_ref.max()
        assert (sf[nz] >= sf_ref[nz] * (1.0 - 3e-2)).all()
        assert (sf[nz] <= sf_ref[nz] * (1.0 + 2.0 / 14.0 + 3e-2)).all()

    def test_f32_matches_f64(self):
        """test_driver.py's fast-mode configuration: the f32 driver on an
        f32 disk against f64."""
        E = np.geomspace(0.5, 10.0, 12)
        kw = dict(radres=1.0, angres=20.0)
        _, td64 = _thin(alpha=0.1)
        s64, _ = DiskRaytrace(10.0, 0.7, 10.0, td64, DiskSpectrum_BlackBody(),
                              device="cpu").spectrum(60.0, E, **kw)
        _, td32 = _thin(alpha=0.1, dtype=torch.float32)
        rt32 = DiskRaytrace(10.0, 0.7, 10.0, td32, DiskSpectrum_BlackBody(),
                            device="cpu", dtype=torch.float32)
        s32, _ = rt32.spectrum(60.0, E, **kw)
        s64, s32 = s64.numpy(), s32.numpy()
        nz = s64 > 1e-6 * s64.max()
        rel = np.abs(s32[nz] - s64[nz]) / s64[nz]
        assert rel.max() < 1e-5, f"f32 spectrum rel err {rel.max():.2e}"
