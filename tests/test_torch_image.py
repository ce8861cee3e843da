"""The port's Novikov-Thorne disk image (`sim5_tpu_torch.render`, its plain
torch version on the CPU) and the midplane crossing it rests on, against
`sim5_tpu` on the same inputs and against the C reference
(tests/golden/geod.txt "gmid", image128_a0.txt, image128_a998.txt).

The frame of the f32/f64 comparisons is bench.py's headline frame cut to
64^2: a = 0.998, i = 80 deg, M = 10, mdot = 0.1, alpha = 0.1.

Tolerances, and why:
* crossing against C: test_geodesic.py's gates (P and r 1e-6, NaN
  patterns equal on > 99%); against JAX: relative 1e-10 and the same NaN
  pattern (the same f64 operations in another order of fusion);
* f64 image against the goldens: the BASELINE gate, 1e-6 of the peak,
  identical footprint, g within 1e-5 relative (test_disk_render.py);
* f64 against JAX f64: 1e-12 of the peak, identical footprint;
* f32 against JAX f32 (enable_x64(False)) on the same f32 disk: 1e-6 of
  the peak, identical footprint (two f32 chains of ~10^3 roundings in
  other orders);
* f32 against the port's f64: 4e-6 of the peak where both hit, footprint
  mismatch <= 1e-5 of the pixels (bench.py's fast-path gate).
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu.disk import NTDisk as JNTDisk, nt_setup as jnt_setup
from sim5_tpu.render import render_disk_image as jrender
from sim5_tpu.render.image import image_grid as jimage_grid
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import image as timage
from sim5_tpu_torch.render import kernel_image

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
FRAME = dict(M=10.0, a=0.998, mdot=0.1, alpha=0.1, incl=np.radians(80.0))
NPIX = 64


def _disk(dtype, a=FRAME["a"], **kw):
    vals = (FRAME["M"], a, FRAME["mdot"], FRAME["alpha"])
    return nt_setup(*(torch.tensor(v, dtype=dtype) for v in vals), **kw)


def _err_of_peak(got, want):
    """(max |got - want| / peak of want where both hit, footprint
    mismatches)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    both = (got > 0) & (want > 0)
    return (float(np.abs(got - want)[both].max() / want.max()),
            int(((got > 0) != (want > 0)).sum()))


def _parse_gmid():
    """(init rows, crossings [order, P, r] per order) of the records the
    C reference initialised."""
    recs, cur = [], None
    with open(GOLDEN / "geod.txt") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag, vals = parts[0], [float(v) for v in parts[1:]]
            if tag == "ginit":
                cur = {"init": vals, "mid": []}
                recs.append(cur)
            elif tag == "gmid":
                cur["mid"].append(vals)
    ok = [r for r in recs if r["init"][4] == 1]
    return np.asarray([r["init"] for r in ok]), ok


class TestMidplaneCrossing:

    def test_golden(self):
        arr, recs = _parse_gmid()
        g = tgd.geodesic_init_inf(*(torch.tensor(arr[:, c]) for c in
                                    (1, 0, 2, 3)))
        for order in (0, 1):
            ref = np.asarray([r["mid"][order] for r in recs])
            P = tgd.geodesic_find_midplane_crossing(g, order)
            r = tgd.geodesic_position_rad(g, P).numpy()
            P = P.numpy()
            both = np.isfinite(ref[:, 1]) & np.isfinite(P)
            assert (np.isfinite(ref[:, 1]) == np.isfinite(P)).mean() > 0.99
            assert both.sum() > 100
            np.testing.assert_allclose(P[both], ref[both, 1], rtol=1e-6,
                                       atol=1e-9)
            rboth = both & np.isfinite(ref[:, 2]) & np.isfinite(r)
            assert (np.isfinite(ref[:, 2])[both]
                    == np.isfinite(r)[both]).mean() > 0.99
            np.testing.assert_allclose(r[rboth], ref[rboth, 2], rtol=1e-6,
                                       atol=1e-8)

    def test_against_jax_on_the_frame_grid(self):
        jd = jnt_setup(10.0, FRAME["a"], 0.1, 0.1)
        rmax = float(jd.rms) - 1e-3 + 8.0
        alpha, beta = (np.asarray(v) for v in jimage_grid(32, 32, rmax))
        gj = jgd.geodesic_init_inf(FRAME["incl"], jd.a, alpha, beta)
        a = torch.tensor(float(jd.a), dtype=torch.float64)
        gt = tgd.geodesic_init_inf(FRAME["incl"], a, torch.from_numpy(alpha),
                                   torch.from_numpy(beta))
        for order in (0, 1):
            Pj = np.asarray(jgd.geodesic_find_midplane_crossing(gj, order))
            Pt = tgd.geodesic_find_midplane_crossing(gt, order)
            rj = np.asarray(jgd.geodesic_position_rad(gj, Pj))
            rt = tgd.geodesic_position_rad(gt, Pt).numpy()
            Pt = Pt.numpy()
            for t, j in ((Pt, Pj), (rt, rj)):
                np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
                f = np.isfinite(j)
                assert f.mean() > 0.2
                np.testing.assert_allclose(t[f], j[f], rtol=1e-10)


class TestImageGolden:

    @pytest.mark.parametrize("fname,a,inc", [
        ("image128_a0.txt", 0.0, 60.0),
        ("image128_a998.txt", 0.998, 80.0),
    ])
    def test_f64_image_matches_reference(self, fname, a, inc):
        d = np.loadtxt(GOLDEN / fname)
        ref_f = d[:, 2].reshape(128, 128)
        ref_g = d[:, 3].reshape(128, 128)
        disk = nt_setup(10.0, a, 0.1, 0.1, device="cpu")
        imf, img = timage.render_disk_image(disk, np.radians(inc), 128, 128)
        assert imf.dtype == torch.float64 and imf.shape == (128, 128)
        imf, img = imf.numpy(), img.numpy()
        assert np.max(np.abs(imf - ref_f)) / ref_f.max() < 1e-6
        np.testing.assert_array_equal(imf > 0, ref_f > 0)
        both = (img > 0) & (ref_g > 0)
        assert np.max(np.abs(img - ref_g)[both] / ref_g[both]) < 1e-5


class TestImageAgainstJax:

    def test_f64(self):
        jd = jnt_setup(10.0, FRAME["a"], 0.1, 0.1)
        jf, jg = (np.asarray(v) for v in jrender(jd, FRAME["incl"], NPIX,
                                                 NPIX))
        tf, tg = timage.render_disk_image(_disk(torch.float64),
                                          FRAME["incl"], NPIX, NPIX)
        err, mismatch = _err_of_peak(tf.numpy(), jf)
        assert mismatch == 0 and err <= 1e-12
        assert np.abs(tg.numpy() - jg).max() <= 1e-12
        assert (jf > 0).mean() > 0.2

    def test_f32(self):
        """Both packages render the port's f32 disk.  (The JAX package's
        own f32 nt_setup takes XLA's CPU cbrt, one ulp below the correctly
        rounded cube root of 1 - a^2 at a = 0.998; that moves its f32 rms
        by 2 ulp and its image by 2.8e-6 of the peak.)"""
        disk = _disk(torch.float32)
        with jax.enable_x64(False):
            jd = JNTDisk(**disk.numpy())
            jf = np.asarray(jrender(jd, np.float32(FRAME["incl"]), NPIX,
                                    NPIX)[0])
        assert jf.dtype == np.float32
        tf, _ = timage.render_disk_image(disk, FRAME["incl"], NPIX, NPIX)
        assert tf.dtype == torch.float32
        err, mismatch = _err_of_peak(tf.numpy(), jf)
        assert mismatch == 0 and err <= 1e-6


class TestFastPath:

    def test_f32_against_f64(self):
        f64, g64 = timage.render_disk_image(_disk(torch.float64),
                                            FRAME["incl"], NPIX, NPIX)
        f32, g32 = timage.render_disk_image(_disk(torch.float32),
                                            FRAME["incl"], NPIX, NPIX)
        err, mismatch = _err_of_peak(f32.numpy(), f64.numpy())
        assert err <= 4e-6 and mismatch <= 1e-5 * NPIX * NPIX
        both = (g32.numpy() > 0) & (g64.numpy() > 0)
        assert np.abs(g32.numpy() - g64.numpy())[both].max() <= 1e-5

    def test_cpu_disk_takes_the_plain_version(self):
        disk = _disk(torch.float64)
        before = dict(kernel_image.LAUNCHES)
        out = timage.render_disk_image(disk, FRAME["incl"], 16, 8, rmax=9.0)
        ref = timage.render_disk_image_reference(disk, FRAME["incl"], 16, 8,
                                                 rmax=9.0)
        for a, b in zip(out, ref):
            assert a.shape == (8, 16)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert kernel_image.LAUNCHES == before
        assert kernel_image._LIB is None

    def test_gradients_vs_finite_differences(self):
        """The plain version is differentiable in (a, incl), as the JAX
        image is (test_disk_render.py), with the NaN-safe dummies kept."""
        def total_flux(a, incl):
            disk = nt_setup(10.0, a, 0.1, 0.1, f32_state=False)
            imf, _ = timage.render_disk_image(disk, incl, 32, 32)
            return imf.sum() / 1e26

        a0 = torch.tensor(0.41, dtype=torch.float64, requires_grad=True)
        i0 = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
        ga, gi = torch.autograd.grad(total_flux(a0, i0), (a0, i0))
        eps = 1e-6

        def f(a, i):
            return float(total_flux(torch.tensor(a, dtype=torch.float64),
                                    torch.tensor(i, dtype=torch.float64)))

        fda = (f(0.41 + eps, 1.05) - f(0.41 - eps, 1.05)) / (2 * eps)
        fdi = (f(0.41, 1.05 + eps) - f(0.41, 1.05 - eps)) / (2 * eps)
        assert np.isfinite(float(ga)) and np.isfinite(float(gi))
        assert np.isclose(float(ga), fda, rtol=1e-4), (float(ga), fda)
        assert np.isclose(float(gi), fdi, rtol=1e-4), (float(gi), fdi)
