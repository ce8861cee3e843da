"""The port's black-hole shadow (`render_bh_image`, example 09) and its
capture predicate (`geodesic_is_captured`): against `sim5_tpu` on the
same inputs, and the physics gates of tests/test_shadow.py run on the
port, on the CPU.

Tolerances, and why:
* masks (captured, hit): identical;
* r: relative 1e-12 (the same f64 algebra; it agrees to a few ulps);
* g: relative 1e-12 outside the ISCO (Keplerian); inside it 1e-12 + 16 N,
  N the plunging g-factor's rounding noise: its spread over 1-4 ulps of
  r, l and q on each pixel.  Near the ISCO gfactor_plunge's u_r^2 is a
  difference of terms up to ~1e9 times larger, so N reaches 8e-13 at
  32^2 (2.5e-11 at 64^2), and the JAX package and the port differ by up
  to 0.06 of the bound;
* flux = F g^4: four times g's bound plus 3e-13 (F ~ r^-3 inside);
* the physics gates: tests/test_shadow.py's own.
"""

import math

import numpy as np
import pytest
import torch

from sim5_tpu import disk as jdisk
from sim5_tpu import geodesic as jgd
from sim5_tpu.render import render_bh_image as j_render_bh_image
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.core import (r_bh, r_ms, gfactorK, photon_momentum)
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.geodesic import Geodesic
from sim5_tpu_torch.render import BHImage, image_grid, render_bh_image
from sim5_tpu_torch.render.shadow import gfactor_plunge

torch.set_num_threads(2)

# example 09's defaults (a = 0.998, 80 deg, rmax 10, its disk and inner
# emissivity) at 32^2
A, INCL, RMAX, NPIX = 0.998, math.radians(80.0), 10.0, 32


def _emissivity(r):
    return 1e22 * r ** -3


def _plunge_noise(im):
    """The relative spread of each plunging pixel's g-factor when r, l or
    q moves by 1-4 ulps (0 outside the ISCO)."""
    alpha, beta = image_grid(NPIX, NPIX, RMAX, device="cpu")
    g = tgd.geodesic_init_inf(INCL, A, alpha, beta)
    inside = im.hit & (im.r < r_ms(g.a))
    r = torch.where(inside, im.r, r_ms(g.a))
    one = torch.ones_like(r)

    def gp(r, l, q):
        k = photon_momentum(g.a, r, torch.zeros_like(r), l, q, one, one)
        return gfactor_plunge(r, g.a, torch.where(torch.isfinite(k), k, 0.0))

    base, N = gp(r, g.l, g.q), torch.zeros_like(r)
    for ulps in (-4, -2, -1, 1, 2, 4):
        for i in range(3):
            x = [r, g.l, g.q]
            x[i] = x[i] * (1.0 + ulps * np.finfo(np.float64).eps)
            N = torch.maximum(N, ((gp(*x) - base) / base).abs())
    return torch.where(inside, N, 0.0)


class TestAgainstJax:
    @pytest.fixture(scope="class")
    def images(self):
        jd = jdisk.nt_setup(10.0, A, 0.1, 0.1)
        want = j_render_bh_image(A, INCL, NPIX, NPIX, rmax=RMAX, disk=jd,
                                 inner_emissivity=_emissivity)
        got = render_bh_image(A, INCL, NPIX, NPIX, rmax=RMAX,
                              disk=nt_setup(10.0, A, 0.1, 0.1, device="cpu"),
                              inner_emissivity=_emissivity)
        return want, got

    def test_masks_identical(self, images):
        want, got = images
        assert isinstance(got, BHImage)
        for f in ("captured", "hit"):
            t = getattr(got, f)
            assert t.dtype == torch.bool and t.shape == (NPIX, NPIX)
            assert (t.numpy() == np.asarray(getattr(want, f))).all(), f
        # the example's image has all three kinds of pixel
        hit, cap = got.hit.numpy(), got.captured.numpy()
        assert hit.sum() > 100 and cap.sum() > 50 and (cap & hit).sum() > 0

    @pytest.mark.parametrize("field,scale,extra", [("r", 0.0, 0.0),
                                                   ("g", 1.0, 0.0),
                                                   ("flux", 4.0, 3e-13)])
    def test_maps(self, images, field, scale, extra):
        want, got = images
        w = np.asarray(getattr(want, field))
        t = getattr(got, field)
        assert t.dtype == torch.float64
        t = t.numpy()
        assert (np.isnan(t) == np.isnan(w)).all() and ((t == 0) == (w == 0)).all()
        nz = np.isfinite(w) & (w != 0)
        assert nz.sum() > 100
        bound = 1e-12 + scale * (16.0 * _plunge_noise(got).numpy() + extra)
        rel = np.abs(t[nz] - w[nz]) / np.abs(w[nz])
        assert (rel / bound[nz]).max() <= 1.0, f"{field}: {rel.max():.3e}"

    def test_is_captured(self):
        """The port's predicate on the JAX package's geodesics and on its
        own, over spins and inclinations, at image-plane points around the
        shadow's edge."""
        rng = np.random.default_rng(5)
        n = 2048
        a = rng.choice([0.0, 0.3, 0.9, 0.998], n)
        inc = np.radians(rng.choice([5.0, 45.0, 80.0], n))
        rad = rng.uniform(1.0, 9.0, n)
        ang = rng.uniform(0, 2 * np.pi, n)
        al, be = rad * np.cos(ang), rad * np.sin(ang)
        gj = jgd.geodesic_init_inf(inc, a, al, be)
        want = np.asarray(jgd.geodesic_is_captured(gj))
        assert 0.2 < want.mean() < 0.8
        g_from_jax = Geodesic.from_numpy(
            {k: np.asarray(v) for k, v in gj._asdict().items()
             if v is not None}, device="cpu")
        assert (tgd.geodesic_is_captured(g_from_jax).numpy() == want).all()
        gt = tgd.geodesic_init_inf(*(torch.from_numpy(v)
                                     for v in (inc, a, al, be)))
        assert (tgd.geodesic_is_captured(gt).numpy() == want).all()


class TestBHImage:
    """tests/test_shadow.py's gates, on the port."""

    def test_shadow_area_schwarzschild(self):
        """a -> 0: captured solid angle = pi*27 in image-plane units."""
        rmax = 10.0
        im = render_bh_image(1e-3, math.radians(60.0), 256, 256, rmax=rmax,
                             device="cpu")
        area = float(im.captured.double().mean()) * (2 * rmax) ** 2
        assert abs(area - math.pi * 27.0) / (math.pi * 27.0) < 0.02

    def test_masks_and_flux(self):
        a, inc = 0.998, math.radians(80.0)
        disk = nt_setup(10.0, a, 0.1, 0.1, device="cpu")
        im = render_bh_image(a, inc, 128, 128, rmax=8.0, disk=disk,
                             inner_emissivity=_emissivity)
        assert im.flux.device.type == "cpu"
        cap, hit = im.captured, im.hit
        # captured rays that cross the midplane above the horizon first
        # still emit (plunging matter in front of the shadow)
        assert int((cap & hit).sum()) > 0
        assert bool(torch.isfinite(im.flux).all()) and bool((im.flux >= 0).all())
        rms = float(r_ms(torch.tensor(a, dtype=torch.float64)))
        assert float(im.flux[hit & (im.r < rms)].max()) > 0   # inner glow
        assert bool((im.flux[~hit] == 0).all())

    def test_infinite_redshift_at_horizon(self):
        """g -> 0 as the emission radius approaches the horizon."""
        im = render_bh_image(0.9, math.radians(70.0), 128, 128, rmax=10.0,
                             device="cpu")
        a = torch.tensor(0.9, dtype=torch.float64)
        inside = im.hit & (im.r < r_ms(a))
        assert int(inside.sum()) > 100
        gin = im.g[inside]
        assert bool(torch.isfinite(gin).all()) and bool((gin > 0).all())
        deep = inside & (im.r < 1.05 * r_bh(a))
        assert int(deep.sum()) > 0 and float(im.g[deep].max()) < 0.35


class TestPlungeGfactor:
    def test_continuous_at_isco(self):
        """The plunging flow starts from the circular ISCO orbit, so its
        redshift matches the Keplerian one there (tests/test_shadow.py)."""
        a, inc = 0.9, math.radians(60.0)
        al = torch.linspace(-8.0, 8.0, 41, dtype=torch.float64)
        be = torch.linspace(0.3, 6.0, 21, dtype=torch.float64)
        B, Al = torch.meshgrid(be, al, indexing="ij")
        g = tgd.geodesic_init_inf(inc, a, Al, B)
        r0 = tgd.geodesic_position_rad(
            g, tgd.geodesic_find_midplane_crossing(g, 0))
        rms = float(r_ms(torch.tensor(a, dtype=torch.float64)))
        near = (torch.isfinite(r0) & ((r0 - rms).abs() < 0.15 * rms)
                & (g.status == 0))
        assert int(near.sum()) > 5
        r = torch.full_like(Al, rms)
        one = torch.ones_like(Al)
        k_at = photon_momentum(g.a, r, torch.zeros_like(Al), g.l, g.q, one, one)
        gp = gfactor_plunge(r, g.a, k_at)
        gk = gfactorK(r, g.a, g.l)
        near = near & torch.isfinite(gp) & torch.isfinite(gk)
        assert int(near.sum()) > 5
        rel = ((gp - gk).abs() / gk.abs())[near]
        assert float(rel.max()) < 1e-6
