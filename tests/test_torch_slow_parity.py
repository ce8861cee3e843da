"""Whole-function parity of the port's analytic azimuth, travel time and
light-curve paths against the JAX package, at sizes whose JAX compiles
take minutes (the jitted `geodesic_timedelay_full` about 90 s, each
`equatorial_crossing_map` about 130 s on a CPU): marked `slow`, so tier-1
(`-m 'not slow'`) skips them.  Run with

    python -m pytest tests/test_torch_slow_parity.py -m slow

Tolerances, and why:
* phi: `test_torch_azimuth.phi_bound` (the jitted JAX program's own
  spread at the theta term's turning points, 8 sqrt(eps) |l/a| /
  ((1 - m2p) sqrt(m2m + m2p)));
* travel times: per lane 8 sqrt(eps) a m2p / sqrt(m2m + m2p) + 1e-12
  (1 + |t|) (the same turning point in the poloidal time,
  test_torch_timedelay.py), and for a time from the far radius R_FAR
  = 1e4 in, 1e-10 R_FAR more: the radial part is a sum of Byrd &
  Friedman terms of size ~R_FAR that cancel down to the result, where
  the jitted JAX program and the port differ by up to 1.1e-7 (1.1e-11
  R_FAR; the poloidal parts agree to 1.5e-14); a delay relative to the
  earliest pixel carries that pixel's bound too;
* r and g of the crossing map, and the hit mask: relative 1e-12 (order
  0) and 1e-11 (order 1, whose crossings lie past the periastron, where
  the radius inversion of the jitted program differs by up to 1.5e-12),
  equal;
* the loop-engine volume image of an orbiting spot (a phi-dependent
  callable) against engine="xla": 1e-4 of the peak.  The march steps do
  not depend on phi, so the images differ only through the seed's phi
  (within phi_bound, below 1e-6 rad here) and j's slope in phi,
  |d ln j / d phi| <= pi (rho / arc)^2 ~ 650 for this spot: 650 * 1e-7.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu.render import lightcurve as jlc
from sim5_tpu.render.image import image_grid as jimage_grid
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.render import lightcurve as tlc
from test_torch_azimuth import phi_bound

pytestmark = pytest.mark.slow

torch.set_num_threads(2)
EPS = np.finfo(np.float64).eps


def time_bound(g, t, t_far=0.0):
    return (8.0 * np.sqrt(EPS) * g["a"] * g["m2p"]
            / np.sqrt(np.abs(g["m2m"] + g["m2p"])) + 1e-12 * (1 + np.abs(t))
            + 1e-10 * t_far)


class TestTimedelayFull:
    def test_timedelay_full_matches_jax(self):
        al, be = (np.asarray(v) for v in jimage_grid(16, 16, 12.0))
        gj = jgd.geodesic_init_inf(math.radians(70.0), 0.9, al, be)
        geo = {f: np.asarray(v) for f, v in gj._asdict().items()}
        P2 = np.asarray(jgd.geodesic_find_midplane_crossing(gj, 0))
        P1 = 0.05 * geo["Rpc"]
        g = tgd.Geodesic.from_numpy(geo, device="cpu")
        r1, r2 = (tgd.geodesic_position_rad(g, torch.tensor(P)).numpy()
                  for P in (P1, P2))
        m1 = tgd.geodesic_position_pol(g, torch.tensor(P1)).numpy()
        args = (P1, r1, m1, P2, r2, np.zeros_like(P2))
        want = np.asarray(jax.jit(jgd.geodesic_timedelay_full)(gj, *args))
        got = tgd.geodesic_timedelay_full(
            g, *(torch.tensor(v) for v in args)).numpy()
        f = np.isfinite(want)
        assert (np.isfinite(got) == f).all() and f.mean() > 0.5
        assert (np.abs(got - want)[f] <= time_bound(geo, want)[f]).all()


class TestCrossingMap:
    @pytest.mark.parametrize("order", [0, 1])
    def test_crossing_map_matches_jax(self, order):
        a, incl, npix, rmax = 0.5, math.radians(70.0), 16, 17.5
        want = jlc.equatorial_crossing_map(a, incl, npix, rmax, order)
        got = tlc.equatorial_crossing_map(a, incl, npix, rmax, order,
                                          device="cpu")
        hit = np.asarray(want["hit"])
        np.testing.assert_array_equal(got["hit"].numpy(), hit)
        assert hit.mean() > (0.5 if order == 0 else 0.01)
        for key in ("r", "g"):
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=1e-12 if order == 0 else 1e-11)
        al, be = (np.asarray(v) for v in jimage_grid(npix, npix, rmax))
        geo = {f: np.asarray(v) for f, v in jgd.geodesic_init_inf(
            incl, a, al, be)._asdict().items()}
        phi = np.asarray(want["phi"])
        assert (np.abs(got["phi"].numpy() - phi)
                <= phi_bound(geo, phi))[hit].all()
        d = np.asarray(want["delay"])
        tb = time_bound(geo, d, tlc.R_FAR)
        assert (np.abs(got["delay"].numpy() - d)
                <= tb + tb[hit][np.argmin(d[hit])])[hit].all()


class TestOrbitingVolume:
    def test_loop_engine_matches_xla(self):
        """An orbiting spot (example 07's, as a 3-D source) through the
        loop engine with the default axisymmetric=False, against the JAX
        package's "xla" engine."""
        om = 0.05

        def jspot(t, r, m, phi):
            rho = r * jnp.sqrt(1.0 - m * m)
            dphi = jnp.mod(phi - om * t + jnp.pi, 2 * jnp.pi) - jnp.pi
            return jnp.exp(-0.5 * ((rho - 7.0) ** 2 + (r * m) ** 2
                                   + (rho * dphi) ** 2) / 0.7 ** 2)

        def tspot(t, r, m, phi):
            rho = r * torch.sqrt(1.0 - m * m)
            dphi = torch.remainder(phi - om * t + math.pi,
                                   2 * math.pi) - math.pi
            return torch.exp(-0.5 * ((rho - 7.0) ** 2 + (r * m) ** 2
                                     + (rho * dphi) ** 2) / 0.7 ** 2)

        kw = dict(npix=8, rmax=17.5, r_start=40.0, max_steps=600,
                  precision=0.03)
        Ij = np.asarray(jlc.volume_image(0.5, math.radians(70.0), jspot,
                                         engine="xla", **kw))
        It = tlc.volume_image(0.5, math.radians(70.0), tspot, engine="loop",
                              device="cpu", **kw).numpy()
        peak = Ij.max()
        assert peak > 0
        assert np.abs(It - Ij).max() <= 1e-4 * peak
