"""The port's hot-spot light curve (`hotspot_lightcurve`, example 07) and
its equatorial crossing map (`equatorial_crossing_map`), on the CPU at a
small size: a = 0.5, i = 70 deg, r_spot = 7, 16^2 pixels.

The map's pieces (init, midplane crossing, radius, azimuth, g-factor,
travel time) are held against the JAX package in their own files
(test_torch_geodesic.py, test_torch_azimuth.py, test_torch_timedelay.py,
test_torch_disk.py); here the map is held against the same pieces
composed by hand, and the light curve against a numpy re-sum of the
spot's flux over the map.  The whole functions against the JAX package
are in test_torch_slow_parity.py (its compile alone takes minutes).

Tolerances, and why:
* the map against its pieces: bitwise (the same torch operations);
* the light curve against the numpy re-sum: relative 1e-12 (a sum of
  256 positive terms in another order);
* periodicity over two orbital periods (t spans exactly two periods in 16
  samples, sample k + 8 is sample k one period later): relative 1e-9 (the
  phase Om t rounds differently by ulps of 2 pi);
* delays: >= 0 on every hit pixel, exactly 0 at the earliest.
"""

import math

import numpy as np
import pytest
import torch

from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.core import OmegaK, gfactorK, r_ms
from sim5_tpu_torch.render import (equatorial_crossing_map,
                                   hotspot_lightcurve, image_grid)
from sim5_tpu_torch.render.lightcurve import R_FAR

torch.set_num_threads(2)

A, INCL, R_SPOT, SIZE, NPIX = 0.5, math.radians(70.0), 7.0, 0.7, 16
RMAX = 2.5 * R_SPOT


@pytest.fixture(scope="module")
def maps():
    return [equatorial_crossing_map(A, INCL, NPIX, RMAX, order,
                                    device="cpu") for order in (0, 1)]


def _period():
    return 2.0 * math.pi / float(OmegaK(torch.tensor(R_SPOT,
                                                     dtype=torch.float64), A))


@pytest.mark.parametrize("order", [0, 1])
def test_map_is_its_pieces(maps, order):
    """The map's fields against the pieces composed by hand: hit cut at
    r_ms, the far-field anchor R_FAR with the plane-wavefront correction,
    delays relative to the earliest hit."""
    m = maps[order]
    alpha, beta = image_grid(NPIX, NPIX, RMAX, device="cpu")
    g = tgd.geodesic_init_inf(INCL, A, alpha, beta)
    P = tgd.geodesic_find_midplane_crossing(g, order)
    r = tgd.geodesic_position_rad(g, P)
    hit = torch.isfinite(r) & (g.status == 0)
    r = torch.where(hit, r, 10.0)
    zero = torch.zeros_like(r)
    Ph = torch.where(hit, P, 1.0)
    phi = tgd.geodesic_position_azm(g, r, zero, Ph)
    gf = gfactorK(r, A, g.l)
    hit = hit & torch.isfinite(gf) & (r > r_ms(torch.tensor(A,
                                                            dtype=r.dtype)))
    P_far = tgd.geodesic_P_int(g, torch.full_like(r, R_FAR), 0)
    dt = tgd.geodesic_timedelay_full(
        g, Ph, r, zero, P_far, tgd.geodesic_position_rad(g, P_far),
        tgd.geodesic_position_pol(g, P_far))
    dt = dt + (alpha ** 2 + beta ** 2) / (2.0 * R_FAR)
    dt = dt - dt[hit].min()
    assert torch.equal(m["hit"], hit)
    assert float(hit.float().mean()) > (0.5 if order == 0 else 0.01)
    assert torch.equal(m["r"], r)
    for key, want in (("phi", phi), ("g", gf), ("delay", dt)):
        assert torch.equal(m[key][hit], want[hit]), key
    # off the hits: phi 0, g 1, and the delay 0 less the shift of the hits
    assert bool((m["phi"][~hit] == 0.0).all())
    assert bool((m["g"][~hit] == 1.0).all())
    assert bool((m["delay"][~hit] == m["delay"][~hit][0]).all())
    assert m["pixel_area"] == (2.0 * RMAX / NPIX) ** 2


@pytest.mark.parametrize("order", [0, 1])
def test_delays(maps, order):
    m = maps[order]
    d = m["delay"][m["hit"]]
    assert bool((d >= 0.0).all()) and float(d.min()) == 0.0
    assert float(d.max()) > 1.0


def test_lightcurve_is_the_sum_over_maps(maps):
    period = _period()
    t = np.arange(16) / 16 * 2 * period
    lc = hotspot_lightcurve(A, INCL, R_SPOT, SIZE, t, npix=NPIX,
                            device="cpu").numpy()
    Om = 2.0 * np.pi / period
    want = np.zeros_like(t)
    for m in maps:
        r, phi, g, delay, hit = (m[k].numpy() for k in
                                 ("r", "phi", "g", "delay", "hit"))
        for i, ti in enumerate(t):
            dphi = np.mod(phi - Om * (ti - delay) + np.pi, 2 * np.pi) - np.pi
            d2 = (r - R_SPOT) ** 2 + (r * dphi) ** 2
            flux = np.exp(-0.5 * d2 / SIZE ** 2) * g ** 4
            want[i] += np.sum(np.where(hit, flux, 0.0)) * m["pixel_area"]
    assert (want > 0).all() and want.max() / want.min() > 1.5
    np.testing.assert_allclose(lc, want, rtol=1e-12)
    # two orbital periods: sample k + 8 is sample k one period later
    np.testing.assert_allclose(lc[8:], lc[:8], rtol=1e-9)
