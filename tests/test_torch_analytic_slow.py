"""The crossing-map and volume-seed kernels' device code (the g++ harness
of test_torch_analytic_host.py) against the JAX package's jitted
programs whose compiles take minutes: the seed's azimuth stage
(`_volume_seed_azm`) and `equatorial_crossing_map` (orders 0 and 1), at
32^2 on example 07's spot.  Marked `slow`, so tier-1 (`-m 'not slow'`)
skips them; tier-1 holds the harness against the plain torch chains and
the JAX package's axisymmetric seed.  Run with

    python -m pytest tests/test_torch_analytic_slow.py -m slow

Tolerances, and why (test_torch_slow_parity.py's, which holds the plain
chains against the same programs):
* phi: `phi_bound` (the jitted program's own spread at the theta term's
  turning points);
* r and g, the hit and valid sets: relative 1e-12 (order 0), 1e-11
  (order 1, whose crossings lie past the periastron, where the jitted
  program's radius inversion differs by up to 1.5e-12); equal;
* the delay: `time_bound` with 1e-10 R_FAR for the radial part from
  R_FAR, and the anchor pixel's bound beside each pixel's.
"""

import math

import numpy as np
import pytest
import torch

from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.render import lightcurve as tlc
from test_torch_analytic_host import (SPOT, NPIX, host_crossing, host_seed,
                                      lib, phi_bound, seed_geodesic,
                                      time_bound)

pytestmark = pytest.mark.slow

__all__ = ["lib"]   # the harness fixture, shared


def test_seed_azimuth(lib):
    g, ok, P0s, r0, m0 = jlc._volume_seed_geom(
        SPOT["a"], SPOT["incl"], NPIX, SPOT["rmax"], SPOT["r_start"])
    phi = torch.from_numpy(np.array(jlc._volume_seed_azm(g, ok, P0s, r0,
                                                          m0)))
    x0, _, hok = host_seed(lib, SPOT, True)
    jok = torch.from_numpy(np.array(ok)) & torch.isfinite(phi)
    assert torch.equal(hok, jok)
    gt = seed_geodesic(SPOT)
    err = (x0[..., 3] - phi).abs()
    assert bool((err <= phi_bound(gt, phi))[hok].all())


@pytest.mark.parametrize("order", [0, 1])
def test_crossing_map(lib, order):
    cfg = dict(a=SPOT["a"], incl=SPOT["incl"], rmax=17.5)
    jm = jlc.equatorial_crossing_map(cfg["a"], cfg["incl"], NPIX,
                                     cfg["rmax"], order)
    jm = {k: torch.from_numpy(np.array(v)) for k, v in jm.items()
          if k != "pixel_area"}
    m = host_crossing(lib, cfg, order)
    hit = jm["hit"]
    assert torch.equal(m["hit"], hit)
    rtol = 1e-12 if order == 0 else 1e-11
    for key in ("r", "g"):
        rel = ((m[key] - jm[key]).abs() / jm[key].abs())[hit]
        assert float(rel.max()) <= rtol, key
    g = seed_geodesic(cfg)
    assert bool(((m["phi"] - jm["phi"]).abs()
                 <= phi_bound(g, jm["phi"]))[hit].all())
    tb = time_bound(g, jm["delay"], tlc.R_FAR)
    tb = tb + tb[hit][int(jm["delay"][hit].argmin())]
    dt = m["dt"] - torch.where(hit, m["dt"], math.inf).min()
    assert bool(((dt - jm["delay"]).abs() <= tb)[hit].all())
