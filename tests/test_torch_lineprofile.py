"""The port's line profile and transfer function
(`sim5_tpu_torch.render.lineprofile`) against `sim5_tpu` at small sizes,
and tests/test_driver.py's line-profile gates on the port, on the CPU.

Tolerances, and why:
* per-pixel maps (r, g, hit): masks identical, r and g relative 1e-12
  (the same f64 algebra);
* bins: each pixel's g-bin and r-bin identical (truncation toward zero,
  then the clip; left-sided searchsorted), so the profile's and the
  table's empty cells are the same;
* binned values: relative 1e-12 of the largest bin (sums of the same
  terms; on the CPU index_add_ and segment_sum both add in pixel order);
* the table's total: T.sum() == hit.sum() * dA at rtol 1e-10, as
  tests/test_driver.py.
"""

import math

import numpy as np
import pytest
import torch

from sim5_tpu.render import lineprofile as jlp
from sim5_tpu_torch.render import lineprofile as tlp

torch.set_num_threads(2)

G_RANGE = (0.2, 1.4)


def _rel_to_peak(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    return float(np.abs(got - want).max() / np.abs(want).max())


def _g_bins(gf, bins):
    lo, hi = G_RANGE
    return np.clip(((np.asarray(gf) - lo) / (hi - lo) * bins).astype(np.int32),
                   0, bins - 1)


class TestAgainstJax:
    @pytest.mark.parametrize("order", [0, 1])
    def test_disk_g_map(self, order):
        a, inc = 0.9, math.radians(45.0)
        want = jlp.disk_g_map(a, inc, 48, None, None, 50.0, order)
        got = tlp.disk_g_map(a, inc, 48, None, None, 50.0, order,
                             device="cpu")
        assert (got[2].numpy() == np.asarray(want[2])).all()
        assert int(got[2].sum()) > (400 if order == 0 else 4)
        for t, w in zip(got[:2], want[:2]):
            w = np.asarray(w)
            assert np.max(np.abs(t.numpy() - w) / np.abs(w)) <= 1e-12
        assert got[3] == float(want[3])
        assert (_g_bins(got[1], 200) == _g_bins(want[1], 200)).all()
        assert (tlp._g_index(got[1], *G_RANGE, 200).numpy()
                == _g_bins(want[1], 200)).all()

    def test_line_profile(self):
        a, inc = 0.9, math.radians(45.0)
        gj, pj = jlp.line_profile(a, inc, npix=48, r_out=50.0, orders=2)
        gt, pt = tlp.line_profile(a, inc, npix=48, r_out=50.0, orders=2,
                                  device="cpu")
        assert gt.shape == (200,) and pt.shape == (200,)
        assert np.max(np.abs(gt.numpy() - np.asarray(gj))) <= 1e-15
        assert ((pt.numpy() != 0) == (np.asarray(pj) != 0)).all()
        assert _rel_to_peak(pt, pj) <= 1e-12

    def test_transfer_function(self):
        a, inc = 0.5, math.radians(60.0)
        r_edges = np.geomspace(3.0, 50.0, 9)
        Tj = np.asarray(jlp.transfer_function(a, inc, r_edges, npix=48))
        Tt = tlp.transfer_function(a, inc, r_edges, npix=48, device="cpu")
        assert Tt.shape == (8, 64)
        assert ((Tt.numpy() != 0) == (Tj != 0)).all()
        assert _rel_to_peak(Tt, Tj) <= 1e-12
        # the table's r-bins: left-sided searchsorted, then the clip
        r, gf, hit, dA = tlp.disk_g_map(a, inc, 48, None, 3.0, 50.0,
                                        device="cpu")
        ridx = torch.clamp(torch.searchsorted(torch.from_numpy(r_edges), r)
                           - 1, 0, 7).numpy()
        want = np.clip(np.searchsorted(r_edges, r.numpy(), side="left") - 1,
                       0, 7)
        assert (ridx == want).all()
        # total solid angle equals the hit pixels times the pixel area
        assert np.isclose(float(Tt.sum()), float(hit.sum()) * dA, rtol=1e-10)


class TestLineProfile:
    """tests/test_driver.py::TestLineProfile, on the port."""

    def test_broad_line_shape(self):
        g, prof = tlp.line_profile(0.9, math.radians(45.0), npix=128,
                                   r_in=None, r_out=50.0, device="cpu")
        g, prof = g.numpy(), prof.numpy()
        assert np.isfinite(prof).all() and prof.max() > 0
        nz = prof > 0
        # relativistically broadened: flux both redward and blueward of g=1
        assert g[nz].min() < 0.7 and g[nz].max() > 1.05
        # classic double-horned annulus profile, Doppler-boosted blue horn
        g2, prof2 = tlp.line_profile(0.9, math.radians(45.0), npix=128,
                                     r_in=10.0, r_out=14.0, device="cpu")
        g2, prof2 = g2.numpy(), prof2.numpy()
        nz2 = prof2 > 0.01 * prof2.max()
        blue = prof2[g2 > 1.0].max()
        red = prof2[(g2 < 1.0) & nz2].max() if ((g2 < 1.0) & nz2).any() else 0.0
        assert blue > red

    def test_transfer_function_consistency(self):
        r_edges = np.geomspace(3.0, 50.0, 9)
        T = tlp.transfer_function(0.5, math.radians(60.0), r_edges, npix=128,
                                  device="cpu")
        assert T.shape == (8, 64)
        assert bool((T >= 0).all()) and float(T.sum()) > 0
        r, gf, hit, dA = tlp.disk_g_map(0.5, math.radians(60.0), 128, None,
                                        3.0, 50.0, device="cpu")
        assert np.isclose(float(T.sum()), float(hit.sum()) * dA, rtol=1e-10)
