"""The port's polarized disk image and spectrum
(`sim5_tpu_torch.render.polarized`, examples 06 and 10), the driver's
local-frame helpers and spectral model (`render.driver`) and `ThinDisk`,
against `sim5_tpu` on the same inputs, and the physics gates of
tests/test_polarized_spectrum.py on the port, on the CPU.

Tolerances, and why:
* the helpers and ThinDisk: relative 1e-12 (atol 1e-13) -- the same f64
  algebra;
* the Stokes maps: I relative 1e-12 per pixel; Q and U within 1e-12 of I
  per pixel (Q = I pd cos 2chi: the angle, not the product, carries the
  roundings, and Q, U pass through 0);
* the spectra: I_E relative 1e-12; Q_E and U_E within 1e-12 of I_E (sums
  over the image with terms of both signs, in another order);
* the physics gates: tests/test_polarized_spectrum.py's own.
"""

import math

import numpy as np
import pytest
import torch

from sim5_tpu import disk as jdisk
from sim5_tpu import core as jcore
from sim5_tpu.render import driver as jdrv
from sim5_tpu.render import polarized as jpz
from sim5_tpu_torch.disk import ThinDisk, DiskModel, nt_setup
from sim5_tpu_torch.render import driver as tdrv
from sim5_tpu_torch.render import polarized as tpz

torch.set_num_threads(2)

# examples 06 and 10: a = 0.9, 70 deg, M = 10, mdot = 0.1, alpha = 0.1
A, INCL = 0.9, math.radians(70.0)
E8 = np.geomspace(0.3, 10.0, 8)
N = 64


def _t(*arrays):
    out = [torch.from_numpy(np.array(v, dtype=np.float64)) for v in arrays]
    return out[0] if len(out) == 1 else out


def _close(got, want, rtol=1e-12, atol=1e-13):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert (np.isfinite(got) == np.isfinite(want)).all()
    f = np.isfinite(want)
    assert np.allclose(got[f], want[f], rtol=rtol, atol=atol), (
        f"max abs diff {np.max(np.abs(got[f] - want[f])):.3e}, max rel "
        f"{np.max(np.abs(got[f] - want[f]) / (np.abs(want[f]) + 1e-300)):.3e}")


def _disks(a=A):
    return (jdisk.ThinDisk(jdisk.nt_setup(10.0, a, 0.1, 0.1)),
            ThinDisk(nt_setup(10.0, a, 0.1, 0.1, device="cpu")))


class TestDriverAgainstJax:
    def test_thin_disk(self):
        jd, td = _disks()
        assert isinstance(td, DiskModel)
        r = np.geomspace(1.5, 400.0, N)    # inside the ISCO too
        tr = _t(r)
        for name in ("flux", "t_eff", "sigma", "ell", "vr", "h", "dhdr"):
            _close(getattr(td, name)(tr), getattr(jd, name)(r))
        for name in ("r_min", "mdot", "lumi"):
            _close(getattr(td, name)().reshape(()), getattr(jd, name)())
        c = ThinDisk.create(10.0, A, 0.1, device="cpu")
        assert torch.equal(c.params.rms, td.params.rms)

    def test_frame_helpers(self):
        jd, td = _disks()
        rng = np.random.default_rng(1)
        r = rng.uniform(1.0, 30.0, N)          # some inside the ISCO
        m = np.where(np.arange(N) % 4 == 0, 0.0, rng.uniform(-0.3, 0.3, N))
        l = rng.uniform(-4.0, 4.0, N)
        q = rng.uniform(0.0, 20.0, N)
        tj = jdrv.disk_tetrad(A, r, m, jd)
        tt = tdrv.disk_tetrad(A, *_t(r, m), td)
        _close(tt.e, tj.e)
        k = np.nan_to_num(np.asarray(jcore.photon_momentum(A, r, m, l, q,
                                                           1.0, 1.0)))
        _close(tdrv.observed_gfactor(_t(k), tt),
               jdrv.observed_gfactor(k, tj))
        _close(tdrv.emission_angle(_t(k), tt), jdrv.emission_angle(k, tj))
        R = r * np.sqrt(1.0 - m * m)
        _close(tdrv.vertical_gravity(_t(R), tt, 10.0, A),
               jdrv.vertical_gravity(R, tj, 10.0, A))

    def test_hardening_and_spectrum(self):
        rng = np.random.default_rng(2)
        T = 10.0 ** rng.uniform(1.5, 6.5, N)    # the three branches, T < 100
        for mdot in (0.05, 0.3):
            _close(tdrv.spectral_hardening(_t(T), mdot),
                   jdrv.spectral_hardening(T, mdot))
        mu = rng.uniform(0.0, 1.0, N)
        f = rng.uniform(1.4, 2.0, N)
        E = np.geomspace(0.1, 10.0, 6)
        got = tdrv.DiskSpectrum_BlackBody().spectrum(*_t(T, mu, f, E))
        want = jdrv.DiskSpectrum_BlackBody().spectrum(T, mu, f, E)
        _close(got, want)
        assert bool((got[torch.from_numpy(T < 100.0)] == 0).all())


class TestRenderersAgainstJax:
    @pytest.fixture(scope="class")
    def disks(self):
        return (jdisk.nt_setup(10.0, A, 0.1, 0.1),
                nt_setup(10.0, A, 0.1, 0.1, device="cpu"))

    def test_polarized_image(self, disks):
        jd, td = disks
        Ij, Qj, Uj = (np.asarray(v) for v in
                      jpz.render_polarized_image(jd, INCL, 32, 32))
        It, Qt, Ut = (v.numpy() for v in
                      tpz.render_polarized_image(td, INCL, 32, 32))
        assert It.shape == (32, 32) and ((It > 0) == (Ij > 0)).all()
        assert (Ij > 0).sum() > 300
        on = Ij > 0
        assert np.max(np.abs(It - Ij)[on] / Ij[on]) <= 1e-12
        for t, w in ((Qt, Qj), (Ut, Uj)):
            assert (t[~on] == 0).all()
            assert np.max(np.abs(t - w)[on] / Ij[on]) <= 1e-12

    def test_polarized_spectrum(self, disks):
        jd, td = disks
        Ij, Qj, Uj = (np.asarray(v) for v in
                      jpz.polarized_spectrum(jd, INCL, E8, npix=32))
        It, Qt, Ut = (v.numpy() for v in
                      tpz.polarized_spectrum(td, INCL, E8, npix=32))
        assert It.shape == (8,) and (Ij > 0).all()
        assert np.max(np.abs(It - Ij) / Ij) <= 1e-12
        for t, w in ((Qt, Qj), (Ut, Uj)):
            assert np.max(np.abs(t - w) / Ij) <= 1e-12
        # energies as a tensor give the same spectrum
        It2 = tpz.polarized_spectrum(td, INCL, torch.from_numpy(E8),
                                     npix=32)[0].numpy()
        assert (It2 == It).all()


E12 = np.geomspace(0.3, 8.0, 12)


def _degree(I, Q, U):
    ok = I > 1e-12 * I.max()
    return np.where(ok, np.hypot(Q, U) / np.where(ok, I, 1.0), 0.0)


class TestPolarizedSpectrum:
    """tests/test_polarized_spectrum.py's physics gates, on the port."""

    @pytest.fixture(scope="class")
    def disk(self):
        return nt_setup(10.0, 0.5, 0.1, 0.1, device="cpu")

    def _spectrum(self, disk, inc_deg):
        return (v.numpy() for v in tpz.polarized_spectrum(
            disk, math.radians(inc_deg), E12, npix=96))

    def test_faceon_degree_vanishes(self, disk):
        I, Q, U = self._spectrum(disk, 3.0)
        assert I.max() > 0 and np.isfinite(I).all()
        assert _degree(I, Q, U).max() < 5e-3

    def test_inclined_degree_bounded_and_nonzero(self, disk):
        I, Q, U = self._spectrum(disk, 75.0)
        deg = _degree(I, Q, U)
        sel = I > 1e-6 * I.max()
        assert deg[sel].max() > 5e-3
        assert deg[sel].max() < float(tpz.chandrasekhar_poldeg(
            math.cos(math.radians(75.0))))

    def test_degree_grows_with_inclination(self, disk):
        def deg(inc_deg):
            I, Q, U = self._spectrum(disk, inc_deg)
            sel = I > 1e-3 * I.max()
            return np.median(_degree(I, Q, U)[sel])

        d30, d75 = deg(30.0), deg(75.0)
        assert d75 > 2.0 * d30 > 0.0, (d30, d75)
