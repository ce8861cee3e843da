"""The port's Walker-Penrose transport (`sim5_tpu_torch.polarization`)
against the C-reference goldens (tests/golden/polarization.txt) and
against `sim5_tpu.polarization` on numpy-seeded inputs.

Tolerances, and why:
* the goldens wp, pvec and prot: test_polarization.py's (wp rtol 1e-10
  atol 1e-12; pvec rtol 1e-8 atol 1e-9; prot rtol 1e-12 for the constant
  at infinity, rtol 1e-10 atol 1e-12 for the angle);
* against JAX: relative 1e-12 (atol 1e-13) -- the same f64 algebra;
* angles modulo their period: chi from polarization_angle_rotation jumps
  by 2 pi at +-pi, so cos 2chi and sin 2chi are compared; stokes_polang's
  mod pi jumps by pi near 0 and pi, so the distance modulo pi is.
"""

import math

import numpy as np
import torch

from sim5_tpu import polarization as jpol
from sim5_tpu.core import kerr_metric as jkerr
from sim5_tpu_torch import polarization as tpol
from sim5_tpu_torch.core import kerr_metric, dotprod, photon_momentum

torch.set_num_threads(2)

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
        f"max abs diff {np.max(np.abs(got[f] - want[f])):.3e}")


class TestGolden:
    """The port against the C reference."""

    def test_wp_constant(self, golden_polarization):
        d = golden_polarization["wp"]
        g = kerr_metric(*_t(d[:, 0], d[:, 1], d[:, 2]))
        wp1, wp2 = tpol.polarization_constant(*_t(d[:, 3:7], d[:, 7:11]), g)
        _close(wp1, d[:, 11], rtol=1e-10, atol=1e-12)
        _close(wp2, d[:, 12], rtol=1e-10, atol=1e-12)

    def test_vector_reconstruction(self, golden_polarization):
        d = golden_polarization["wp"]
        g = kerr_metric(*_t(d[:, 0], d[:, 1], d[:, 2]))
        k = _t(d[:, 3:7])
        f = tpol.polarization_vector(k, *_t(d[:, 11], d[:, 12]), g)
        _close(f, golden_polarization["pvec"], rtol=1e-8, atol=1e-9)
        # f.f = 1, f.k = 0, f[0] = 0
        _close(dotprod(f, f, g), np.ones(len(d)), rtol=1e-10)
        assert float(dotprod(f, k, g).abs().max()) < 1e-9
        assert float(f[:, 0].abs().max()) == 0.0

    def test_angle_rotation(self, golden_polarization):
        d = golden_polarization["prot"]
        a, inc, al, be = _t(d[:, 0], d[:, 1], d[:, 2], d[:, 3])
        wp1, wp2 = tpol.polarization_constant_infinity(a, al, be, inc)
        _close(wp1, d[:, 4], rtol=1e-12)
        _close(wp2, d[:, 5], rtol=1e-12)
        chi = tpol.polarization_angle_rotation(a, inc, al, be, wp1, wp2)
        _close(chi, d[:, 6], rtol=1e-10, atol=1e-12)


def _local(seed):
    """Kerr points with outgoing photon momenta of random (l, q) and
    vectors f with f.k = 0: f = e - (e.k)/(n.k) n for a random e and
    n = (1, 0, 0, 0)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.99, 4 * N)
    r = rng.uniform(4.0, 30.0, 4 * N)
    m = rng.uniform(-0.8, 0.8, 4 * N)
    l = rng.uniform(-4.0, 4.0, 4 * N)
    q = rng.uniform(0.0, 20.0, 4 * N)
    k = photon_momentum(*_t(a, r, m, l, q), 1.0, 1.0)
    ok = torch.isfinite(k).all(-1).numpy()
    a, r, m, k = a[ok][:N], r[ok][:N], m[ok][:N], k[torch.from_numpy(ok)][:N]
    g = kerr_metric(*_t(a, r, m))
    e = torch.from_numpy(rng.normal(size=(N, 4)))
    n = torch.zeros(N, 4, dtype=torch.float64)
    n[:, 0] = 1.0
    f = e - (dotprod(e, k, g) / dotprod(n, k, g))[:, None] * n
    return a, r, m, k.numpy(), f.numpy()


class TestAgainstJax:
    def test_constant_and_vector(self):
        a, r, m, k, f = _local(1)
        gj, gt = jkerr(a, r, m), kerr_metric(*_t(a, r, m))
        wj = jpol.polarization_constant(k, f, gj)
        wt = tpol.polarization_constant(*_t(k, f), gt)
        for got, want in zip(wt, wj):
            _close(got, want)
        _close(tpol.polarization_vector(_t(k), *wt, gt),
               jpol.polarization_vector(k, *wj, gj))

    def test_at_infinity(self):
        rng = np.random.default_rng(2)
        a = rng.uniform(0.0, 0.99, N)
        inc = rng.uniform(0.1, 1.5, N)
        al, be = rng.uniform(-10, 10, (2, N))
        wj = jpol.polarization_constant_infinity(a, al, be, inc)
        wt = tpol.polarization_constant_infinity(*_t(a, al, be, inc))
        for got, want in zip(wt, wj):
            _close(got, want)
        K1, K2 = rng.normal(size=(2, N))
        cj = np.asarray(jpol.polarization_angle_rotation(a, inc, al, be,
                                                         K1, K2))
        ct = tpol.polarization_angle_rotation(*_t(a, inc, al, be, K1, K2))
        _close(torch.cos(2 * ct), np.cos(2 * cj))
        _close(torch.sin(2 * ct), np.sin(2 * cj))
        assert float(ct.abs().max()) <= math.pi

    def test_stokes(self):
        rng = np.random.default_rng(3)
        i = rng.uniform(0.0, 2.0, N)
        i[:5] = (0.0, -1.0, 0.0, 0.0, -0.5)     # i <= 0: degree and angle 0
        q, u = rng.normal(size=(2, N))
        q[5:8], u[5:8] = (1.0, -1.0, -1.0), (0.0, 0.0, -1e-300)  # near 0, pi
        _close(tpol.stokes_poldeg(*_t(i, q, u)), jpol.stokes_poldeg(i, q, u))
        pj = np.asarray(jpol.stokes_polang(i, q, u))
        pt = tpol.stokes_polang(*_t(i, q, u)).numpy()
        assert ((pt >= 0.0) & (pt < math.pi)).all()
        d = np.abs(pt - pj)
        assert np.minimum(d, math.pi - d).max() <= 1e-13
        assert (pt[:5] == 0.0).all()
