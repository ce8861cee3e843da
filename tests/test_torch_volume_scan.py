"""The port's reverse-differentiable march, `volume_image(engine="scan")`
(`render.lightcurve._volume_march_scan`), against its loop engine, against
the JAX package's scan engine, and its gradients against central
differences and `jax.grad`, with `tests/test_march.py:177-179`'s
configuration (TestDifferentiableMarch._KW) and sources.

Tolerances, and why:
* scan against loop (f64): rtol 1e-12 (the same masked step and weights;
  the loop stops once no ray is active, the scan pays every step on rays
  that are no longer active, which add nothing);
* scan against the JAX scan engine: 1e-9 of the peak (the same step
  sequence, so the same accumulation up to rounding, as the loop engine's
  gate in test_torch_volume.py);
* d I.sum() / d(a, r_spot) against FD (h = 1e-5): rel < 1e-5, as
  test_march.py:194-216; against `jax.grad`: rel < 1e-8 (the same
  derivative of the same step sequence; the seed's special functions
  carry the same rules).

The light curve's gradient is in test_torch_volume_scan_lightcurve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

KW = dict(incl=float(np.radians(55.0)), npix=16, rmax=16.0, r_start=25.0,
          max_steps=384, precision=0.03, axisymmetric=True)


def _t(v):
    return torch.tensor(float(v), dtype=torch.float64)


def _spot_t(r_spot):
    def j(t, r, m, phi):
        return torch.exp(-0.5 * ((r - r_spot) ** 2 + (r * m) ** 2) / 1.5 ** 2)
    return j


def _spot_j(r_spot):
    def j(t, r, m, phi):
        return jnp.exp(-0.5 * ((r - r_spot) ** 2 + (r * m) ** 2) / 1.5 ** 2)
    return j


def _image(a, r_spot, engine="scan", **kw):
    return tlc.volume_image(a, emissivity_fn=_spot_t(r_spot), engine=engine,
                            device="cpu", **{**KW, **kw})


def _fd(f, p, i, h):
    ap, am = list(p), list(p)
    ap[i] = ap[i] + h
    am[i] = am[i] - h
    with torch.no_grad():
        return (float(f(*map(_t, ap))) - float(f(*map(_t, am)))) / (2 * h)


def _grads(f, p):
    args = [_t(v).requires_grad_(True) for v in p]
    return [float(g) for g in torch.autograd.grad(f(*args), args)]


class TestScanEngine:

    def test_scan_matches_loop_and_jax(self):
        with torch.no_grad():
            Is = _image(_t(0.7), 8.0)
            Il = _image(_t(0.7), 8.0, engine="loop")
        assert float(Il.max()) > 0
        np.testing.assert_allclose(Is.numpy(), Il.numpy(), rtol=1e-12,
                                   atol=0)
        Ij = np.asarray(jlc.volume_image(jnp.float64(0.7),
                                         emissivity_fn=_spot_j(8.0),
                                         engine="scan", **KW))
        assert np.abs(Is.numpy() - Ij).max() <= 1e-9 * Ij.max()

    def test_thick_scan_matches_loop(self):
        src = GaussianSource(amp=1.0, center=8.0, inv_width=1.0 / 1.5,
                             inv_height=1.0 / 1.5, cylindrical=True)
        with torch.no_grad():
            Is = tlc.volume_image(_t(0.7), emissivity_fn=src,
                                  absorption_fn=src, engine="scan",
                                  device="cpu", **KW)
            Il = tlc.volume_image(_t(0.7), emissivity_fn=src,
                                  absorption_fn=src, engine="loop",
                                  device="cpu", **KW)
        assert float(Il.max()) > 0
        np.testing.assert_allclose(Is.numpy(), Il.numpy(), rtol=1e-12,
                                   atol=0)

    def test_volume_image_grad_vs_fd_and_jax(self):
        """d(volume image).sum() / d(spin, source radius) through seed +
        march + transfer."""
        p = (0.7, 8.0)

        def total(a, r_spot):
            return _image(a, r_spot).sum()

        g = _grads(total, p)
        jg = jax.grad(lambda a, rs: jnp.sum(jlc.volume_image(
            a, emissivity_fn=_spot_j(rs), engine="scan", **KW)),
            argnums=(0, 1))(jnp.float64(p[0]), jnp.float64(p[1]))
        for i, gv in enumerate(g):
            fd = _fd(total, p, i, 1e-5)
            assert abs(gv - fd) / max(abs(fd), 1e-12) < 1e-5, (i, gv, fd)
            assert abs(gv - float(jg[i])) <= 1e-8 * abs(float(jg[i])), (
                i, gv, float(jg[i]))


class TestKernelEngineForwardOnly:

    @pytest.mark.parametrize("what", ["spin", "source"])
    def test_kernel_engine_refuses_grad(self, what):
        a = _t(0.7).requires_grad_(what == "spin")
        center = _t(8.0).requires_grad_(what == "source")
        src = GaussianSource(amp=1.0, center=center, inv_width=1.0,
                             inv_height=1.0)
        with pytest.raises(ValueError, match="forward only"):
            tlc.volume_image(a, emissivity_fn=src, engine="kernel",
                             device="cpu", **KW)

    def test_unknown_engine(self):
        with pytest.raises(ValueError, match="'scan'"):
            tlc.volume_image(_t(0.7), emissivity_fn=_spot_t(8.0),
                             engine="xla", device="cpu", **KW)
