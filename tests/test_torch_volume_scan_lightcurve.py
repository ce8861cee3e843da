"""The gradient of a light curve through the port's reverse-differentiable
march, `volume_image(engine="scan")`: a flaring source seen at two
observer times (`tests/test_march.py:218-256`, its configuration and
source), d(sum of the two images) / d(a, r_spot, t_flare) against central
differences (h = 1e-4): rel < 1e-4, as there; and against `jax.grad` of
the same sum through the JAX package's scan engine: rel < 1e-8 (the same
derivative of the same step sequence, as test_torch_volume_scan.py holds
the image's gradient).  The flare time's gradient runs through the
march's time bookkeeping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

# test_march.py:177-179's configuration
KW = dict(incl=float(np.radians(55.0)), npix=16, rmax=16.0, r_start=25.0,
          max_steps=384, precision=0.03, axisymmetric=True)
T_OBS = (-20.0, -8.0)
P = (0.7, 8.0, -30.0)


def _t(v):
    return torch.tensor(float(v), dtype=torch.float64)


def _flare(r_spot, t_flare):
    def j(t, r, m, phi):
        return (torch.exp(-0.5 * ((r - r_spot) ** 2 + (r * m) ** 2) / 1.5 ** 2)
                * torch.exp(-0.5 * ((t - t_flare) / 10.0) ** 2))
    return j


def _flare_j(r_spot, t_flare):
    def j(t, r, m, phi):
        return (jnp.exp(-0.5 * ((r - r_spot) ** 2 + (r * m) ** 2) / 1.5 ** 2)
                * jnp.exp(-0.5 * ((t - t_flare) / 10.0) ** 2))
    return j


def _lc_sum(a, r_spot, t_flare):
    return sum(tlc.volume_image(a, emissivity_fn=_flare(r_spot, t_flare),
                                engine="scan", t0=t0, device="cpu",
                                **KW).sum() for t0 in T_OBS)


def _lc_sum_jax(a, r_spot, t_flare):
    tot = 0.0
    for t0 in T_OBS:
        tot = tot + jnp.sum(jlc.volume_image(
            a, emissivity_fn=_flare_j(r_spot, t_flare), engine="scan", t0=t0,
            **KW))
    return tot


@pytest.fixture(scope="module")
def port_grad():
    """The port's d(sum of the two images) / d(a, r_spot, t_flare) at P."""
    args = [_t(v).requires_grad_(True) for v in P]
    return [float(g) for g in torch.autograd.grad(_lc_sum(*args), args)]


class TestScanLightcurve:

    def test_volume_lightcurve_grad_vs_fd(self, port_grad):
        p = P
        h = 1e-4
        for i, gv in enumerate(port_grad):
            ap, am = list(p), list(p)
            ap[i] += h
            am[i] -= h
            with torch.no_grad():
                fd = (float(_lc_sum(*map(_t, ap)))
                      - float(_lc_sum(*map(_t, am)))) / (2 * h)
            assert abs(gv - fd) / max(abs(fd), 1e-9) < 1e-4, (i, gv, fd)

    def test_volume_lightcurve_grad_vs_jax(self, port_grad):
        jg = jax.grad(_lc_sum_jax, argnums=(0, 1, 2))(
            *(jnp.float64(v) for v in P))
        for i, gv in enumerate(port_grad):
            want = float(jg[i])
            assert abs(gv - want) <= 1e-8 * abs(want), (i, gv, want)
