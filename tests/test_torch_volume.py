"""The port's volume radiative transfer (`sim5_tpu_torch.render.lightcurve`)
against `sim5_tpu.render.lightcurve` on the same inputs: the analytic seed,
the loop engine and the light curve.  The transfer variants of the march
kernel against the Pallas kernel are in test_torch_volume_kernel.py, the
physics limits of the transfer in test_torch_volume_physics.py.

Tolerances, and why:
* the seed (f64): `ok` identical on every pixel, the march state within
  relative 1e-10 where ok (the same IEEE f64 chain in another order);
* the loop engine (f64) against the JAX "xla" engine: I within 1e-9 of the
  peak (the same step sequence, so the same accumulation up to rounding);
* the light curve (f64, loop engine): relative 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

# test_march.py's volume configuration (TestVolumeScan._KW), at a = 0.7
SEED_KW = dict(incl=float(np.radians(55.0)), npix=16, rmax=16.0,
               r_start=25.0, max_steps=384, precision=0.03)
BLOB = GaussianSource(amp=1.0, center=8.0, inv_width=1.0, inv_height=1.0)


def _spot(r_spot):
    """test_march.py's `_make_j`: a spot at r_spot of width 1.5, as a plain
    torch callable and in jnp."""
    def tj(t, r, m, phi):
        return torch.exp(-0.5 * ((r - r_spot) ** 2 + (r * m) ** 2) / 1.5 ** 2)

    def jj(t, r, m, phi):
        return jnp.exp(-0.5 * ((r - r_spot) ** 2 + (r * m) ** 2) / 1.5 ** 2)
    return tj, jj


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class TestSeedAndLoop:
    """The f64 seed and the loop engine against the JAX package."""

    def test_seed_matches_jax(self):
        a = 0.7
        kw = {k: SEED_KW[k] for k in ("npix", "rmax", "r_start", "precision")}
        stj, okj = jlc._volume_seed(a, SEED_KW["incl"], 0.0,
                                    axisymmetric=True, **kw)
        st, ok = tlc._volume_seed(a, SEED_KW["incl"], 0.0, axisymmetric=True,
                                  device="cpu", **kw)
        okj = np.asarray(okj)
        np.testing.assert_array_equal(ok.numpy(), okj)
        assert 0.3 < okj.mean() <= 1.0
        for f in dataclasses.fields(stj):
            want = getattr(stj, f.name)
            if not hasattr(want, "shape"):
                assert getattr(st, f.name) == want
                continue
            got, want = _np(getattr(st, f.name)), np.asarray(want)
            assert got.shape == want.shape and got.dtype == want.dtype
            sel = okj.reshape(okj.shape + (1,) * (want.ndim - okj.ndim))
            sel = np.broadcast_to(sel, want.shape)
            np.testing.assert_allclose(got[sel], want[sel], rtol=1e-10,
                                       atol=1e-13)

    @pytest.mark.parametrize("thick", [False, True], ids=["thin", "thick"])
    def test_loop_engine_matches_xla(self, thick):
        tj, jj = _spot(8.0)
        kw = dict(SEED_KW, axisymmetric=True)
        ta = (lambda t, r, m, phi: 0.2 * tj(t, r, m, phi)) if thick else None
        ja = (lambda t, r, m, phi: 0.2 * jj(t, r, m, phi)) if thick else None
        Ij = np.asarray(jlc.volume_image(0.7, emissivity_fn=jj, engine="xla",
                                         absorption_fn=ja, **kw))
        It = tlc.volume_image(0.7, emissivity_fn=tj, engine="loop",
                              absorption_fn=ta, device="cpu", **kw)
        assert It.dtype == torch.float64 and It.shape == (16, 16)
        peak = Ij.max()
        assert peak > 0
        assert np.abs(It.numpy() - Ij).max() <= 1e-9 * peak

    def test_volume_lightcurve_matches_jax(self):
        """A flaring spot (test_march.py's flare) as a GaussianSource, seen
        at two observer times through the loop engine."""
        flare = GaussianSource(amp=1.0, center=8.0, inv_width=1 / 1.5,
                               inv_height=1 / 1.5, t_center=-30.0,
                               inv_duration=0.1)

        def jflare(t, r, m, phi):
            return (jnp.exp(-0.5 * ((r - 8.0) ** 2 + (r * m) ** 2) / 1.5 ** 2)
                    * jnp.exp(-0.5 * ((t + 30.0) / 10.0) ** 2))

        kw = dict(SEED_KW, npix=8, max_steps=200, axisymmetric=True)
        Fj = jlc.volume_lightcurve(0.7, emissivity_fn_t=jflare,
                                   t_obs=[0.0, 20.0], **kw)
        Ft = tlc.volume_lightcurve(0.7, emissivity_fn_t=flare,
                                   t_obs=[0.0, 20.0], device="cpu", **kw)
        assert Ft.shape == (2,) and (Fj > 0).all()
        np.testing.assert_allclose(Ft, Fj, rtol=1e-9)

    def test_axisymmetric_false_is_not_ported(self):
        """The default axisymmetric=False, which raised NotImplementedError
        when the seed had no azimuth stage (hence the name), now runs and
        gives a phi-independent source bitwise the image of
        axisymmetric=True: nothing in the march depends on phi."""
        kw = dict(SEED_KW, npix=8, max_steps=200)
        I = tlc.volume_image(0.7, emissivity_fn=BLOB, device="cpu", **kw)
        I0 = tlc.volume_image(0.7, emissivity_fn=BLOB, device="cpu",
                              axisymmetric=True, **kw)
        assert float(I0.max()) > 0.0
        assert torch.equal(I, I0)
