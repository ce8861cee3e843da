"""Physics of the port's volume radiative transfer, on the port alone (no
JAX call): the limits of test_pallas_march.py's test_volume_rt_absorption,
the `GaussianSource` family against the repository's emission models, and
the march kernel wrapper's contract for transfer models on the CPU.
"""

import numpy as np
import pytest
import torch

from sim5_tpu_torch.march import kernel_march
from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

# test_pallas_march.py's volume configuration, at a = 0.9, incl = 1.2
PALLAS_KW = dict(npix=16, rmax=12.0, r_start=20.0, max_steps=500,
                 precision=0.03)

# the models of test_pallas_march.py as GaussianSource
BLOB = GaussianSource(amp=1.0, center=8.0, inv_width=1.0, inv_height=1.0)
ALPHA_BLOB = GaussianSource(amp=0.15, center=8.0, inv_width=1.0 / 3.0)


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


class TestPhysics:

    def test_absorption_physics_limits(self):
        """test_volume_rt_absorption's limits on the port's f32 loop
        engine, and its kernel route against the loop engine."""
        kw = dict(PALLAS_KW, axisymmetric=True, dtype=torch.float32,
                  device="cpu")
        I_p = tlc.volume_image(0.9, 1.2, BLOB, engine="kernel",
                               absorption_fn=ALPHA_BLOB, **kw).numpy()
        # the loop engine's images share one seed
        st, ok = tlc._volume_seed(
            0.9, 1.2, 0.0, **{k: kw[k] for k in (
                "npix", "rmax", "r_start", "precision", "axisymmetric",
                "dtype", "device")})

        def image(absorption):
            return tlc._volume_march_loop(
                st, ok, kw["r_start"], BLOB, kw["max_steps"],
                absorption_fn=absorption).numpy()

        I_thin = image(None)
        I_x = image(ALPHA_BLOB)
        I_thick = image(GaussianSource(amp=50.0))
        I_zero = image(GaussianSource(amp=0.0))
        scale = I_thin.max()
        assert scale > 0
        assert (I_x <= I_thin + 1e-6 * scale).all()
        assert I_x.max() < 0.95 * scale
        assert I_thick.max() < 0.05 * scale
        # alpha = 0 takes the thin branch (tiny guard, not 0/0)
        np.testing.assert_allclose(I_zero, I_thin, rtol=1e-5,
                                   atol=1e-6 * scale)
        assert np.abs(I_p - I_x).max() / scale < 2e-2

    def test_gaussian_source_plain_form(self):
        """The family's plain torch form reproduces the repository's
        models: the blobs above and example 11's torus."""
        rng = np.random.default_rng(5)
        t, r = (torch.from_numpy(rng.uniform(lo, hi, 64))
                for lo, hi in ((-50.0, 0.0), (2.0, 20.0)))
        m = torch.from_numpy(rng.uniform(-1.0, 1.0, 64))
        phi = torch.zeros_like(r)
        torch.testing.assert_close(
            BLOB(t, r, m, phi), torch.exp(-0.5 * ((r - 8) ** 2 + (m * r) ** 2)))
        torch.testing.assert_close(
            ALPHA_BLOB(t, r, m, phi),
            0.15 * torch.exp(-0.5 * ((r - 8.0) / 3.0) ** 2))
        torus = GaussianSource(amp=1.0, center=8.0, inv_width=1 / 1.5,
                               inv_height=1 / 1.5, cylindrical=True)
        R = r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
        torch.testing.assert_close(
            torus(t, r, m, phi),
            torch.exp(-0.5 * (((R - 8.0) / 1.5) ** 2 + ((r * m) / 1.5) ** 2)))
        flare = GaussianSource(amp=1.0, center=8.0, inv_width=1 / 1.5,
                               inv_height=1 / 1.5, t_center=-30.0,
                               inv_duration=0.1)
        torch.testing.assert_close(
            flare(t, r, m, phi),
            torch.exp(-0.5 * ((r - 8.0) ** 2 + (r * m) ** 2) / 1.5 ** 2)
            * torch.exp(-0.5 * ((t + 30.0) / 10.0) ** 2))
        assert GaussianSource(amp=50.0)(t, r, m, phi).eq(50.0).all()

    def test_wrapper_refuses_callables_and_launches_nothing_on_cpu(self):
        st, ok = tlc._volume_seed(0.9, 1.2, 0.0, npix=4, rmax=12.0,
                                  r_start=20.0, precision=0.03,
                                  axisymmetric=True, dtype=torch.float32,
                                  device="cpu")
        before = dict(kernel_march.LAUNCHES)
        kw = dict(r_max=24.0, max_steps=20, active0=ok)
        with pytest.raises(TypeError, match="GaussianSource"):
            kernel_march.raytrace_kernel(st, emissivity=lambda *a: a[1], **kw)
        with pytest.raises(TypeError):
            kernel_march.raytrace_kernel(st, emissivity=BLOB,
                                         absorption=lambda *a: a[1], **kw)
        with pytest.raises(ValueError):
            kernel_march.raytrace_kernel(st, absorption=ALPHA_BLOB, **kw)
        s1, a1, I1 = kernel_march.raytrace_kernel(st, emissivity=BLOB, **kw)
        s2, a2, I2 = kernel_march.raytrace_reference(st, emissivity=BLOB,
                                                     **kw)
        assert kernel_march.LAUNCHES == before
        torch.testing.assert_close(I1, I2, rtol=0, atol=0)
        torch.testing.assert_close(s1.x, s2.x, rtol=0, atol=0)
        assert torch.equal(a1, a2)
        # the loop engine takes a plain callable; the kernel route refuses it
        with pytest.raises(TypeError):
            tlc.volume_image(0.9, 1.2, lambda t, r, m, phi: r,
                             engine="kernel", axisymmetric=True,
                             device="cpu", npix=4, max_steps=5)
