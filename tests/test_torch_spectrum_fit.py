"""The port's differentiable disk spectrum
(`sim5_tpu_torch.render.spectrum_fit`: `make_polar_grid`, `disk_spectrum`)
against `sim5_tpu` on the same grid, against the port's own driver, and
its autograd gradient against jax.grad and central differences, on the
CPU in f64.

Tolerances, and why:
* the grid: identical (the same host arithmetic in numpy);
* the spectrum against JAX: relative 1e-10 where it is above 1e-6 of its
  peak (the same f64 algebra);
* against the driver's spectrum on the same quadrature: rtol 2e-2 above
  1e-3 of the peak (test_driver.py: the driver's disk state is f32
  quantized, the fit's is not);
* d log(sum spectrum)/da: relative 1e-8 against jax.grad (the same
  function; autograd through the special functions' iterations against
  the JAX package's closed-form JVP rules), and rtol 0.05 against
  central differences at eps 1e-3 (test_driver.py: the spectrum jumps
  where grid lanes cross the ISCO mask, so finer eps amplifies them).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from sim5_tpu.render import (make_polar_grid as jmake_polar_grid,
                             disk_spectrum as jdisk_spectrum)
from sim5_tpu_torch.disk import ThinDisk
from sim5_tpu_torch.render import (DiskRaytrace, DiskSpectrum_BlackBody,
                                   PolarGrid, make_polar_grid, disk_spectrum)

torch.set_num_threads(2)

INCL = np.radians(60.0)
E = np.geomspace(0.3, 15.0, 16)


def _grids():
    return (jmake_polar_grid(0.7, INCL, radres=2.0, angres=10.0),
            make_polar_grid(0.7, INCL, radres=2.0, angres=10.0,
                            device="cpu"))


class TestSpectrumFit:
    def test_grid_identical(self):
        jg, tg = _grids()
        assert isinstance(tg, PolarGrid)
        for j, t in zip(jg, tg):
            assert t.dtype == torch.float64 and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), np.asarray(j))

    def test_spectrum_against_jax_and_driver(self):
        jg, tg = _grids()
        want = np.asarray(jdisk_spectrum(jg, E, 10.0, 0.7, 0.1, INCL,
                                         hardening=1.7))
        got = disk_spectrum(tg, E, 10.0, 0.7, 0.1, INCL, hardening=1.7)
        assert got.shape == (16,) and got.dtype == torch.float64
        got = got.numpy()
        nz = want > 1e-6 * want.max()
        np.testing.assert_allclose(got[nz], want[nz], rtol=1e-10)
        # the spectral-hardening fit and no limb darkening
        want = np.asarray(jdisk_spectrum(jg, E, 10.0, 0.7, 0.1, INCL,
                                         limbdk=False))
        got2 = disk_spectrum(tg, E, 10.0, 0.7, 0.1, INCL,
                             limbdk=False).numpy()
        nz2 = want > 1e-6 * want.max()
        np.testing.assert_allclose(got2[nz2], want[nz2], rtol=1e-10)
        # the driver's spectrum on the same quadrature
        disk = ThinDisk.create(10.0, 0.7, 0.1, 0.1, device="cpu")
        rt = DiskRaytrace(10.0, 0.7, 10.0, disk, DiskSpectrum_BlackBody(),
                          device="cpu")
        ref, _ = rt.spectrum(60.0, E, flat=1, radres=2.0, angres=10.0,
                             hardening=1.7)
        ref = ref.numpy()
        nz = ref > 1e-3 * ref.max()
        np.testing.assert_allclose(got[nz], ref[nz], rtol=2e-2)

    def test_gradient(self):
        jg, tg = _grids()

        def total(a):
            return torch.log(disk_spectrum(tg, E, 10.0, a, 0.1, INCL,
                                           hardening=1.7).sum())

        def total_jax(a):
            return jnp.log(jnp.sum(jdisk_spectrum(jg, E, 10.0, a, 0.1, INCL,
                                                  hardening=1.7)))

        a = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        ga, = torch.autograd.grad(total(a), a)
        ga = float(ga)
        assert np.isfinite(ga)
        gj = float(jax.jit(jax.grad(total_jax))(0.7))
        assert abs(ga - gj) / abs(gj) < 1e-8, (ga, gj)
        eps = 1e-3

        def f(x):
            return float(total(torch.tensor(x, dtype=torch.float64)))

        fd = (f(0.7 + eps) - f(0.7 - eps)) / (2 * eps)
        assert np.isclose(ga, fd, rtol=0.05), (ga, fd)
