"""The port's external compiled disk bridge (`sim5_tpu_torch.disk.
ExternalDisk`) against `sim5_tpu.disk.external.ExternalDisk` of the same
shared library (tests/data/external_diskmodel.c, compiled with cc as
tests/test_external_disk.py does), on the CPU.

Tolerances:
* the port's tables and every DiskModel method against the JAX package's:
  1e-14 relative (the same host samples and f64 interpolation);
* against the model written directly in torch (`PyTwin`): rtol 5e-6
  (flux, sigma) and 1e-5 (ell), tests/test_external_disk.py's
  interpolation gates;
* a 48^2 `DiskRaytrace.image` through the bridge: the hit footprint of the
  twin's image and of the JAX package's bridge image, flux within 1e-5
  relative of each;
* f32 queries: the port evaluates in the table's f64 and rounds once, so
  its f32 value is the f64 value rounded to f32, bit for bit; the JAX
  package under enable_x64(False) interpolates in f32, up to ~5.3e-6
  relative off (log-flux ~ 60 carries 60 f32 roundings' worth through
  the exp): the two within 1e-5 relative, the port no further from the
  f64 value than JAX's.
"""

import pathlib
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from sim5_tpu.disk.external import ExternalDisk as JExternalDisk
from sim5_tpu.render import DiskRaytrace as JDiskRaytrace
from sim5_tpu.render import DiskSpectrum_BlackBody as JBlackBody
from sim5_tpu_torch import consts
from sim5_tpu_torch.disk import DiskModel, ExternalDisk
from sim5_tpu_torch.render import DiskRaytrace, DiskSpectrum_BlackBody

torch.set_num_threads(2)

SRC = pathlib.Path(__file__).parent / "data" / "external_diskmodel.c"
METHODS = ("flux", "t_eff", "sigma", "ell", "vr", "h", "dhdr")


@pytest.fixture(scope="module")
def model_so(tmp_path_factory):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler available")
    so = tmp_path_factory.mktemp("extdisk") / "external_diskmodel.so"
    subprocess.run([cc, "-shared", "-fPIC", "-O2", "-o", str(so), str(SRC),
                    "-lm"], check=True)
    return str(so)


class PyTwin:
    """The same analytic model written directly in torch (f64 CPU)."""

    def __init__(self, a):
        self.rin = 6.0 * (1.0 - 0.5 * a)

    def _r(self, r):
        return torch.as_tensor(r, dtype=torch.float64)

    def r_min(self):
        return torch.tensor(self.rin, dtype=torch.float64)

    def mdot(self):
        return torch.tensor(0.1, dtype=torch.float64)

    def lumi(self):
        return torch.tensor(0.05, dtype=torch.float64)

    def flux(self, r):
        r = self._r(r)
        rs = torch.clamp(r, min=self.rin * (1 + 1e-12))
        return torch.where(r > self.rin,
                           1.0e26 * rs ** -3.0 * (1.0 - torch.sqrt(
                               self.rin / rs)), 0.0)

    def t_eff(self, r):
        return (torch.clamp(self.flux(r), min=0.0) / consts.sb_sigma) ** 0.25

    def sigma(self, r):
        return 1.0e5 * self._r(r) ** -0.6

    def ell(self, r):
        r = self._r(r)
        return torch.sqrt(r) / (1.0 + 1.0 / r)

    def vr(self, r):
        return torch.zeros_like(self._r(r))

    def h(self, r):
        return torch.zeros_like(self._r(r))

    def dhdr(self, r):
        return torch.zeros_like(self._r(r))


def _radii():
    """Off-grid radii from the inner edge out, and some inside it."""
    rin = PyTwin(0.7).rin
    return np.concatenate([np.geomspace(rin * 1.01, 1e5, 333) * 1.000313,
                           np.linspace(1.0, rin, 7)])


class TestTables:
    def test_against_jax(self, model_so):
        disk = ExternalDisk.create(model_so, 10.0, 0.7, "k=v", device="cpu")
        jdisk = JExternalDisk.create(model_so, 10.0, 0.7, "k=v")
        assert isinstance(disk, DiskModel)
        assert (disk.flux_logy, disk.sigma_logy) == (jdisk.flux_logy,
                                                     jdisk.sigma_logy)
        for k in ("rmin_", "mdot_", "lumi_", "shift_"):
            assert float(getattr(disk, k)) == float(getattr(jdisk, k))
        for k in ("t_flux", "t_sigma", "t_ell", "t_vr", "t_h", "t_dhdr"):
            tab, jtab = getattr(disk, k), getattr(jdisk, k)
            assert (tab.itype, tab.options) == (jtab.itype, jtab.options)
            for f in ("x", "y", "y2"):
                np.testing.assert_array_equal(getattr(tab, f).numpy(),
                                              np.asarray(getattr(jtab, f)))
        r = _radii()
        for name in METHODS:
            got = getattr(disk, name)(torch.tensor(r))
            want = np.asarray(getattr(jdisk, name)(r))
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-14,
                                       atol=0.0)
        # a Python number is an f64 query
        assert disk.flux(20.0).dtype == torch.float64
        np.testing.assert_allclose(float(disk.flux(20.0)),
                                   float(jdisk.flux(20.0)), rtol=1e-14)

    def test_against_python_twin(self, model_so):
        disk = ExternalDisk.create(model_so, 10.0, 0.7, "k=v", device="cpu")
        twin = PyTwin(0.7)
        assert float(disk.r_min()) == pytest.approx(twin.rin)
        assert float(disk.mdot()) == pytest.approx(0.1)
        assert float(disk.lumi()) == pytest.approx(0.05)
        r = torch.tensor(np.geomspace(twin.rin * 1.01, 1e5, 333) * 1.000313)
        for name, rtol in (("flux", 5e-6), ("sigma", 5e-6), ("ell", 1e-5)):
            np.testing.assert_allclose(getattr(disk, name)(r).numpy(),
                                       getattr(twin, name)(r).numpy(),
                                       rtol=rtol)
        assert bool((disk.h(r) == 0.0).all())
        inside = torch.linspace(1.0, twin.rin * 0.999, 5, dtype=torch.float64)
        assert bool((disk.flux(inside) == 0.0).all())

    def test_f32_queries(self, model_so):
        disk = ExternalDisk.create(model_so, 10.0, 0.7, device="cpu")
        jdisk = JExternalDisk.create(model_so, 10.0, 0.7)
        # at r == r_min exactly, u = r - r_min cancels to 0 and reads the
        # table's first sample: JAX's f32 value there is 0.59 relative off
        # its f64 one (the edge's conditioning, not interpolation)
        r32 = _radii().astype(np.float32)
        r32 = r32[r32 != np.float32(PyTwin(0.7).rin)]
        for name in METHODS:
            got = getattr(disk, name)(torch.tensor(r32))
            assert got.dtype == torch.float32
            f64 = getattr(disk, name)(torch.tensor(r32, dtype=torch.float64))
            assert torch.equal(got, f64.to(torch.float32)), name
            with jax.enable_x64(False):
                want = np.asarray(getattr(jdisk, name)(r32))
            assert want.dtype == np.float32
            f64 = f64.numpy()
            scale = np.maximum(np.abs(f64), 1e-300)
            jerr = np.abs(want - f64) / scale
            err = np.abs(got.numpy() - f64) / scale
            assert jerr.max() < 1e-5, name
            assert (err <= jerr + 2.0 ** -24).all(), name
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=0.0)


class TestImage:
    def test_image_through_bridge(self, model_so):
        """The 48^2 image through the bridge, the twin and the JAX
        package's bridge: the same hit footprint, flux within 1e-5."""
        disk = ExternalDisk.create(model_so, 10.0, 0.7, device="cpu")
        args = (60.0, 20.0, 48)
        im = DiskRaytrace(10.0, 0.7, 10.0, disk, DiskSpectrum_BlackBody(),
                          device="cpu").image(*args)["flux"].numpy()
        im_py = DiskRaytrace(10.0, 0.7, 10.0, PyTwin(0.7),
                             DiskSpectrum_BlackBody(),
                             device="cpu").image(*args)["flux"].numpy()
        jdisk = JExternalDisk.create(model_so, 10.0, 0.7)
        im_j = np.asarray(JDiskRaytrace(10.0, 0.7, 10.0, jdisk, JBlackBody())
                          .image(*args)["flux"])
        hit = np.isfinite(im)
        assert hit.sum() > 100
        for other in (im_py, im_j):
            assert (np.isfinite(other) == hit).all()
            np.testing.assert_allclose(im[hit], other[hit], rtol=1e-5)
