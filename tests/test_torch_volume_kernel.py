"""The transfer variants of the port's march kernel
(`sim5_tpu_torch.march.kernel_march` with `march.emission` models) against
the Pallas kernel of `sim5_tpu`, run by the JAX package's interpreter.

The CUDA kernel runs only on the card (chip_smoke.py); here its plain
version, `march_reference`, is what a CPU tensor takes.

Tolerances, and why:
* the plain version (f32) against the Pallas interpreter on 48 ZAMO rays:
  equal step counts on > 90% of rays, `active` equal, and where the step
  counts are equal |dI| <= 1e-4 of the peak (an f32 rounding may flip a
  single adaptive-step decision, as in test_pallas_march.py);
* the kernel route of `volume_image` against JAX "pallas": 2e-2 of the
  peak, the repo's own gate (test_pallas_march.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu.core import kerr_metric, tetrad_zamo, on2bl
from sim5_tpu.march import raytrace_prepare, raytrace_pallas
from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.march import RaytraceState, kernel_march
from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

# test_pallas_march.py's volume configuration, at a = 0.9, incl = 1.2
PALLAS_KW = dict(npix=16, rmax=12.0, r_start=20.0, max_steps=500,
                 precision=0.03, axisymmetric=True)

# the models of test_pallas_march.py, in jnp and as GaussianSource
BLOB = GaussianSource(amp=1.0, center=8.0, inv_width=1.0, inv_height=1.0)
ALPHA_BLOB = GaussianSource(amp=0.15, center=8.0, inv_width=1.0 / 3.0)


def jblob(t, r, m, phi):
    return jnp.exp(-0.5 * ((r - 8.0) ** 2 + (m * r) ** 2))


def jalpha_blob(t, r, m, phi):
    return 0.15 * jnp.exp(-0.5 * ((r - 8.0) / 3.0) ** 2)


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def _zamo_state(n=48, seed=0, a=0.9):
    """A prepared f32 JAX state of numpy-seeded ZAMO rays (as
    test_pallas_march builds them), and the same state in the port."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(6.0, 15.0, n).astype(np.float32)
    m = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    th = rng.uniform(0.3, np.pi - 0.3, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    with jax.enable_x64(False):
        a32 = jnp.float32(a)
        T = tetrad_zamo(kerr_metric(a32, r, m))
        d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], -1)
        kloc = np.concatenate([np.ones((n, 1)), d], -1).astype(np.float32)
        x = np.stack([np.zeros(n), r, m, np.zeros(n)], -1).astype(np.float32)
        stj = raytrace_prepare(a32, x, on2bl(kloc, T), precision=0.01)
    d = {f.name: np.asarray(getattr(stj, f.name))
         for f in dataclasses.fields(stj)}
    return stj, RaytraceState.from_numpy(d, device="cpu")


class TestTransferKernel:
    """The transfer variants' plain version against the Pallas
    interpreter, and the kernel route of volume_image against JAX
    "pallas"."""

    @pytest.mark.parametrize("thick", [False, True], ids=["thin", "thick"])
    def test_reference_matches_pallas_interpret(self, thick):
        stj, st = _zamo_state()
        kw = dict(r_max=50.0, max_steps=300)
        with jax.enable_x64(False):
            sP, aP, IP = raytrace_pallas(
                stj, interpret=True, emissivity_fn=jblob,
                absorption_fn=jalpha_blob if thick else None, **kw)
        sT, aT, IT = kernel_march.raytrace_kernel(
            st, emissivity=BLOB, absorption=ALPHA_BLOB if thick else None,
            **kw)
        assert IT.dtype == torch.float32 and IT.shape == (48,)
        IP = np.asarray(IP)
        eq = np.asarray(sP.steps) == sT.steps.numpy()
        assert eq.mean() > 0.9
        peak = IP.max()
        assert peak > 0 and np.isfinite(IT.numpy()).all()
        assert np.abs(IT.numpy() - IP)[eq].max() <= 1e-4 * peak
        np.testing.assert_array_equal(aT.numpy(), np.asarray(aP))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                             ids=["f32-seed", "f64-seed"])
    def test_volume_image_kernel_route_matches_pallas(self, dtype):
        """The JAX "pallas" engine as test_pallas_march.py runs it on the
        CPU, under enable_x64(False): f32 seed and f32 march (its Pallas
        interpreter does not run under x64).  The port's kernel route with
        an f32 seed mirrors that; with the f64 seed it is the slice's main
        path (f64 seed, state cast to f32 for the march)."""
        with jax.enable_x64(False):
            Ij = np.asarray(jlc.volume_image(
                0.9, 1.2, jblob, engine="pallas", absorption_fn=jalpha_blob,
                **PALLAS_KW))
        It = tlc.volume_image(0.9, 1.2, BLOB, engine="kernel",
                              absorption_fn=ALPHA_BLOB, dtype=dtype,
                              device="cpu", **PALLAS_KW)
        assert It.dtype == torch.float32 and It.shape == (16, 16)
        assert np.isfinite(It.numpy()).all()
        peak = Ij.max()
        assert peak > 0
        assert np.abs(It.numpy() - Ij).max() <= 2e-2 * peak
