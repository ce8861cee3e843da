"""The march kernel's traced route on the CPU: emission and absorption
models outside the `GaussianSource` family (tests/torch_trace_models.py,
in torch) through `raytrace_kernel` and `volume_image(engine="kernel")`,
against the Pallas kernel of `sim5_tpu` run by the JAX package's
interpreter with the models' jnp twins.

On the CPU the kernel's plain version runs (`raytrace_kernel`'s calls the
callables, `volume_image`'s the traces it made of them); the models are
traced first, so what the kernel cannot take is refused here too
(test_torch_march_trace.py).  Tolerances, as
test_torch_volume_kernel.py's, and why:
* the plain version against the Pallas interpreter on 48 ZAMO rays:
  equal step counts on > 90% of rays, and where they are equal |dI| <=
  1e-4 of the peak (an f32 rounding may flip a single adaptive-step
  decision, as in test_pallas_march.py);
* the kernel route of `volume_image` against JAX "pallas": 2e-2 of the
  peak, the repo's own gate (test_pallas_march.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_trace_models as tm
from sim5_tpu.march import raytrace_pallas
from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.march import kernel_march
from sim5_tpu_torch.render import lightcurve as tlc
from test_torch_volume_kernel import PALLAS_KW, _zamo_state

torch.set_num_threads(2)

# the models outside the family, thin and thick: (emissivity, absorption)
PAIRS = {"corona": ("corona", None),
         "corona thick": ("corona", "corona_alpha"),
         "spiral": ("spiral", None),
         "spiral thick": ("spiral", "spiral_alpha")}


def _models(xp, pair):
    return tuple(None if name is None else tm.MODELS[name](xp)
                 for name in PAIRS[pair])


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


class TestTracedRoute:

    @pytest.mark.parametrize("pair", list(PAIRS))
    def test_plain_route_matches_pallas_interpret(self, pair):
        stj, st = _zamo_state()
        kw = dict(r_max=50.0, max_steps=300)
        jj, ja = _models(jnp, pair)
        with jax.enable_x64(False):
            sP, aP, IP = raytrace_pallas(stj, interpret=True, emissivity_fn=jj,
                                         absorption_fn=ja, **kw)
        before = dict(kernel_march.LAUNCHES)
        tj, ta = _models(torch, pair)
        sT, aT, IT = kernel_march.raytrace_kernel(st, emissivity=tj,
                                                  absorption=ta, **kw)
        assert kernel_march.LAUNCHES == before
        assert IT.dtype == torch.float32 and IT.shape == (48,)
        IP = np.asarray(IP)
        eq = np.asarray(sP.steps) == sT.steps.numpy()
        assert eq.mean() > 0.9
        peak = IP.max()
        assert peak > 0 and np.isfinite(IT.numpy()).all()
        assert np.abs(IT.numpy() - IP)[eq].max() <= 1e-4 * peak
        np.testing.assert_array_equal(aT.numpy(), np.asarray(aP))

    def test_volume_image_kernel_route_matches_pallas(self):
        """The corona, thick, at test_pallas_march.py's configuration: the
        JAX "pallas" engine under enable_x64(False) (its interpreter does
        not run under x64) against the port's kernel route, f32 seed."""
        jj, ja = _models(jnp, "corona thick")
        with jax.enable_x64(False):
            Ij = np.asarray(jlc.volume_image(
                0.9, 1.2, jj, engine="pallas", absorption_fn=ja, **PALLAS_KW))
        tj, ta = _models(torch, "corona thick")
        It = tlc.volume_image(0.9, 1.2, tj, engine="kernel", absorption_fn=ta,
                              dtype=torch.float32, device="cpu", **PALLAS_KW)
        assert It.dtype == torch.float32 and It.shape == (16, 16)
        assert np.isfinite(It.numpy()).all()
        peak = Ij.max()
        assert peak > 0
        assert np.abs(It.numpy() - Ij).max() <= 2e-2 * peak
