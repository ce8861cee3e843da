"""The rays of chip_smoke.py phase 22 whose central differences do not
converge: on the card, at 256^2, their FD with h and h / 2 disagree by
more than 1e-6 while their trial counts hold, so the phase leaves them
out of its gradient-vs-FD gate.  Here the 256^2 torus of example 11 is
seeded in both packages on the CPU, only those rays are marched (f64,
1024 steps in segments of 64, the phase's configuration) through the
JAX package's `_volume_march_scan` and the port's, and d I.sum() /
d(a, the torus' radius) is compared: if both derivatives agree, the FD
floor on these rays is the march's (its step decisions), not the port's.
Their FD is printed by phase 22 on the card.

Tolerances: every ray's gradient within 1e-8 relative of JAX's, as in
test_torch_volume_scan.py (the same derivative of the same step
sequence), but for at most one ray, which may reach 1e-6 (the test's
docstring says why).

Marked slow: the port's 1024 eager f64 steps with their checkpointed
backward take about 70 s on the CPU and JAX's about 45 s, past the
tier-1 budget of a file; run it with `python -m pytest
tests/test_torch_volume_scan_rays.py -m slow`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

pytestmark = pytest.mark.slow

# chip_smoke.py's VOL at SCAN_SIZE^2 and SCAN_STEPS
CFG = dict(a=0.9, incl=float(np.radians(70.0)), npix=256, rmax=16.0,
           r_start=40.0, precision=0.02, steps=1024, center=8.0)
# the row-major pixel indices that phase 22 printed on an NVIDIA H100 80GB
# HBM3 (700 W power limit)
RAYS = [
    16769, 17025, 17281, 17537, 18049, 18305, 21218, 21698, 21890,
    22146, 22402, 22711, 23480, 23939, 23989, 24195, 25220, 26246,
    26500, 29836, 30102, 30597, 31639, 31644, 32145, 32173, 32634,
    32642, 32654, 33426, 33608, 33685, 33719, 33857, 33982, 34356,
    34357, 34438, 34506, 34706, 34768, 34888, 35110, 35289, 35362,
    35549, 35866, 36069, 36118, 36329, 36501, 36506, 37129, 37366,
    37625, 39041]


def grid_of_rays(np_like):
    """An `image_grid` stand-in returning the selected pixels of the 256^2
    grid as (n,) arrays made by `np_like`."""
    n = CFG["npix"]
    ix = (np.arange(n) + 0.5) / n - 0.5
    rows, cols = np.divmod(np.asarray(RAYS), n)

    def image_grid(nx, ny, rmax, **kw):
        assert (nx, ny) == (n, n)
        alpha = ix[cols] * 2.0 * rmax
        beta = ix[rows] * 2.0 * rmax
        return np_like(alpha), np_like(beta)
    return image_grid


def torch_image(a, center):
    """The selected rays' I through the port's scan engine; `a` and
    `center` may be one value a ray."""
    src = GaussianSource(amp=1.0, center=center, inv_width=1.0 / 1.5,
                         inv_height=1.0 / 1.5, cylindrical=True)
    st, ok = tlc._volume_seed(a, CFG["incl"], 0.0, CFG["npix"], CFG["rmax"],
                              CFG["r_start"], CFG["precision"],
                              axisymmetric=True, device="cpu")
    return tlc._volume_march_scan(st, ok, CFG["r_start"], src,
                                  n_steps=CFG["steps"])


def jax_image(p):
    """The selected rays' I through the JAX package's scan engine, p = (a,
    the torus' radius)."""
    a, center = p[0], p[1]

    def j(t, r, m, phi):
        rho = r * jnp.sqrt(jnp.maximum(1.0 - m * m, 0.0))
        d = (rho - center) * (1.0 / 1.5)
        z = r * m * (1.0 / 1.5)
        return jnp.exp(-0.5 * (d * d + z * z))
    st, ok = jlc._volume_seed(a, CFG["incl"], 0.0, CFG["npix"], CFG["rmax"],
                              CFG["r_start"], CFG["precision"],
                              axisymmetric=True)
    return jlc._volume_march_scan(st, ok, CFG["r_start"], j,
                                  n_steps=CFG["steps"])


class TestUnconvergedRays:

    @pytest.fixture(scope="class")
    def grads(self):
        """Each ray's (dI/da, dI/d radius): the port's from one backward of
        the scan engine with a leaf of each parameter a ray (the rays are
        independent), JAX's by forward mode; (n, 2) each, and the rays'
        I."""
        mp = pytest.MonkeyPatch()
        mp.setattr(tlc, "image_grid", grid_of_rays(
            lambda v: torch.tensor(v, dtype=torch.float64)))
        mp.setattr(jlc, "image_grid", grid_of_rays(
            lambda v: jnp.asarray(v, jnp.float64)))
        try:
            n = len(RAYS)
            leaves = [torch.full((n,), v, dtype=torch.float64,
                                 requires_grad=True)
                      for v in (CFG["a"], CFG["center"])]
            image = torch_image(*leaves)
            g_t = torch.stack(torch.autograd.grad(image.sum(), leaves),
                              -1).numpy()
            g_j = np.asarray(jax.jacfwd(jax_image)(
                jnp.array([CFG["a"], CFG["center"]], jnp.float64)))
        finally:
            mp.undo()
        return image.detach().numpy(), g_t, g_j

    def test_rays_were_selected(self):
        assert len(RAYS) > 0 and len(set(RAYS)) == len(RAYS)
        assert all(0 <= r < CFG["npix"] ** 2 for r in RAYS)

    @pytest.mark.parametrize("arg", [0, 1], ids=["spin", "radius"])
    def test_port_gradient_matches_jax(self, grads, arg):
        """Every ray's derivative within 1e-8 of JAX's, but for at most one
        ray within 1e-6: these rays sit, by their selection, at a switch of
        the step controller, where a last-ulp difference between two
        evaluations of the march (ATen's CPU kernels against XLA's)
        moves one ray's derivative by up to ~5e-7 (measured: on the card
        the port's sum over these rays is within 1e-9 of JAX's)."""
        image, g_t, g_j = grads
        assert (image > 0).all() and np.isfinite(g_t).all()
        rel = np.abs(g_t[:, arg] - g_j[:, arg]) / np.abs(g_j[:, arg])
        worst = np.argsort(rel)[::-1][:3]
        print(f"{len(RAYS)} rays, d/d arg {arg}: sums port "
              f"{g_t[:, arg].sum():.9e}, JAX {g_j[:, arg].sum():.9e}; worst "
              + ", ".join(f"ray {RAYS[k]} {rel[k]:.3e}" for k in worst))
        assert (rel > 1e-8).sum() <= 1, rel[worst]
        assert rel.max() <= 1e-6, rel[worst]
