"""The port's march kernel module (`sim5_tpu_torch.march.kernel_march`).

`march_reference`, the plain torch version of the CUDA kernel, is held
against the Pallas kernel run by the JAX package's interpreter
(`raytrace_pallas(..., interpret=True)`) on the same f32 state, at the
tolerances of test_pallas_march.py: equal step counts on > 90% of rays, and
where equal, relative dr < 1e-3, |dm| < 1e-3 and |df| < 2e-3 (f32 rounding
may flip a single adaptive-step decision).  The CUDA kernel itself runs
only on the card (chip_smoke.py); here the wrapper's routing and checks are
tested.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim5_tpu.core import kerr_metric, flat_metric, tetrad_zamo, on2bl
from sim5_tpu.march import (raytrace_prepare, raytrace_pallas,
                            RTOPT_POLARIZATION, RTOPT_FLAT)
from sim5_tpu_torch.march import RaytraceState, kernel_march

torch.set_num_threads(2)

VARIANTS = {"gr": (0.9, 0), "gr+pol": (0.5, RTOPT_POLARIZATION),
            "flat": (0.9, RTOPT_FLAT)}


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def _state(variant, n=48, seed=0):
    """A prepared f32 JAX state of numpy-seeded ZAMO rays (as
    test_pallas_march builds them), and the same state in the port."""
    a, opts = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    r = rng.uniform(6.0, 15.0, n).astype(np.float32)
    m = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    th = rng.uniform(0.3, np.pi - 0.3, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    with jax.enable_x64(False):
        a32 = jnp.float32(a)
        met = flat_metric(r, m) if opts & RTOPT_FLAT else kerr_metric(a32, r, m)
        T = tetrad_zamo(met)
        d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], -1)
        kloc = np.concatenate([np.ones((n, 1)), d], -1).astype(np.float32)
        k = on2bl(kloc, T)
        x = np.stack([np.zeros(n), r, m, np.zeros(n)], -1).astype(np.float32)
        f0 = (on2bl(np.broadcast_to(np.float32([0, 0, 1, 0]), (n, 4)), T)
              if opts & RTOPT_POLARIZATION else None)
        stj = raytrace_prepare(a32, x, k, f=f0, precision=0.01, options=opts)
    d = {f.name: np.asarray(getattr(stj, f.name))
         for f in dataclasses.fields(stj)}
    return stj, RaytraceState.from_numpy(d, device="cpu")


class TestAgainstPallas:
    """march_reference against the Pallas kernel's interpreter."""

    @pytest.mark.parametrize("variant", list(VARIANTS))
    def test_reference_matches_pallas_interpret(self, variant):
        stj, st = _state(variant)
        assert st.x.dtype == torch.float32
        kw = dict(r_max=50.0, max_steps=300)
        with jax.enable_x64(False):
            sP, actP = raytrace_pallas(stj, interpret=True, **kw)
        sT, actT = kernel_march.raytrace_reference(st, **kw)
        steps_p, steps_t = np.asarray(sP.steps), sT.steps.numpy()
        eq = steps_p == steps_t
        assert eq.mean() > 0.9
        xP, xT = np.asarray(sP.x), sT.x.numpy()
        both = eq & np.isfinite(xP[:, 1]) & np.isfinite(xT[:, 1])
        dr = np.abs(xP[:, 1] - xT[:, 1]) / np.maximum(np.abs(xP[:, 1]), 1.0)
        assert dr[both].max() < 1e-3
        assert np.abs(xP[:, 2] - xT[:, 2])[both].max() < 1e-3
        assert (np.asarray(actP) == actT.numpy())[eq].all()
        if variant == "gr+pol":
            fP, fT = np.asarray(sP.f), sT.f.numpy()
            assert np.isfinite(fT[both]).all()
            assert np.abs(fP - fT)[both].max() < 2e-3
        assert sT.steps.dtype == torch.int32 and sT.x.dtype == torch.float32


class TestWrapper:
    """raytrace_kernel's routing, masking and checks."""

    def test_cpu_tensors_take_the_plain_route(self):
        _, st = _state("gr", n=16, seed=1)
        before = dict(kernel_march.LAUNCHES)
        kw = dict(r_max=30.0, max_steps=20)
        s1, a1 = kernel_march.raytrace_kernel(st, **kw)
        s2, a2 = kernel_march.raytrace_reference(st, **kw)
        assert kernel_march.LAUNCHES == before
        for name in ("x", "k", "f", "kt", "error", "steps"):
            torch.testing.assert_close(getattr(s1, name), getattr(s2, name),
                                       rtol=0, atol=0)
        assert torch.equal(a1, a2)

    def test_active0_masks_rays(self):
        _, st = _state("gr", n=16, seed=2)
        mask = torch.arange(16) % 2 == 0
        s, act = kernel_march.raytrace_kernel(st, r_max=30.0, max_steps=20,
                                              active0=mask)
        assert (s.steps[~mask] == 0).all() and (s.steps[mask] > 0).all()
        assert not act[~mask].any()
        torch.testing.assert_close(s.x[~mask], st.x[~mask])

    def test_wrapper_rejects_what_the_kernel_does_not_take(self):
        _, st = _state("gr", n=8, seed=3)
        st64 = st._replace(x=st.x.double(), k=st.k.double())
        with pytest.raises(TypeError):
            kernel_march.raytrace_kernel(st64)
        # the CUDA launcher refuses CPU tensors before building anything
        tensors, scalars = kernel_march._pack(st, 50.0, 10, 1e-2, None)
        with pytest.raises(ValueError):
            kernel_march._march_cuda(*tensors, **scalars)

    def test_package_imports_no_jax(self):
        code = ("import sys, sim5_tpu_torch, sim5_tpu_torch.march.kernel_march,"
                " sim5_tpu_torch.march.emission, sim5_tpu_torch.special.polyroots,"
                " sim5_tpu_torch.special.carlson, sim5_tpu_torch.special.legendre,"
                " sim5_tpu_torch.special.jacobi, sim5_tpu_torch.geodesic.types,"
                " sim5_tpu_torch.geodesic.analytic, sim5_tpu_torch.render.image,"
                " sim5_tpu_torch.render.lightcurve;"
                "bad = [m for m in sys.modules if m == 'jax' or "
                "m.startswith(('jax.', 'sim5_tpu.')) or m == 'sim5_tpu'];"
                "assert not bad, bad")
        subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                       cwd=pathlib.Path(__file__).resolve().parent.parent)
