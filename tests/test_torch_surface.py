"""The port's thick-disk surface solvers (`find_surface`, the bracketed
root-find in P, and `find_surface_march`, the reference's step-halving
march) of `sim5_tpu_torch.render.driver`, against `sim5_tpu` on the same
rays, against the C reference's march golden, and their implicit
gradient, on the CPU in f64.

The disk is tests/test_driver.py's toy cone (H = 0.05 R, inner edge 6),
written once in jnp and once in torch.

Tolerances, and why:
* against JAX (test_driver.py's 24 rays, seed 3, and a 16^2 image grid,
  in one batch): ok equal; r and m within 1e-9 for find_surface (a
  24-step bisection and a Newton step on the same algebra) and 1e-10 for
  the march (the same adaptive steps);
* the march against thickdisk_cone_a05.npy: test_driver.py's gates (hit
  set equal, r rtol 1e-10, m atol 1e-12);
* the root-find's residual |H - h(R)| < 1e-9 (test_driver.py);
* d(sum r)/da: against central differences at h = 1e-5 to 1e-6 relative
  (test_driver.py), and against jax.grad of the JAX function to 1e-8
  relative (the same implicit-function rule).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu.render import driver as jdrv
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.render import driver as tdrv
from tests.conftest import GOLDEN

torch.set_num_threads(2)

INCL = math.radians(55.0)
SLOPE = 0.05


class JaxCone:
    """tests/test_driver.py's toy thick disk: photosphere at H = s R."""

    def h(self, r):
        return SLOPE * r

    def dhdr(self, r):
        return jnp.full_like(r, SLOPE)


class TorchCone:
    """The same cone on tensors."""

    def h(self, r):
        return SLOPE * r

    def dhdr(self, r):
        return torch.full_like(r, SLOPE)


def _rays():
    """test_driver.py's 24 random rays (seed 3) and a 16^2 grid over +-25."""
    rng = np.random.default_rng(3)
    alpha = rng.uniform(-25, 25, 24)
    beta = rng.uniform(2, 20, 24)
    xs = ((np.arange(16) + 0.5) / 16 - 0.5) * 50.0
    ga, gb = np.meshgrid(xs, xs)
    return (np.concatenate([alpha, ga.ravel()]),
            np.concatenate([beta, gb.ravel()]))


def _solve(solver, alpha, beta, a=0.5):
    """(JAX's solution as one jitted program, the port's) on the same
    rays."""
    jfn = jax.jit(lambda al, be: getattr(jdrv, solver)(
        jgd.geodesic_init_inf(INCL, a, al, be), JaxCone()))
    gt = tgd.geodesic_init_inf(INCL, a, torch.from_numpy(alpha),
                               torch.from_numpy(beta))
    return getattr(tdrv, solver)(gt, TorchCone()), jfn(alpha, beta), gt


def _check(got, want, tol):
    Pt, rt, mt, okt = (v.detach().numpy() for v in got)
    Pj, rj, mj, okj = map(np.asarray, want)
    assert np.array_equal(okt, okj)
    assert okj.mean() > 0.5
    np.testing.assert_allclose(rt[okj], rj[okj], rtol=tol, atol=0)
    np.testing.assert_allclose(mt[okj], mj[okj], rtol=0, atol=tol)
    return rt, mt, okt


class TestAgainstJax:
    def test_find_surface(self):
        got, want, _ = _solve("find_surface", *_rays())
        r, m, ok = _check(got, want, 1e-9)
        R = r[ok] * np.sqrt(1.0 - m[ok] ** 2)
        assert np.max(np.abs(r[ok] * m[ok] - SLOPE * R)) < 1e-9

    def test_find_surface_march(self):
        got, want, gt = _solve("find_surface_march", *_rays())
        rm, mm, okm = _check(got, want, 1e-10)
        # the root-find against the march: test_driver.py's gates
        P, r, m, ok = (v.numpy() for v in tdrv.find_surface(gt, TorchCone()))
        both = ok & okm
        assert (ok == okm).mean() > 0.9
        assert np.abs(r[both] - rm[both]).max() < 0.05

    def test_implicit_gradient(self):
        """d(sum of hit radii)/d(spin): autograd through the Newton polish
        against central differences and against jax.grad."""
        rng = np.random.default_rng(5)
        alpha = rng.uniform(-20, 20, 48)
        beta = rng.uniform(3, 18, 48)
        ta, tb = torch.from_numpy(alpha), torch.from_numpy(beta)

        def hit_r_sum(a):
            g = tgd.geodesic_init_inf(INCL, a, ta, tb)
            P, r, m, ok = tdrv.find_surface(g, TorchCone())
            return torch.where(ok, r, 0.0).sum()

        def hit_r_sum_jax(a):
            g = jgd.geodesic_init_inf(INCL, a, alpha, beta)
            P, r, m, ok = jdrv.find_surface(g, JaxCone())
            return jnp.sum(jnp.where(ok, r, 0.0))

        a = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
        ga, = torch.autograd.grad(hit_r_sum(a), a)
        h = 1e-5

        def f(x):
            return float(hit_r_sum(torch.tensor(x, dtype=torch.float64)))

        fd = (f(0.5 + h) - f(0.5 - h)) / (2 * h)
        assert abs(float(ga) - fd) / max(abs(fd), 1e-12) < 1e-6
        gj = float(jax.jit(jax.grad(hit_r_sum_jax))(jnp.float64(0.5)))
        assert abs(float(ga) - gj) / abs(gj) < 1e-8


class TestReferenceGolden:
    def test_march_matches_reference_python_layer(self):
        """The march against the reference's own __find_surface on the
        same cone and rays (test_driver.py's golden and gates)."""
        al, be, r_ref, m_ref, ok_ref = np.load(
            GOLDEN / "thickdisk_cone_a05.npy").T
        g = tgd.geodesic_init_inf(INCL, 0.5, torch.from_numpy(al),
                                  torch.from_numpy(be))
        P, r, m, ok = (v.numpy()
                       for v in tdrv.find_surface_march(g, TorchCone()))
        assert (ok == (ok_ref > 0)).all(), "hit set differs from reference"
        np.testing.assert_allclose(r[ok], r_ref[ok], rtol=1e-10)
        np.testing.assert_allclose(m[ok], m_ref[ok], atol=1e-12)

    def test_f32_bisection_depth(self):
        """An f32 geodesic runs the f32 depth (16 steps) and stays in f32;
        its hits agree with f64 on > 95% of the rays, their radii to 1e-4
        relative."""
        alpha, beta = _rays()
        g64 = tgd.geodesic_init_inf(INCL, 0.5, torch.from_numpy(alpha),
                                    torch.from_numpy(beta))
        g32 = tgd.geodesic_init_inf(
            torch.tensor(INCL, dtype=torch.float32), 0.5,
            torch.from_numpy(alpha).float(), torch.from_numpy(beta).float())
        P, r, m, ok = tdrv.find_surface(g32, TorchCone())
        assert r.dtype == torch.float32
        _, r64, _, ok64 = tdrv.find_surface(g64, TorchCone())
        both = ok & ok64
        assert (ok == ok64).float().mean() > 0.95
        rel = ((r.double() - r64).abs() / r64)[both]
        assert float(rel.max()) < 1e-4
