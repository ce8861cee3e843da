"""The port's data-parallel fit step (`parallel.fit_step_sharded`) against
the JAX package's on its 8-device CPU mesh: three Adam steps in a 3-rank
gloo world (`torch_parallel_worker.py`) at 16^2 (16 rows over 3 ranks:
padded), with incl held and fitted; the grid fixed by the rmax that rides
opt_state; and a fit begun in JAX (two steps) carried on in the port by
`adam_state_from_numpy` (one step) against three JAX steps."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sim5_tpu.core import r_ms
from sim5_tpu.parallel import (fit_step_sharded, make_mesh,
                               render_disk_image_sharded)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_parallel_worker as worker  # noqa: E402

C = worker.FIT


def jax_fit(mesh, target, p0, incl, steps):
    """`steps` JAX steps from p0: [(params, loss, (count, mu, nu, rmax))] a
    step, the Adam state's leaves copied to numpy (the step donates its
    buffers)."""
    p, st, out = tuple(jnp.float64(v) for v in p0), None, []
    for _ in range(steps):
        p, loss, st = fit_step_sharded(mesh, p, target, incl,
                                       npix_x=C["npix"], npix_y=C["npix"],
                                       lr=C["lr"], opt_state=st)
        adam = st[0][0]
        leaves = (np.asarray(adam.count),
                  np.array([float(v) for v in adam.mu]),
                  np.array([float(v) for v in adam.nu]), st[1])
        out.append((np.array([float(v) for v in p]), float(loss), leaves))
    return out


@pytest.fixture(scope="class")
def fits(tmp_path_factory):
    """JAX's fits on its mesh, then the port's in the 3-rank world."""
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    mesh = make_mesh(jax.devices())
    tmp = tmp_path_factory.mktemp("fit")
    n = C["npix"]
    imf, _ = render_disk_image_sharded(mesh, *C["true"], 0.1, C["incl"],
                                       npix_x=n, npix_y=n)
    target = np.asarray(imf)
    np.save(tmp / "target.npy", target)
    ref = {"p3": jax_fit(mesh, jnp.asarray(target), C["p3"], C["incl"],
                         C["steps"]),
           "p4": jax_fit(mesh, jnp.asarray(target), C["p4"], None,
                         C["steps"])}
    # the state after two steps, as the leaves of optax's ScaleByAdamState
    p2, _, (count, mu, nu, rmax) = ref["p3"][1]
    np.savez(tmp / "carry.npz", count=count, mu=mu, nu=nu, rmax=rmax,
             params=p2)
    return ref, worker.run_world("fit", 3, tmp)


class TestFitStep:
    @pytest.mark.parametrize("tag", ["p3", "p4"])
    def test_steps_match_jax(self, fits, tag):
        ref, world = fits
        want_p = np.array([p for p, _, _ in ref[tag]])
        want_l = np.array([loss for _, loss, _ in ref[tag]])
        for out in world:
            np.testing.assert_allclose(out[f"{tag}_params"], want_p,
                                       rtol=1e-9)
            np.testing.assert_allclose(out[f"{tag}_losses"], want_l,
                                       rtol=1e-8)
        losses = world[0][f"{tag}_losses"]
        assert np.isfinite(losses).all() and losses[-1] <= losses[0]
        assert losses[0] < 10.0

    @pytest.mark.parametrize("tag", ["p3", "p4"])
    def test_grid_stays_fixed(self, fits, tag):
        ref, world = fits
        a0 = C[tag][1]
        want = float(r_ms(a0)) + 8.0
        assert float(world[0][f"{tag}_rmax"]) == pytest.approx(want,
                                                               rel=1e-12)
        assert float(world[0][f"{tag}_rmax"]) == pytest.approx(
            ref[tag][-1][2][3], rel=1e-12)

    def test_carry_jax_state_into_the_port(self, fits):
        ref, world = fits
        p3, loss3, _ = ref["p3"][2]
        for out in world:
            np.testing.assert_allclose(out["carry_params"], p3, rtol=1e-9)
            np.testing.assert_allclose(out["carry_loss"], loss3, rtol=1e-8)
