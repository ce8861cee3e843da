"""The port's parallel layer (`sim5_tpu_torch.parallel`) against the JAX
package's (`tests/test_parallel.py`): the disk image's row window, and a
3-rank gloo world on the CPU (`torch_parallel_worker.py`, a file store
under the test's tmp dir) running shard_image_rows, the sharded render,
DiskRaytrace.image / .spectrum with mesh= and a table row through
generate_disk_table(mesh=), held against the port unsharded and against
JAX's sharded calls on the conftest's 8-device mesh.  No size divides by
3 or by 8, so every path pads."""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from sim5_tpu.parallel import make_mesh as jax_make_mesh
from sim5_tpu.parallel import render_disk_image_sharded as jax_sharded

from sim5_tpu_torch.disk import ThinDisk, nt_setup
from sim5_tpu_torch.render import (DiskRaytrace, DiskSpectrum_BlackBody,
                                   render_disk_image)
from sim5_tpu_torch.render.image import render_disk_image_reference
from sim5_tpu_torch.tables import generate_disk_table

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_parallel_worker as worker  # noqa: E402

WORLD = 3


def check_image(got, want, name):
    """rtol 1e-9 with at most one flip of the hit footprint, as
    tests/test_parallel.py allows: a pixel whose r sits within last-ulp
    noise of the ISCO threshold may flip between two evaluation orders."""
    flip = (got > 0) != (want > 0)
    assert flip.sum() <= 1, f"{name}: {flip.sum()} hit-footprint flips"
    ok = ~flip
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9, atol=1e-300,
                               err_msg=name)


def check_maps(got, want):
    """Each of DiskRaytrace.image's maps: the same footprint (finite
    pixels), rtol 1e-9 on it."""
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        fin = np.isfinite(w)
        assert (fin == np.isfinite(g)).all(), f"{k}: footprint"
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, err_msg=k)


def cpu_disk(c, dtype=torch.float64):
    return nt_setup(*(torch.tensor(v, dtype=dtype)
                      for v in (c["M"], c["a"], c["mdot"], c["alpha"])))


class TestRowWindow:
    """The plain version's row window: windows of 7 rows (32 is no
    multiple) concatenated against the whole frame, and the backward
    summed over the windows against the whole frame's."""

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_windows_tile_the_frame(self, dtype):
        c = worker.IMAGE
        n = c["npix"]
        disk = cpu_disk(c, dtype)
        whole = render_disk_image(disk, c["incl"], n, n, c["rmax"])
        parts = [render_disk_image(disk, c["incl"], n, n, c["rmax"], r0,
                                   min(7, n - r0)) for r0 in range(0, n, 7)]
        for i in range(2):
            got = torch.cat([p[i] for p in parts])
            assert got.shape == (n, n)
            check_image(got.double().numpy(), whole[i].double().numpy(),
                        f"image {i}")

    def test_window_of_a_batch(self):
        c = worker.IMAGE
        spins = torch.tensor([0.3, 0.7, 0.9], dtype=torch.float64)
        disk = nt_setup(torch.full((3,), c["M"], dtype=torch.float64), spins,
                        torch.full((3,), c["mdot"], dtype=torch.float64),
                        torch.full((3,), c["alpha"], dtype=torch.float64))
        whole = render_disk_image(disk, c["incl"], 16, 20)
        win = render_disk_image(disk, c["incl"], 16, 20, None, 5, 9)
        assert win[0].shape == (3, 9, 16)
        for i in range(2):
            check_image(win[i].numpy(), whole[i][:, 5:14].numpy(),
                        f"batch image {i}")

    def test_backward_sums_over_windows(self):
        c = worker.IMAGE
        n = 16

        def grads(windows):
            leaves = [torch.tensor(v, dtype=torch.float64,
                                   requires_grad=True)
                      for v in (c["M"], c["a"], c["mdot"], c["incl"])]
            disk = nt_setup(leaves[0], leaves[1], leaves[2], c["alpha"])
            loss = 0.0
            for r0, rows in windows:
                f, g = render_disk_image_reference(disk, leaves[3], n, n,
                                                   None, r0, rows)
                loss = loss + (f * 1e-25).sum() + g.sum()
            return torch.autograd.grad(loss, leaves)

        whole = grads([(0, n)])
        parts = grads([(0, 5), (5, 5), (10, 6)])
        for w, p in zip(whole, parts):
            assert abs(float(p - w)) <= 1e-12 * abs(float(w))

    @pytest.mark.parametrize("row0, rows", [(-1, 4), (0, 0), (10, 7)])
    def test_bad_window(self, row0, rows):
        with pytest.raises(ValueError):
            render_disk_image(cpu_disk(worker.IMAGE), 1.2, 16, 16, None,
                              row0, rows)


class TestLauncher:
    """A world started as `torchrun` starts one: each rank has only the
    launcher's variables (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), and `make_mesh(device="cpu")`, alone or after
    `init_distributed(device="cpu")` with no arguments, joins that world:
    the mesh spans every rank, not a group of one."""

    @pytest.mark.parametrize("case", ["launcher_mesh", "launcher_init"])
    def test_make_mesh_joins_the_launchers_world(self, case, tmp_path):
        ranks = worker.run_world(case, WORLD, tmp_path, launcher=True)
        for r, out in enumerate(ranks):
            assert out["size"].tolist() == [WORLD, WORLD]
            assert out["rank"].tolist() == [r, r]
            assert out["sum"].tolist() == [WORLD * (WORLD + 1) / 2]

    def test_a_world_needs_a_rank(self, monkeypatch):
        from sim5_tpu_torch.parallel import init_distributed
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.delenv("RANK", raising=False)
        with pytest.raises(ValueError, match="process_id"):
            init_distributed(device="cpu")

    def test_no_launcher_no_group(self, monkeypatch):
        from sim5_tpu_torch.parallel import init_distributed, mesh

        def refuse(*args, **kwargs):
            raise AssertionError("a group of one process was started")

        monkeypatch.delenv("WORLD_SIZE", raising=False)
        monkeypatch.setattr(mesh.dist, "init_process_group", refuse)
        init_distributed(device="cpu")


class TestMeshArgument:
    """mesh= takes a 1-D DeviceMesh: anything else (a JAX Mesh, say) is
    refused before any work."""

    def test_sharded_render_refuses_a_jax_mesh(self):
        with pytest.raises(ValueError, match="DeviceMesh"):
            from sim5_tpu_torch.parallel import shard_image_rows
            shard_image_rows(torch.zeros(4, 4), jax_make_mesh(jax.devices()))

    def test_driver_refuses_a_non_mesh(self):
        d = worker.DRIVER
        disk = ThinDisk.create(d["M"], d["a"], d["mdot"], device="cpu")
        rt = DiskRaytrace(d["M"], d["a"], d["dist"], disk,
                          DiskSpectrum_BlackBody(), device="cpu")
        with pytest.raises(ValueError, match="DeviceMesh"):
            rt.image(d["incl"], d["rmax"], 8, mesh=object())
        with pytest.raises(ValueError, match="DeviceMesh"):
            rt.spectrum(d["incl"], [1.0, 2.0], radres=2.0, angres=8.0,
                        mesh=object())


@pytest.fixture(scope="class")
def world(tmp_path_factory):
    """The 3-rank world's arrays of the "sharded" case, one dict a rank."""
    return worker.run_world("sharded", WORLD,
                            tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return jax_make_mesh(jax.devices())


class TestShardedWorld:
    """One 3-rank gloo world runs every case (`world`); each rank holds
    the whole result."""

    def test_shard_image_rows(self, world):
        arr = np.arange(20 * 16, dtype=np.float64).reshape(20, 16)
        # 20 rows over 3 ranks: blocks of 7, the last padded with row 19
        padded = np.concatenate([arr, arr[-1:]])
        for r, out in enumerate(world):
            assert out["shard"].shape == (7, 16)
            np.testing.assert_array_equal(out["shard"],
                                          padded[7 * r:7 * r + 7])
            np.testing.assert_array_equal(out["gathered"], arr)

    def test_every_rank_holds_the_result(self, world):
        for out in world[1:]:
            for k in ("image_f", "image_g", "map_flux", "spec_f", "table"):
                np.testing.assert_array_equal(
                    np.nan_to_num(out[k]), np.nan_to_num(world[0][k]),
                    err_msg=k)

    def test_render_matches_unsharded(self, world):
        c = worker.IMAGE
        f, g = render_disk_image(cpu_disk(c), c["incl"], c["npix"],
                                 c["npix"], c["rmax"])
        check_image(world[0]["image_f"], f.numpy(), "image_f")
        check_image(world[0]["image_g"], g.numpy(), "image_g")

    def test_render_matches_jax_sharded(self, world, jax_mesh):
        c = worker.IMAGE
        f, g = jax_sharded(jax_mesh, c["M"], c["a"], c["mdot"], c["alpha"],
                           c["incl"], npix_x=c["npix"], npix_y=c["npix"],
                           rmax=c["rmax"])
        check_image(world[0]["image_f"], np.asarray(f), "image_f")
        check_image(world[0]["image_g"], np.asarray(g), "image_g")

    def test_image_matches_unsharded(self, world):
        d = worker.DRIVER
        disk = ThinDisk.create(d["M"], d["a"], d["mdot"], device="cpu")
        rt = DiskRaytrace(d["M"], d["a"], d["dist"], disk,
                          DiskSpectrum_BlackBody(), device="cpu")
        im = rt.image(d["incl"], d["rmax"], d["N"])
        check_maps({k: world[0][f"map_{k}"] for k in im},
                   {k: v.numpy() for k, v in im.items()})

    def test_image_matches_jax_sharded(self, world, jax_mesh):
        from sim5_tpu.disk import ThinDisk as JThinDisk
        from sim5_tpu.render import (DiskRaytrace as JDiskRaytrace,
                                     DiskSpectrum_BlackBody as JBB)
        d = worker.DRIVER
        rt = JDiskRaytrace(d["M"], d["a"], d["dist"],
                           JThinDisk.create(d["M"], d["a"], d["mdot"]),
                           JBB())
        im = rt.image(d["incl"], d["rmax"], d["N"], mesh=jax_mesh)
        check_maps({k: world[0][f"map_{k}"] for k in im},
                   {k: np.asarray(v) for k, v in im.items()})

    def test_spectrum_matches_unsharded(self, world):
        d, s = worker.DRIVER, worker.SPECTRUM
        disk = ThinDisk.create(d["M"], d["a"], d["mdot"], device="cpu")
        rt = DiskRaytrace(d["M"], d["a"], d["dist"], disk,
                          DiskSpectrum_BlackBody(), device="cpu")
        sf, s0, diag = rt.spectrum(d["incl"], worker.geom(s["E"]),
                                   radres=s["radres"], angres=s["angres"],
                                   batch=s["batch"], return_diagnostics=True)
        out = world[0]
        assert np.isfinite(out["spec_f"]).all() and out["spec_f"].max() > 0
        np.testing.assert_allclose(out["spec_f"], sf.numpy(), rtol=1e-10)
        np.testing.assert_allclose(out["spec_0"], s0.numpy(), rtol=1e-10)
        # the zero-weight pad adds no solid angle
        np.testing.assert_allclose(out["domega"], [diag["domega_err"],
                                                   diag["domega_tot"]],
                                   rtol=1e-12, atol=1e-300)

    def test_spectrum_matches_jax_sharded(self, world, jax_mesh):
        from sim5_tpu.disk import ThinDisk as JThinDisk
        from sim5_tpu.render import (DiskRaytrace as JDiskRaytrace,
                                     DiskSpectrum_BlackBody as JBB)
        d, s = worker.DRIVER, worker.SPECTRUM
        rt = JDiskRaytrace(d["M"], d["a"], d["dist"],
                           JThinDisk.create(d["M"], d["a"], d["mdot"]),
                           JBB())
        sf, s0 = rt.spectrum(d["incl"], worker.geom(s["E"]),
                             radres=s["radres"], angres=s["angres"],
                             batch=s["batch"], mesh=jax_mesh)
        np.testing.assert_allclose(world[0]["spec_f"], np.asarray(sf),
                                   rtol=1e-10)
        np.testing.assert_allclose(world[0]["spec_0"], np.asarray(s0),
                                   rtol=1e-10)

    def test_table_row_through_mesh(self, world, jax_mesh, tmp_path):
        from sim5_tpu.tables import generate_disk_table as jax_table
        t = worker.TABLE
        kw = dict(spins=t["spins"], mdots=t["mdots"], incls=t["incls"],
                  energies=worker.geom(t["E"]), radres=t["radres"],
                  angres=t["angres"])
        got = world[0]["table"]
        assert np.isfinite(got).all() and got.max() > 0
        plain = generate_disk_table(str(tmp_path / "p.npz"), device="cpu",
                                    **kw)
        np.testing.assert_allclose(got, plain.spectra, rtol=1e-10)
        ref = jax_table(str(tmp_path / "j.npz"), mesh=jax_mesh, **kw)
        np.testing.assert_allclose(got, ref.spectra, rtol=1e-10)
