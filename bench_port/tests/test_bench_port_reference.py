"""The benchmark's reference against the port's plain functions, and its
imports.

The reference (`bench_port/reference/`) is a frozen copy of the port's
plain torch chains that imports nothing of the port; here, on the CPU at
small sizes, it must give the port's plain answers bit for bit.  No module
of the benchmark may import `jax` or the JAX package (`sim5_tpu`, whose
name the port's begins with: names are compared whole), by its source or
through `sys.modules` once the harness and every entry and reader are
loaded.

Run: python -m pytest bench_port/tests -q
"""

import ast
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from bench_port.reference import crossing, nt_image, volume  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "sim5_tpu"}
CPU = torch.device("cpu")


def imports(path):
    """The whole top-level names a module imports (relative imports are
    inside the benchmark)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def modules(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", modules("reference"), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "sim5_tpu_torch" not in imports(path)


def test_no_jax_in_sys_modules():
    code = (
        "import sys, pathlib; sys.path.insert(0, %r)\n"
        "import bench_port.harness, bench_port.reference.volume\n"
        "import bench_port.reference.crossing\n"
        "from bench_port.registry import Registry\n"
        "reg = Registry.load(%r)\n"
        "for kind in ('entries', 'metrics'):\n"
        "    for p in sorted((reg.folder / kind).glob('*.py')):\n"
        "        reg.module(kind, p.stem)\n"
        "for e in ('nt_sweep', 'nt_grad', 'spot_volume', 'spot_lightcurve'):\n"
        "    reg.entry(e).setup\n"
        "import sim5_tpu_torch.render, sim5_tpu_torch.disk\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (str(ROOT), str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_nt_image_is_the_ports_plain_image():
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render.image import render_disk_image_reference
    spins, incl = [0.998, 0.95, 0.5], math.radians(80.0)
    for dt in (torch.float64, torch.float32):
        f, g = nt_image.frames_image(10.0, spins, 0.1, 0.1, incl, 24, dt, CPU)
        n = len(spins)
        disk = nt_setup(*(torch.full((n,), v, dtype=dt) for v in (10.0,)),
                        torch.tensor(spins, dtype=torch.float64).to(dt),
                        *(torch.full((n,), v, dtype=dt) for v in (0.1, 0.1)))
        pf, pg = render_disk_image_reference(disk, torch.full((n,), incl,
                                                              dtype=dt),
                                             24, 24)
        assert torch.equal(f, pf) and torch.equal(g, pg)


def test_nt_gradient_is_the_ports_plain_gradient():
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render.image import render_disk_image_reference
    incl = math.radians(80.0)
    got = nt_image.frame_grad(10.0, 0.99, 0.1, 0.1, incl, 16, 1e-25,
                              torch.float64, CPU)
    leaves = [torch.tensor([v], dtype=torch.float64, requires_grad=True)
              for v in (0.99, incl, 0.1)]
    disk = nt_setup(torch.tensor([10.0], dtype=torch.float64), leaves[0],
                    leaves[2], torch.tensor([0.1], dtype=torch.float64))
    f, _ = render_disk_image_reference(disk, leaves[1], 16, 16)
    loss = f.sum() * 1e-25
    grads = torch.autograd.grad(loss, leaves)
    want = (float(loss.detach()), *(float(v) for v in grads))
    assert got == want


def test_volume_is_the_ports_loop_engine():
    from sim5_tpu_torch.march.emission import GaussianSource
    from sim5_tpu_torch.render import volume_image
    a, incl, om, w = 0.5, math.radians(70.0), 1.0 / (7.0 ** 1.5 + 0.5), 1.0
    args = dict(amp=1.0, center=7.0, inv_width=w, inv_height=w,
                cylindrical=True, omega=om, inv_arc=w)
    want = volume_image(a, incl, GaussianSource(**args), npix=6, rmax=17.5,
                        r_start=40.0, max_steps=300, precision=0.02,
                        engine="loop", t0=20.0, device="cpu")
    got = volume.pixels_image(a, incl, 20.0, 6, 17.5, 40.0, 300, 0.02,
                              volume.gaussian_source(**args), range(36),
                              torch.float64, torch.float64, CPU)
    assert torch.equal(got, want.reshape(-1))


def test_light_curve_is_the_ports_plain_curve():
    from sim5_tpu_torch.render import lightcurve
    a, incl = 0.5, math.radians(70.0)
    t = np.arange(8) / 8 * 2 * 2 * math.pi * (7.0 ** 1.5 + a)
    maps = [lightcurve.equatorial_crossing_map_reference(a, incl, 10, 17.5,
                                                         o, device="cpu")
            for o in (0, 1)]
    Om = lightcurve.OmegaK(torch.tensor(7.0, dtype=torch.float64), a)
    tt = torch.as_tensor(t)
    want = sum(lightcurve.spot_flux(m, Om, 7.0, 0.7, tt) for m in maps)
    got = crossing.lightcurve(a, incl, 7.0, 0.7, t.tolist(), 10, 17.5, 2,
                              torch.float64, CPU, rows=3)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=0.0)
