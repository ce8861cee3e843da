"""The analytic entry points' dispatch between the crossing-map and
volume-seed kernels and their plain torch chains, on the CPU.

* `_kernel_route`: the kernels run on the card with no input that
  requires grad; an input that requires grad (a spin, an inclination, a
  time) or a CPU device takes the plain chain;
* CPU tensors run the plain chain, and `kernel_analytic.LAUNCHES` does
  not move: `equatorial_crossing_map`, `_volume_seed` and the wrappers
  themselves (`crossing_maps`, `volume_seed_rays`) give the plain versions' bits;
* a spin that requires grad gives `volume_image(engine="scan")` the
  gradient of the plain chain, bitwise (the seed under autograd, then the
  checkpointed march);
* `equatorial_crossing_map` with the order axis returns, bitwise, each
  order's map of the plain version (test_torch_hotspot.py holds
  `hotspot_lightcurve`, which takes its maps so, against the sum over
  them).

Everything here is bitwise: the same torch operations in the same order.
"""

import math

import torch

from sim5_tpu_torch.render import kernel_analytic
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

A, INCL, NPIX, RMAX = 0.5, math.radians(70.0), 8, 17.5
SEED = dict(incl=math.radians(70.0), npix=8, rmax=16.0, r_start=40.0,
            precision=0.02)


def _same(x, y):
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(u, v) for u, v in zip(x, y))
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    return x == y


def test_route():
    """The kernels run on the card only, and only with no input that
    requires grad."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    a = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    assert tlc._kernel_route(cuda, 0.5, INCL, RMAX)
    assert tlc._kernel_route(cuda, torch.tensor(0.5), INCL)
    assert not tlc._kernel_route(cpu, 0.5, INCL, RMAX)
    assert not tlc._kernel_route(cuda, a, INCL, RMAX)
    assert not tlc._kernel_route(cuda, 0.5, torch.tensor(
        INCL, requires_grad=True))


def test_cpu_runs_the_plain_chain_with_no_launch():
    """On the CPU the entry points and the wrappers give the plain
    versions' bits and launch nothing."""
    before = dict(kernel_analytic.LAUNCHES)
    m = tlc.equatorial_crossing_map(A, INCL, NPIX, RMAX, 1, device="cpu")
    assert _same(m, tlc.equatorial_crossing_map_reference(
        A, INCL, NPIX, RMAX, 1, device="cpu"))
    raw = kernel_analytic.crossing_maps(A, INCL, NPIX, RMAX, (1,), "cpu")
    hit = raw["hit"][0]
    dt = raw["dt"][0] - torch.where(hit, raw["dt"][0], math.inf).min()
    assert _same(dict(r=raw["r"][0], phi=raw["phi"][0], g=raw["g"][0],
                      delay=dt, hit=hit),
                 {k: m[k] for k in ("r", "phi", "g", "delay", "hit")})
    for axi in (False, True):
        st, ok = tlc._volume_seed(0.9, SEED["incl"], 0.0, SEED["npix"],
                                  SEED["rmax"], SEED["r_start"],
                                  SEED["precision"], axisymmetric=axi,
                                  device="cpu")
        rays = kernel_analytic.volume_seed_rays(
            0.9, SEED["incl"], 0.0, SEED["npix"], SEED["rmax"],
            SEED["r_start"], axi, torch.float64, "cpu")
        assert torch.equal(ok, rays[2])
        assert torch.equal(st.x, rays[0]) and torch.equal(st.k, rays[1])
        if not axi:
            continue
        st_p, ok_p = tlc._volume_seed_reference(
            0.9, SEED["incl"], 0.0, SEED["npix"], SEED["rmax"],
            SEED["r_start"], SEED["precision"], axisymmetric=axi,
            device="cpu")
        assert torch.equal(ok, ok_p)
        assert all(torch.equal(getattr(st, f), getattr(st_p, f))
                   for f in ("x", "k", "f", "a", "E", "Q"))
    assert kernel_analytic.LAUNCHES == before


def test_order_axis_is_each_orders_map():
    """equatorial_crossing_map(order=(0, 1)) stacks, bitwise, the plain
    version's map of each order."""
    m = tlc.equatorial_crossing_map(A, INCL, NPIX, RMAX, (0, 1),
                                    device="cpu")
    assert m["pixel_area"] == (2.0 * RMAX / NPIX) ** 2
    assert m["r"].shape == (2, NPIX, NPIX)
    for j, order in enumerate((0, 1)):
        want = tlc.equatorial_crossing_map_reference(A, INCL, NPIX, RMAX,
                                                     order, device="cpu")
        assert _same(tlc.crossing_order(m, j), want)


def test_grad_spin_takes_the_plain_chain():
    """A spin that requires grad: volume_image(engine="scan")'s image and
    its gradient are, bitwise, those of the plain seed under autograd and
    the scan engine (test_torch_volume_scan.py's spot, 8^2, 64 steps)."""
    kw = dict(incl=math.radians(55.0), npix=8, rmax=16.0, r_start=25.0,
              precision=0.03)

    def j(t, r, m, phi):
        return torch.exp(-0.5 * ((r - 8.0) ** 2 + (r * m) ** 2) / 1.5 ** 2)

    def grad(image_fn):
        a = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        im = image_fn(a)
        (g,) = torch.autograd.grad(im.sum(), a)
        return im.detach(), g

    got = grad(lambda a: tlc.volume_image(
        a, emissivity_fn=j, max_steps=64, engine="scan", axisymmetric=True,
        device="cpu", **kw))

    def plain(a):
        st, ok = tlc._volume_seed_reference(
            a, kw["incl"], 0.0, kw["npix"], kw["rmax"], kw["r_start"],
            kw["precision"], axisymmetric=True, device="cpu")
        return tlc._volume_march_scan(st, ok, kw["r_start"], j, n_steps=64)

    want = grad(plain)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1]) != 0.0 and math.isfinite(float(got[1]))
