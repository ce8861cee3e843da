"""Gradients of the port's NT disk image on the CPU: `render_disk_image`
(the plain version `render_disk_image_reference`, which autograd
differentiates through the special functions' rules) against `jax.grad`
and `jax.jvp` of the JAX package's `render_disk_image`, and against
central differences, at 32^2 in f64 with the disk built by `nt_setup(...,
f32_state=False)` in both packages from the same numpy scalars.

Tolerances, and why:
* d(sum image_f)/d(a, incl) against `jax.grad`: 1e-8 relative (the same
  derivative rules on the same f64 chain; the closed-form quartic and its
  polish are differentiated by each framework's autodiff);
* against FD (eps 1e-6) at (0.41, 1.05): rtol 1e-4, as
  `tests/test_disk_render.py:66-84`;
* the per-pixel forward-mode tangent in a, incl and mdot against
  `jax.jvp`: 1e-8 of max |tangent| over the interior pixels (those whose
  hit does not flip within +-1e-4 of the spin, as bench.py's gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from sim5_tpu.disk import nt_setup as jnt_setup
from sim5_tpu.render import render_disk_image as jrender
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import render_disk_image

torch.set_num_threads(2)

NPIX = 32
P0 = dict(a=0.41, incl=1.05, mdot=0.1)


def _t(v):
    return torch.tensor(float(v), dtype=torch.float64)


def _image(a, incl, mdot):
    disk = nt_setup(_t(10.0), a, mdot, _t(0.1), f32_state=False)
    return render_disk_image(disk, incl, NPIX, NPIX)


def _jimage(a, incl, mdot):
    disk = jnt_setup(10.0, a, mdot, 0.1, f32_state=False)
    return jrender(disk, incl, NPIX, NPIX)


def _total(a, incl):
    return _image(a, incl, _t(P0["mdot"]))[0].sum() / 1e26


class TestImageGrad:

    def test_grad_vs_jax_and_fd(self):
        a = _t(P0["a"]).requires_grad_(True)
        incl = _t(P0["incl"]).requires_grad_(True)
        g = [float(v) for v in torch.autograd.grad(_total(a, incl),
                                                   (a, incl))]
        jg = jax.grad(lambda a_, i_: jnp.sum(_jimage(a_, i_, 0.1)[0]) / 1e26,
                      argnums=(0, 1))(jnp.float64(P0["a"]),
                                      jnp.float64(P0["incl"]))
        eps = 1e-6
        with torch.no_grad():
            fd = [(float(_total(_t(P0["a"] + eps), _t(P0["incl"])))
                   - float(_total(_t(P0["a"] - eps), _t(P0["incl"]))))
                  / (2 * eps),
                  (float(_total(_t(P0["a"]), _t(P0["incl"] + eps)))
                   - float(_total(_t(P0["a"]), _t(P0["incl"] - eps))))
                  / (2 * eps)]
        for i in range(2):
            assert np.isfinite(g[i])
            assert abs(g[i] - float(jg[i])) <= 1e-8 * abs(float(jg[i])), (
                i, g[i], float(jg[i]))
            assert np.isclose(g[i], fd[i], rtol=1e-4), (i, g[i], fd[i])

    @pytest.mark.parametrize("col", ["a", "incl", "mdot"])
    def test_pixel_tangent_vs_jax_jvp(self, col):
        p = dict(P0)
        with fwAD.dual_level():
            args = [fwAD.make_dual(_t(p[k]), _t(1.0)) if k == col
                    else _t(p[k]) for k in ("a", "incl", "mdot")]
            out = _image(*args)
            tf = fwAD.unpack_dual(out[0]).tangent.numpy()
            tg = fwAD.unpack_dual(out[1]).tangent
            tg = np.zeros_like(tf) if tg is None else tg.numpy()
        idx = ("a", "incl", "mdot").index(col)
        jprim = [jnp.float64(p[k]) for k in ("a", "incl", "mdot")]
        jtan = [jnp.float64(float(k == idx)) for k in range(3)]
        _, (jf, jgi) = jax.jvp(_jimage, jprim, jtan)
        jf, jgi = np.asarray(jf), np.asarray(jgi)
        # the interior: the hit does not flip within +-1e-4 of the spin
        with torch.no_grad():
            hp = _image(_t(p["a"] + 1e-4), _t(p["incl"]), _t(p["mdot"]))[0]
            hm = _image(_t(p["a"] - 1e-4), _t(p["incl"]), _t(p["mdot"]))[0]
        interior = ((hp > 0) == (hm > 0)).numpy() & np.isfinite(jf)
        assert interior.mean() > 0.9
        for got, want in ((tf, jf), (tg, jgi)):
            scale = np.abs(want[interior]).max()
            if scale == 0.0:   # image_g does not depend on mdot
                assert np.abs(got[interior]).max() == 0.0
                continue
            err = np.abs(got - want)[interior].max() / scale
            assert err <= 1e-8, (col, err)
