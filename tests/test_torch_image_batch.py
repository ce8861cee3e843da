"""A batch of disk image frames (`sim5_tpu_torch.render`, on the CPU): a
disk of (n,) tensors, `nt_setup` over n spins, renders n frames at once,
the port's form of `jax.vmap` / `jax.lax.map` over the JAX package's
`render_disk_image`, as bench.py's spin sweep drives it.

Tolerances, and why:
* f64 batch against JAX under `jax.lax.map` over the same spins: 1e-12 of
  each frame's peak with an identical footprint (the same f64 operations
  in another order of fusion, as test_torch_image.py's single frame);
* the batch against single-frame calls, and a batch's frame scalars
  against the single frames': bitwise (elementwise ops, frame by frame).

The kernel's own batch runs only on the card, where chip_smoke.py holds
every frame of a 64-frame launch bitwise equal to its single-frame launch;
here the wrapper's refusals come before anything is built.
"""

import jax
import numpy as np
import pytest
import torch

from sim5_tpu.render.image import render_disk_image_jit as jrender_jit
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import image, kernel_image

torch.set_num_threads(2)

SPINS = (0.998, 0.9, 0.3)
INCL = float(np.radians(80.0))
NX, NY = 24, 16


def _disk(dtype, spins=SPINS):
    """nt_setup over a vector of spins (f32_state, the default)."""
    t = torch.tensor(spins, dtype=dtype)
    return nt_setup(torch.tensor(10.0, dtype=dtype), t,
                    torch.tensor(0.1, dtype=dtype),
                    torch.tensor(0.1, dtype=dtype), f32_state=True)


def _one(dtype, a):
    return nt_setup(*(torch.tensor(v, dtype=dtype) for v in (10.0, a, 0.1,
                                                            0.1)))


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.fixture
def untouched():
    """Asserts that the test left the library unloaded and no launch
    counted."""
    before = dict(kernel_image.LAUNCHES)
    yield
    assert kernel_image._LIB is None
    assert kernel_image.LAUNCHES == before


class TestBatchAgainstJax:

    def test_f64_against_lax_map(self):
        spins = np.asarray(SPINS, np.float64)
        jf, jg = (np.asarray(v) for v in jax.lax.map(
            lambda a: jrender_jit(10.0, a, 0.1, 0.1, INCL, NX, NY), spins))
        tf, tg = image.render_disk_image(_disk(torch.float64), INCL, NX, NY)
        assert tf.shape == tg.shape == (3, NY, NX) == jf.shape
        tf, tg = tf.numpy(), tg.numpy()
        for k in range(len(SPINS)):
            peak = jf[k].max()
            assert peak > 0 and (jf[k] > 0).mean() > 0.2
            np.testing.assert_array_equal(tf[k] > 0, jf[k] > 0)
            assert np.abs(tf[k] - jf[k]).max() <= 1e-12 * peak
            assert np.abs(tg[k] - jg[k]).max() <= 1e-12


class TestBatchAgainstSingleFrames:

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_batch_equals_single_frames_bitwise(self, dtype):
        f, g = image.render_disk_image(_disk(dtype), INCL, NX, NY)
        assert f.shape == (3, NY, NX) and f.dtype == dtype
        for k, a in enumerate(SPINS):
            fk, gk = image.render_disk_image(_one(dtype, a), INCL, NX, NY)
            assert fk.shape == (NY, NX)
            assert torch.equal(_bits(f[k]), _bits(fk))
            assert torch.equal(_bits(g[k]), _bits(gk))

    def test_one_inclination_a_frame(self):
        incl = torch.tensor([1.4, 1.05, 0.6], dtype=torch.float64)
        f, _ = image.render_disk_image_reference(_disk(torch.float64), incl,
                                                 NX, NY, rmax=9.0)
        for k, a in enumerate(SPINS):
            fk, _ = image.render_disk_image_reference(
                _one(torch.float64, a), float(incl[k]), NX, NY, rmax=9.0)
            assert torch.equal(_bits(f[k]), _bits(fk))

    @pytest.mark.parametrize("rmax", [None, 9.5], ids=["default", "given"])
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_frame_scalars(self, dtype, rmax):
        frames = kernel_image.frame_scalars(_disk(dtype), INCL, rmax)
        assert frames.shape == (3, 6) and frames.dtype == dtype
        for k, a in enumerate(SPINS):
            one = kernel_image.frame_scalars(_one(dtype, a), INCL, rmax)
            assert one.shape == (6,)
            assert torch.equal(_bits(frames[k]), _bits(one))


class TestWrapperRefusesBatches:

    def test_mismatched_disk_fields(self, untouched):
        disk = _disk(torch.float64)._replace(
            M=torch.tensor([10.0, 10.0], dtype=torch.float64))
        with pytest.raises(ValueError, match="batch shapes"):
            kernel_image.render_disk_image_cuda(disk, INCL, 8, 8)

    def test_inclinations_not_one_a_frame(self, untouched):
        incl = torch.tensor([1.0, 1.2], dtype=torch.float64)
        with pytest.raises(ValueError, match="batch shapes"):
            kernel_image.render_disk_image_cuda(_disk(torch.float64), incl,
                                                8, 8)

    def test_two_dimensional_batch(self, untouched):
        disk = _disk(torch.float64)
        incl = torch.full((2, 1), INCL, dtype=torch.float64)
        with pytest.raises(ValueError, match="one dimension"):
            kernel_image.render_disk_image_cuda(disk, incl, 8, 8)

    def test_cpu_batch_never_loads_the_library(self, untouched):
        f, g = image.render_disk_image(_disk(torch.float32), INCL, 8, 4)
        assert f.shape == g.shape == (3, 4, 8)
