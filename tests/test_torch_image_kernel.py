"""The disk image kernel's wrapper (`sim5_tpu_torch.render.kernel_image`),
checked on the CPU.

The kernel (`sim5_tpu_torch/csrc/disk_image.cu`) runs only on the card,
where chip_smoke.py holds it against the plain torch version and the C
goldens.  Here: the wrapper refuses what the kernel does not take before
anything is built, a CPU disk never loads the library, the frame's
scalars are those the plain version uses, and the library is built
without fast math and without FMA contraction.  (test_torch_march_schedule
.py checks the ctypes signatures against every `extern "C"` function.)
"""

import numpy as np
import pytest
import torch

from sim5_tpu_torch import _build
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import image, kernel_image

INCL = float(np.radians(80.0))


def _disk(dtype=torch.float64, **kw):
    return nt_setup(*(torch.tensor(v, dtype=dtype)
                      for v in (10.0, 0.998, 0.1, 0.1)), **kw)


@pytest.fixture
def untouched():
    """Asserts that the test left the library unloaded and no launch
    counted."""
    before = dict(kernel_image.LAUNCHES)
    yield
    assert kernel_image._LIB is None
    assert kernel_image.LAUNCHES == before


class TestWrapper:

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_refuses_cpu_tensors_before_building(self, dtype, untouched):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            kernel_image.render_disk_image_cuda(_disk(dtype), INCL, 8, 8)

    def test_cpu_disk_never_loads_the_library(self, untouched):
        f, g = image.render_disk_image(_disk(), INCL, 8, 4)
        assert f.shape == g.shape == (4, 8) and f.dtype == torch.float64

    @pytest.mark.parametrize("what", ["disk", "incl"])
    def test_refuses_inputs_that_require_grad(self, what, untouched):
        a = torch.tensor(0.998, dtype=torch.float64,
                         requires_grad=what == "disk")
        disk = nt_setup(10.0, a, 0.1, 0.1)
        incl = torch.tensor(INCL, dtype=torch.float64,
                            requires_grad=what == "incl")
        # the kernel takes gradients now (its autograd Function): a CPU
        # disk that requires grad is refused by the device check, before
        # the library is built
        with pytest.raises(ValueError, match="needs a CUDA device"):
            kernel_image.render_disk_image_cuda(disk, incl, 8, 8)
        # the plain version on the CPU stays differentiable
        f, _ = image.render_disk_image(disk, incl, 8, 8)
        assert f.requires_grad

    @pytest.mark.parametrize("rmax", [None, 9.5], ids=["default", "given"])
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_frame_scalars(self, dtype, rmax):
        disk = _disk(dtype)
        frame = kernel_image.frame_scalars(disk, INCL, rmax)
        assert frame.dtype == dtype and frame.shape == (6,)
        want_rmax = (disk.rms - 1e-3 + 8.0 if rmax is None
                     else torch.tensor(rmax, dtype=dtype))
        want = torch.stack([disk.a, torch.tensor(INCL, dtype=dtype), disk.M,
                            disk.mdot, disk.rms, want_rmax])
        torch.testing.assert_close(frame, want, rtol=0, atol=0)
        # the plain version's grid with that rmax is the image's grid
        alpha, _ = image.image_grid(4, 4, frame[5], dtype=dtype,
                                    device="cpu")
        alpha_p, _ = image.image_grid(4, 4, want_rmax, dtype=dtype,
                                      device="cpu")
        torch.testing.assert_close(alpha, alpha_p, rtol=0, atol=0)

    def test_build_flags(self):
        assert "--fmad=false" in kernel_image.NVCC_EXTRA
        assert not any("fast" in f for f in kernel_image.NVCC_EXTRA)
        for name in ("disk_image.cu", "disk_image_jvp.cu"):
            src = (_build.CSRC / name).read_text()
            assert '#include "analytic.cuh"' in src
        assert set(kernel_image.LAUNCHES) == {
            f"{k}<{t}>" for k in ("nt_frames", "nt_image", "nt_reduce")
            for t in ("double", "float")} | {
                f"nt_image<{t}, counted>" for t in ("double", "float")} | {
                f"{k}<{t}, {n}{r}>" for t in ("double", "float")
                for n in (1, 4)
                for k, r in (("nt_frames_jvp", ""), ("nt_image_jvp", ""),
                             ("nt_image_jvp", ", reduce"))}
