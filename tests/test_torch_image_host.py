"""The disk image kernel's device code built for the host: g++ compiles
`sim5_tpu_torch/csrc/analytic.cuh` (its `SIM5_HD` is `inline` outside
nvcc) with a small harness that calls the per-pixel function the kernel
calls, `sim5::nt_pixel`, on a `sim5::Frame` built by the kernel's prologue,
`sim5::make_frame`, from the frames' scalars the wrapper builds
(`kernel_image.frame_scalars`).  That checks the kernel's arithmetic and
control flow, the counters' probes included, without a card.

Frames: 32 x 32 pixels, spins 0.998 / 0.9 / 0.3 at inclinations 80 deg
(bench.py's headline frame), 60 deg (the a = 0 golden's) and 30 deg.
Tolerances, and why:
* f64 against the plain torch version: 1e-12 of each frame's peak,
  identical footprint (the same f64 operations; only libm and the order of
  a few products differ);
* f32 against the f64 plain version: 4e-6 of the peak where both hit
  (bench.py's fast-path gate, set for its headline frame), or where the
  JAX package's own f32 image of the frame is further from f64 than that,
  no further than it (a = 0.3 at 30 deg: the f32 radius inversion's
  floor); at most 2 footprint mismatches a frame.
"""

import ctypes
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from sim5_tpu.disk.nt import nt_setup as jnt_setup
from sim5_tpu.render.image import render_disk_image as jrender
from sim5_tpu_torch import _build
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import image, kernel_image

torch.set_num_threads(2)

NPIX = 32
SPINS = (0.998, 0.9, 0.3)
INCLS = (80.0, 60.0, 30.0)

HARNESS = r"""
#include "analytic.cuh"

// counts, per slot, the pixels a probe saw enter or belong
struct Count {
  long long* c;
  void operator()(int slot, bool p) { c[slot] += p; }
  void classes(int slot, int k, int n) {
    if (k >= 0 && k < n) c[slot + k] += 1;
  }
};

template <typename T>
static void run(const T* frames, int n, int nx, int ny, double aspect, T* f,
                T* g, long long* counts) {
  Count probe{counts};
  for (int k = 0; k < n; ++k) {
    const sim5::Frame<T> d = sim5::make_frame(frames + 6 * k);
    for (int iy = 0; iy < ny; ++iy)
      for (int ix = 0; ix < nx; ++ix) {
        const long long o = ((long long)k * ny + iy) * nx + ix;
        sim5::nt_pixel(d, ix, iy, nx, ny, T(aspect), probe, f[o], g[o]);
      }
  }
}

extern "C" void render(int f64, const void* frames, int n, int nx, int ny,
                       double aspect, void* f, void* g, void* counts) {
  if (f64)
    run(static_cast<const double*>(frames), n, nx, ny, aspect,
        static_cast<double*>(f), static_cast<double*>(g),
        static_cast<long long*>(counts));
  else
    run(static_cast<const float*>(frames), n, nx, ny, aspect,
        static_cast<float*>(f), static_cast<float*>(g),
        static_cast<long long*>(counts));
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The harness built with g++ (no FMA contraction, as nvcc builds the
    kernel with --fmad=false), or a skip where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the host build of the device "
                    "code cannot be made")
    tmp = tmp_path_factory.mktemp("image_host")
    src, lib = tmp / "harness.cpp", tmp / "libharness.so"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(_build.CSRC), "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    dll = ctypes.CDLL(str(lib))
    dll.render.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
                           + [ctypes.c_double] + [ctypes.c_void_p] * 3)
    dll.render.restype = None
    return dll


def _disk(dtype):
    """Every spin at every inclination: 9 frames, and their inclinations."""
    spins = [a for _ in INCLS for a in SPINS]
    incl = torch.tensor([np.radians(i) for i in INCLS for _ in SPINS],
                        dtype=dtype)
    disk = nt_setup(torch.full((len(spins),), 10.0, dtype=dtype),
                    torch.tensor(spins, dtype=dtype),
                    torch.full((len(spins),), 0.1, dtype=dtype),
                    torch.full((len(spins),), 0.1, dtype=dtype))
    return disk, incl


def _host_render(lib, dtype):
    disk, incl = _disk(dtype)
    frames = kernel_image.frame_scalars(disk, incl).contiguous()
    n = frames.shape[0]
    f = torch.empty((n, NPIX, NPIX), dtype=dtype)
    g = torch.empty_like(f)
    counts = torch.zeros(len(kernel_image.COUNTERS), dtype=torch.int64)
    lib.render(int(dtype == torch.float64), frames.data_ptr(), n, NPIX, NPIX,
               1.0, f.data_ptr(), g.data_ptr(), counts.data_ptr())
    return f, g, dict(zip(kernel_image.COUNTERS, counts.tolist()))


def _plain_f64():
    disk, incl = _disk(torch.float64)
    return image.render_disk_image_reference(disk, incl, NPIX, NPIX)


def _f32_err(got, want):
    """|got - want| / want's peak, where both hit, and the footprint
    mismatches."""
    both = (got > 0) & (want > 0)
    return (float((got - want).abs()[both].max() / want.max()),
            int(((got > 0) != (want > 0)).sum()))


@pytest.fixture(scope="module")
def jax_f32_err():
    """Each frame's `_f32_err` of the JAX package's f32 image (its fast
    path, as bench.py renders it: x64 off, nt_setup in f32) against the
    f64 plain version."""
    spins = np.asarray([a for _ in INCLS for a in SPINS], np.float32)
    incls = np.asarray([np.radians(i) for i in INCLS for _ in SPINS],
                       np.float32)
    with jax.enable_x64(False):
        f = jax.jit(lambda ai: jax.lax.map(
            lambda x: jrender(jnt_setup(10.0, x[0], 0.1, 0.1), x[1], NPIX,
                              NPIX)[0], ai))(np.stack([spins, incls], 1))
        f = torch.from_numpy(np.asarray(f, np.float64))
    fp, _ = _plain_f64()
    return [_f32_err(f[k], fp[k]) for k in range(len(spins))]


class TestHostBuild:

    def test_f64_against_the_plain_version(self, host_lib):
        f, g, _ = _host_render(host_lib, torch.float64)
        fp, gp = _plain_f64()
        for k in range(f.shape[0]):
            peak = float(fp[k].max())
            assert peak > 0 and float((fp[k] > 0).double().mean()) > 0.2
            assert torch.equal(f[k] > 0, fp[k] > 0)
            assert float((f[k] - fp[k]).abs().max()) <= 1e-12 * peak
            assert float((g[k] - gp[k]).abs().max()) <= 1e-12

    def test_f32_against_the_f64_plain_version(self, host_lib, jax_f32_err):
        f, _, _ = _host_render(host_lib, torch.float32)
        fp, _ = _plain_f64()
        for k in range(f.shape[0]):
            err, mismatch = _f32_err(f[k].double(), fp[k])
            assert err <= max(4e-6, jax_f32_err[k][0]), (k, err,
                                                          jax_f32_err[k])
            assert mismatch <= 2

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_probes_count_every_pixel_once(self, host_lib, dtype):
        f, g, c = _host_render(host_lib, dtype)
        n = f.numel()
        assert c["pixels"] == n
        assert sum(v for k, v in c.items() if k.startswith("type_")) == n
        assert sum(v for k, v in c.items() if k.startswith("status_")) == n
        assert c["hit0"] + c["hit1"] + c["dark"] == n
        # a hit has g > 0 (its flux is 0 between r_ms and the disk's edge)
        assert c["shade"] == c["hit0"] + c["hit1"] == int((g > 0).sum())
        assert c["rad0"] == c["rad0_RR"] + c["rad0_RC"] + c["rad0_CC"]
        assert c["order1"] == c["rad1_RR"] + c["rad1_RC"] + c["rad1_CC"]
        assert c["hit1"] <= c["order1"] <= c["rad0"] - c["hit0"]
        # every pixel of these frames takes one rf in R_roots
        assert c["rf_R"] == n


def test_counter_slots_match_the_device_source():
    """kernel_image.COUNTERS names sim5::Slot's enumerators, and its
    counter copies and frame words are the kernel's."""
    text = (_build.CSRC / "analytic.cuh").read_text()
    body = re.search(r"enum Slot : int \{(.*?)\};", text, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = [s.strip() for s in body.split(",") if s.strip()]
    assert names[-1] == "kSlots"
    assert len(names) - 1 == len(kernel_image.COUNTERS)
    cu = (_build.CSRC / "disk_image.cu").read_text()
    copies = int(re.search(r"constexpr int kCounterCopies = (\d+);", cu)[1])
    assert copies == kernel_image.COUNTER_COPIES
    words = int(re.search(r"constexpr int kFrameWords = (\d+);", cu)[1])
    assert words == kernel_image.FRAME_WORDS
