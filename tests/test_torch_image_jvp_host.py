"""The disk image's tangent kernel built for the host: g++ compiles
`sim5_tpu_torch/csrc/analytic.cuh` (its `SIM5_HD` is `inline` outside
nvcc) with a small harness that runs what `nt_frames_jvp<T>` and
`nt_image_jvp<T>` (csrc/disk_image.cu) run per frame and per pixel:
`sim5::make_frame` and `sim5::nt_pixel` on `sim5::Dual<T>`, from the
frames' scalars and a tangent of them (`kernel_image.frame_scalars`).
That checks the tangent chain's arithmetic, the derivative rules of rf,
sncndn and the quartic's roots included, without a card.

Frames: 32 x 32 pixels, spins 0.998 / 0.9 / 0.3 at inclinations 80 / 60
/ 30 deg, tangents in a (through rms and the default rmax), incl and
mdot.  Tolerances, and why:
* the dual pixel's values against the plain pixel's: bitwise (the same
  operations on the values; the tangents ride beside them);
* f64 tangents against torch's forward mode through the plain version:
  1e-10 of each frame's peak tangent (the same rules; the implicit root
  rule agrees with autodiff through the closed form and the polish to the
  polish's residual);
* f32 tangents against the f32 plain version's: 1e-3 of the peak (f32
  rounding of both chains, amplified near the ISCO's steep edge);
* the same at 256^2 (the headline frame, tangent in a), held as
  chip_smoke.py's phase 21 holds the card's: on the pixels whose tangent
  the plain f32 chain resolves (within 1e-4 of the f64 tangent's peak),
  1e-5 of that peak, and at most 0.5% of the footprint unresolved (where
  the quartic's complex pair is nearly real, r's f32 tangent is lost in
  both chains);
* the backward's sum, grad_f df + grad_g dg over a frame's pixels (what
  the reduction instance sums a block and a frame), against
  `torch.autograd.grad` through the plain version: 1e-10 relative (f64).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from sim5_tpu_torch import _build
from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import image, kernel_image

torch.set_num_threads(2)

NPIX = 32
FRAMES = ((0.998, 80.0), (0.9, 60.0), (0.3, 30.0))
COLS = ("a", "incl", "mdot")

HARNESS = r"""
#include "analytic.cuh"

template <typename T>
static void run(const T* frames, const T* tangents, int n, int nx, int ny,
                double aspect, T* out) {
  sim5::NoProbe probe;
  const long long px = (long long)n * nx * ny;
  for (int k = 0; k < n; ++k) {
    sim5::Dual<T> s[6];
    for (int i = 0; i < 6; ++i)
      s[i] = sim5::Dual<T>(frames[6 * k + i], tangents[6 * k + i]);
    const sim5::Frame<sim5::Dual<T>> d = sim5::make_frame(s);
    const sim5::Frame<T> p = sim5::make_frame(frames + 6 * k);
    for (int iy = 0; iy < ny; ++iy)
      for (int ix = 0; ix < nx; ++ix) {
        const long long o = ((long long)k * ny + iy) * nx + ix;
        sim5::Dual<T> f, g;
        sim5::nt_pixel(d, ix, iy, nx, ny, T(aspect), probe, f, g);
        T pf, pg;
        sim5::nt_pixel(p, ix, iy, nx, ny, T(aspect), probe, pf, pg);
        out[o] = f.v;
        out[px + o] = g.v;
        out[2 * px + o] = f.d;
        out[3 * px + o] = g.d;
        out[4 * px + o] = pf;
        out[5 * px + o] = pg;
      }
  }
}

extern "C" void render_jvp(int f64, const void* frames, const void* tangents,
                           int n, int nx, int ny, double aspect, void* out) {
  if (f64)
    run(static_cast<const double*>(frames),
        static_cast<const double*>(tangents), n, nx, ny, aspect,
        static_cast<double*>(out));
  else
    run(static_cast<const float*>(frames),
        static_cast<const float*>(tangents), n, nx, ny, aspect,
        static_cast<float*>(out));
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
    tmp = tmp_path_factory.mktemp("image_jvp_host")
    src, lib = tmp / "harness.cpp", tmp / "libharness.so"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(_build.CSRC), "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    dll = ctypes.CDLL(str(lib))
    dll.render_jvp.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                               + [ctypes.c_int] * 3 + [ctypes.c_double,
                                                       ctypes.c_void_p])
    dll.render_jvp.restype = None
    return dll


def _frame(dtype, a0, inc, col):
    """One frame's disk, inclination and mdot with a tangent 1 in `col`
    (forward mode; call inside a dual level)."""
    vals = {"a": a0, "incl": np.radians(inc), "mdot": 0.1}
    args = {k: torch.tensor(v, dtype=dtype) for k, v in vals.items()}
    args[col] = fwAD.make_dual(args[col], torch.ones((), dtype=dtype))
    disk = nt_setup(torch.tensor(10.0, dtype=dtype), args["a"],
                    args["mdot"], torch.tensor(0.1, dtype=dtype))
    return disk, args["incl"]


def _host(lib, dtype, frames, tangents, npix=NPIX):
    n = frames.shape[0]
    out = torch.empty((6, n, npix, npix), dtype=dtype)
    lib.render_jvp(int(dtype == torch.float64), frames.data_ptr(),
                   tangents.data_ptr(), n, npix, npix, 1.0, out.data_ptr())
    return out


def _tangent(t, like):
    return torch.zeros_like(like) if t is None else t


def _run(lib, dtype, a0, inc, col, npix=NPIX):
    """(host values and tangents, plain forward mode's) of one frame."""
    with fwAD.dual_level():
        disk, incl = _frame(dtype, a0, inc, col)
        fr = kernel_image.frame_scalars(disk, incl).reshape(1, 6)
        prim, tan = fwAD.unpack_dual(fr)
        frames = prim.contiguous().clone()
        tangents = _tangent(tan, prim).contiguous().clone()
        f, g = image.render_disk_image_reference(disk, incl, npix, npix)
        pf, tf = fwAD.unpack_dual(f)
        pg, tg = fwAD.unpack_dual(g)
        plain = (pf.clone(), pg.clone(), _tangent(tf, pf).clone(),
                 _tangent(tg, pg).clone())
    return _host(lib, dtype, frames, tangents, npix), plain


class TestTangentPixel:

    @pytest.mark.parametrize("col", COLS)
    @pytest.mark.parametrize("frame", FRAMES, ids=["a998", "a9", "a3"])
    def test_f64_tangents_vs_forward_mode(self, host_lib, frame, col):
        out, (pf, pg, tf, tg) = _run(host_lib, torch.float64, *frame, col)
        # the values are the plain pixel's, bit for bit
        assert torch.equal(out[0], out[4]) and torch.equal(out[1], out[5])
        assert float((out[0, 0] - pf).abs().max()) <= 1e-12 * float(pf.max())
        for got, want in ((out[2, 0], tf), (out[3, 0], tg)):
            assert bool(torch.isfinite(got).all())
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-10 * scale, (frame, col, err / max(scale, 1e-300))

    @pytest.mark.parametrize("col", COLS)
    def test_f32_tangents_vs_forward_mode(self, host_lib, col):
        out, (_, _, tf, tg) = _run(host_lib, torch.float32, *FRAMES[0], col)
        assert torch.equal(out[0], out[4]) and torch.equal(out[1], out[5])
        for got, want in ((out[2, 0], tf), (out[3, 0], tg)):
            assert bool(torch.isfinite(got).all())
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-3 * scale

    def test_f32_tangents_on_resolved_pixels(self, host_lib):
        out, (pf, _, tf, _) = _run(host_lib, torch.float32, *FRAMES[0], "a",
                                   npix=256)
        _, (pf64, _, t64, _) = _run(host_lib, torch.float64, *FRAMES[0],
                                    "a", npix=256)
        tk, tf = out[2, 0].double(), tf.double()
        ok = (((out[0, 0] > 0) == (pf > 0)) & ((pf64 > 0) == (pf > 0))
              & torch.isfinite(tk) & torch.isfinite(tf))
        peak = float(t64[ok].abs().max())
        resolved = ok & ((tf - t64).abs() <= 1e-4 * peak)
        assert float((ok & ~resolved).sum()) <= 0.005 * float(ok.sum())
        assert float((tk - tf)[resolved].abs().max()) <= 1e-5 * peak

    def test_backward_sum_vs_autograd(self, host_lib):
        """sum over the pixels of grad_f df + grad_g dg, one tangent a
        column, against the plain version's reverse mode in the six frame
        columns (a, incl, M, mdot, rms, rmax)."""
        rng = np.random.default_rng(9)
        a0, inc = FRAMES[1]
        gf = torch.tensor(rng.standard_normal((NPIX, NPIX)) * 1e-25)
        gg = torch.tensor(rng.standard_normal((NPIX, NPIX)))
        disk = nt_setup(*(torch.tensor(v, dtype=torch.float64)
                          for v in (10.0, a0, 0.1, 0.1)))
        frames = kernel_image.frame_scalars(disk, np.radians(inc))
        cols = [v.clone().requires_grad_(True) for v in frames]
        a, incl, M, mdot, rms, rmax = cols
        f, g = image.render_disk_image_reference(
            disk._replace(a=a, M=M, mdot=mdot, rms=rms), incl, NPIX, NPIX,
            rmax=rmax)
        want = torch.autograd.grad((gf * f).sum() + (gg * g).sum(), cols)
        frames = frames.reshape(1, 6).contiguous()
        for c in range(6):
            tangent = torch.zeros_like(frames)
            tangent[0, c] = 1.0
            out = _host(host_lib, torch.float64, frames, tangent)
            got = float((gf * out[2, 0]).sum() + (gg * out[3, 0]).sum())
            w = float(want[c])
            assert abs(got - w) <= 1e-10 * abs(w), (c, got, w)


class TestFunctionWiring:
    """`kernel_image._NTImage` on CPU tensors with its launches replaced by
    recorders: which columns the backward asks the kernel for, where their
    sums land, and the tangent matrix forward mode hands the kernel.  (The
    launches themselves run only on the card, in chip_smoke.py phase 21.)"""

    @pytest.fixture
    def recorded(self, monkeypatch):
        calls = {}

        def launch(frames, f, g, counters=None, work=None):
            f.fill_(1.0)
            g.fill_(2.0)

        def backward(frames, grad_f, grad_g, columns):
            calls["columns"] = list(columns)
            n = frames.shape[0]
            out = torch.zeros((n, 6), dtype=frames.dtype)
            for c in columns:
                out[:, c] = (grad_f.sum((1, 2)) + grad_g.sum((1, 2))
                             + 10.0 * c + torch.arange(n, dtype=frames.dtype))
            return out

        def launch_jvp(frames, tangent, nx, ny):
            calls["tangent"] = tangent.clone()
            n = frames.shape[0]
            df = tangent[:, 0, None, None].expand(n, ny, nx).clone()
            dg = tangent[:, 1, None, None].expand(n, ny, nx).clone()
            return None, None, df, dg

        monkeypatch.setattr(kernel_image, "_launch", launch)
        monkeypatch.setattr(kernel_image, "_backward", backward)
        monkeypatch.setattr(kernel_image, "_launch_jvp", launch_jvp)
        return calls

    def test_backward_asks_only_for_columns_that_need_grad(self, recorded):
        n = 3
        cols = [torch.full((n,), 0.5 + k, dtype=torch.float64,
                           requires_grad=k in (0, 1, 4)) for k in range(6)]
        f, g = kernel_image._NTImage.apply(*cols, 4, 2, False)
        assert f.shape == g.shape == (n, 2, 4)
        leaves = [cols[k] for k in (0, 1, 4)]
        grads = torch.autograd.grad((3.0 * f).sum() + g.sum(), leaves)
        assert recorded["columns"] == [0, 1, 4]
        for k, gr in zip((0, 1, 4), grads):
            want = 4 * 8 + 10.0 * k + torch.arange(n, dtype=torch.float64)
            torch.testing.assert_close(gr, want, rtol=0, atol=0)

    def test_forward_mode_hands_over_the_tangent_matrix(self, recorded):
        n = 2
        with fwAD.dual_level():
            cols = [torch.full((n,), 0.5 + k, dtype=torch.float64)
                    for k in range(6)]
            cols[0] = fwAD.make_dual(cols[0], torch.tensor([1.0, 2.0],
                                                           dtype=torch.float64))
            cols[5] = fwAD.make_dual(cols[5], torch.tensor([3.0, 4.0],
                                                           dtype=torch.float64))
            f, g = kernel_image._NTImage.apply(*cols, 4, 2, False)
            tf = fwAD.unpack_dual(f).tangent
        want = torch.zeros((n, 6), dtype=torch.float64)
        want[:, 0] = torch.tensor([1.0, 2.0])
        want[:, 5] = torch.tensor([3.0, 4.0])
        torch.testing.assert_close(recorded["tangent"], want, rtol=0, atol=0)
        assert tf.shape == (n, 2, 4)
        torch.testing.assert_close(tf[:, 0, 0], want[:, 0], rtol=0, atol=0)
