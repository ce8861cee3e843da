"""The disk image's tangent kernel built for the host: g++ compiles
`sim5_tpu_torch/csrc/analytic.cuh` (its `SIM5_HD` is `inline` outside
nvcc) with a small harness that runs what `nt_frames_jvp<T, K>` and
`nt_image_jvp<T, K>` (csrc/disk_image_jvp.cu) run per frame and per
pixel: `sim5::make_frame` and `sim5::nt_pixel` on `sim5::Dual<T, K>`,
from the frames' scalars and K tangents of them
(`kernel_image.frame_scalars`), for K = 1 and the backward's K = 4 in one
build; the four-slot pixel runs its geodesic on the first three slots
and only its shading on all four, as the kernel's backward instance does.
That checks the tangent chain's arithmetic, the derivative rules of rf,
sncndn and the quartic's roots included, without a card.

Frames: 32 x 32 pixels, spins 0.998 / 0.9 / 0.3 at inclinations 80 / 60
/ 30 deg, tangents in a (through rms and the default rmax), incl and
mdot.  Tolerances, and why:
* the dual pixel's values against the plain pixel's: bitwise (the same
  operations on the values; the tangents ride beside them);
* each slot of the four-slot pass (a, incl, rmax through the geodesic,
  rms in the shading's last slot: the backward's columns) against the
  one-slot pass seeded with that column: bitwise (each slot runs the
  one-slot arithmetic; the rules' coefficients are computed once from the
  values; the one-slot pass carries rms's zero tangent through the
  geodesic, which the four-slot one starts at the shading, and the bits
  agree there too);
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
* the backward's sums of the four-slot pass, grad_f df_j + grad_g dg_j
  over a frame's pixels (what the reduction instance sums a block and a
  frame), and M's and mdot's from the sum of grad_f f, against
  `torch.autograd.grad` through the plain version in all six frame
  columns: 1e-10 relative (f64).
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

# the backward's slot count, and its columns by slot: the geodesic's,
# then rms in the shading's slot
K = 4
SEEDS = (*kernel_image.CHAIN_COLUMNS, kernel_image.RMS_COLUMN)

HARNESS = r"""
#include "analytic.cuh"

// out: (2 K + 4, n, ny, nx): f, g, df_0..K-1, dg_0..K-1, then the plain
// pixel's f and g.  The geodesic carries the first C slots, the shading
// all K.
template <typename T, int C, int K>
static void run(const T* frames, const T* tangents, int n, int nx, int ny,
                double aspect, T* out) {
  sim5::NoProbe probe;
  const long long px = (long long)n * nx * ny;
  for (int k = 0; k < n; ++k) {
    sim5::Dual<T, K> s[6];
    sim5::Dual<T, C> c[6];
    for (int i = 0; i < 6; ++i) {
      s[i].v = c[i].v = frames[6 * k + i];
      for (int j = 0; j < K; ++j) s[i].d[j] = tangents[(6 * k + i) * K + j];
      for (int j = 0; j < C; ++j) c[i].d[j] = s[i].d[j];
    }
    const sim5::Frame<sim5::Dual<T, K>> d = sim5::make_frame(s);
    const sim5::Frame<sim5::Dual<T, C>> dc = sim5::make_frame(c);
    const sim5::Frame<T> p = sim5::make_frame(frames + 6 * k);
    for (int iy = 0; iy < ny; ++iy)
      for (int ix = 0; ix < nx; ++ix) {
        const long long o = ((long long)k * ny + iy) * nx + ix;
        sim5::Dual<T, K> f, g;
        if (C < K)
          sim5::nt_pixel(dc, d, ix, iy, nx, ny, T(aspect), probe, f, g);
        else
          sim5::nt_pixel(d, ix, iy, nx, ny, T(aspect), probe, f, g);
        T pf, pg;
        sim5::nt_pixel(p, ix, iy, nx, ny, T(aspect), probe, pf, pg);
        out[o] = f.v;
        out[px + o] = g.v;
        for (int j = 0; j < K; ++j) {
          out[(2 + j) * px + o] = f.d[j];
          out[(2 + K + j) * px + o] = g.d[j];
        }
        out[(2 + 2 * K) * px + o] = pf;
        out[(3 + 2 * K) * px + o] = pg;
      }
  }
}

template <typename T>
static void run_k(int K, const void* frames, const void* tangents, int n,
                  int nx, int ny, double aspect, void* out) {
  const T* fr = static_cast<const T*>(frames);
  const T* tn = static_cast<const T*>(tangents);
  if (K == 1) run<T, 1, 1>(fr, tn, n, nx, ny, aspect, static_cast<T*>(out));
  if (K == 4) run<T, 3, 4>(fr, tn, n, nx, ny, aspect, static_cast<T*>(out));
}

extern "C" void render_jvp(int f64, int K, const void* frames,
                           const void* tangents, int n, int nx, int ny,
                           double aspect, void* out) {
  if (f64)
    run_k<double>(K, frames, tangents, n, nx, ny, aspect, out);
  else
    run_k<float>(K, frames, tangents, n, nx, ny, aspect, out);
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
    dll.render_jvp.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
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
    """The harness on frames (n, 6) and tangents (n, 6) (K = 1) or (n, 6,
    K): (2 K + 4, n, npix, npix), the planes of `run`."""
    n = frames.shape[0]
    k = 1 if tangents.dim() == 2 else tangents.shape[2]
    out = torch.empty((2 * k + 4, n, npix, npix), dtype=dtype)
    lib.render_jvp(int(dtype == torch.float64), k, frames.data_ptr(),
                   tangents.contiguous().data_ptr(), n, npix, npix, 1.0,
                   out.data_ptr())
    return out


def _frames(dtype, frame):
    """The (1, 6) scalars of one of FRAMES in `dtype`."""
    a0, inc = frame
    disk = nt_setup(*(torch.tensor(v, dtype=dtype)
                      for v in (10.0, a0, 0.1, 0.1)))
    return kernel_image.frame_scalars(disk, np.radians(inc)).reshape(
        1, 6).contiguous()


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

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                             ids=["f64", "f32"])
    @pytest.mark.parametrize("frame", FRAMES, ids=["a998", "a9", "a3"])
    def test_slots_bitwise_one_slot_passes(self, host_lib, frame, dtype):
        """The four-slot pass seeded with the backward's columns: its
        values and each slot's tangents are the bits of the one-slot
        pass seeded with that column."""
        frames = _frames(dtype, frame)
        tangent = torch.zeros((1, 6, K), dtype=dtype)
        for j, c in enumerate(SEEDS):
            tangent[0, c, j] = 1.0
        out = _host(host_lib, dtype, frames, tangent)
        assert bool((out[2:2 + K].abs().amax((1, 2, 3)) > 0).all())
        it = torch.int64 if dtype == torch.float64 else torch.int32
        for j, c in enumerate(SEEDS):
            one = torch.zeros((1, 6), dtype=dtype)
            one[0, c] = 1.0
            ref = _host(host_lib, dtype, frames, one)
            for got, want in ((out[:2], ref[:2]), (out[2 + j], ref[2]),
                              (out[2 + K + j], ref[3])):
                assert torch.equal(got.view(it), want.view(it)), c

    def test_backward_sum_vs_autograd(self, host_lib):
        """The backward's sums from one four-slot pass (a, incl, rmax, rms:
        sum over the pixels of grad_f df_j + grad_g dg_j; M and mdot: the
        sum of grad_f f over -M and over mdot),
        against the plain version's reverse mode in the six frame columns
        (a, incl, M, mdot, rms, rmax)."""
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
        tangent = torch.zeros((1, 6, K), dtype=torch.float64)
        for j, c in enumerate(SEEDS):
            tangent[0, c, j] = 1.0
        out = _host(host_lib, torch.float64, frames, tangent)
        got = {c: float((gf * out[2 + j, 0]).sum()
                        + (gg * out[2 + K + j, 0]).sum())
               for j, c in enumerate(SEEDS)}
        f_sum = float((gf * out[0, 0]).sum())
        got[2] = -f_sum / float(frames[0, 2])
        got[3] = f_sum / float(frames[0, 3])
        for c in range(6):
            w = float(want[c])
            assert abs(got[c] - w) <= 1e-10 * abs(w), (c, got[c], w)


class TestFunctionWiring:
    """`kernel_image._NTImage` on CPU tensors with its launches replaced by
    recorders: the tangent matrix the backward's one launch gets (a slot
    for each chain column that needs grad), where its sums land, M's and
    mdot's gradient from the sum of grad_f f, and the tangent matrix
    forward mode hands the kernel.  (The launches themselves run only on
    the card, in chip_smoke.py phase 21.)"""

    @pytest.fixture
    def recorded(self, monkeypatch):
        calls = {"vjp": []}

        def launch(frames, f, g, counters=None, work=None, row0=0,
                   ny=None):
            f.fill_(1.0)
            g.fill_(2.0)

        def launch_vjp(frames, tangent, grad_f, grad_g, row0=0, ny=None):
            calls["vjp"].append(tangent.clone())
            n, _, k = tangent.shape
            out = torch.zeros((n, k + 1), dtype=frames.dtype)
            for j in range(k):
                out[:, j] = (grad_f.sum((1, 2)) + grad_g.sum((1, 2))
                             + 10.0 * j + torch.arange(n, dtype=frames.dtype))
            out[:, k] = 100.0 + torch.arange(n, dtype=frames.dtype)
            return out

        def launch_jvp(frames, tangent, nx, rows, row0=0, ny=None):
            calls["tangent"] = tangent.clone()
            n, _, k = tangent.shape
            df = tangent[:, 0, :, None, None].expand(n, k, rows, nx).clone()
            dg = tangent[:, 1, :, None, None].expand(n, k, rows, nx).clone()
            return None, None, df, dg

        monkeypatch.setattr(kernel_image, "_launch", launch)
        monkeypatch.setattr(kernel_image, "_launch_vjp", launch_vjp)
        monkeypatch.setattr(kernel_image, "_launch_jvp", launch_jvp)
        return calls

    def test_backward_asks_only_for_columns_that_need_grad(self, recorded):
        """a, incl, mdot and rms need grad: one launch of the four-slot
        instance, slots a, incl, a zero slot (rmax) and rms; mdot from the
        sum of grad_f f."""
        n = 3
        need = (0, 1, 3, 4)
        cols = [torch.full((n,), 0.5 + k, dtype=torch.float64,
                           requires_grad=k in need) for k in range(6)]
        f, g = kernel_image._NTImage.apply(*cols, 4, 2, False)
        assert f.shape == g.shape == (n, 2, 4)
        leaves = [cols[k] for k in need]
        grads = torch.autograd.grad((3.0 * f).sum() + g.sum(), leaves)
        assert len(recorded["vjp"]) == 1
        want_t = torch.zeros((n, 6, K), dtype=torch.float64)
        for j, c in ((0, 0), (1, 1), (3, 4)):
            want_t[:, c, j] = 1.0
        torch.testing.assert_close(recorded["vjp"][0], want_t, rtol=0,
                                   atol=0)
        ar = torch.arange(n, dtype=torch.float64)
        want = {0: 4 * 8 + ar, 1: 4 * 8 + 10.0 + ar, 4: 4 * 8 + 30.0 + ar,
                3: (100.0 + ar) / 3.5}
        for k, gr in zip(need, grads):
            torch.testing.assert_close(gr, want[k], rtol=0, atol=0)

    @pytest.mark.parametrize("columns, launch", [
        ((0, 1, 3, 4, 5), (4, [0, 1, 5, 4])),
        ((0, 1, 2, 3, 4, 5), (4, [0, 1, 5, 4])),
        ((1,), (1, [1])),
        ((4,), (1, [4])),
        ((1, 5), (4, [1, 5, None, None])),
        ((0, 4), (4, [0, None, None, 4])),
        ((2, 3), (1, [None])),
    ])
    def test_backward_launch(self, columns, launch):
        """The launch of a backward: the four-slot instance for two or
        more of a, incl, rmax and rms (the geodesic's columns in its first
        three slots, rms in its last), the one-slot one for one of them,
        or with a zero seed where only M or mdot need grad."""
        assert kernel_image.backward_launch(list(columns)) == launch

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
        want = torch.zeros((n, 6, 1), dtype=torch.float64)
        want[:, 0, 0] = torch.tensor([1.0, 2.0])
        want[:, 5, 0] = torch.tensor([3.0, 4.0])
        torch.testing.assert_close(recorded["tangent"], want, rtol=0, atol=0)
        assert tf.shape == (n, 2, 4)
        torch.testing.assert_close(tf[:, 0, 0], want[:, 0, 0], rtol=0,
                                   atol=0)
