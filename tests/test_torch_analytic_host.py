"""The crossing-map and volume-seed kernels' device code built for the
host: g++ compiles `sim5_tpu_torch/csrc/azimuth.cuh` (its `SIM5_HD` and
`SIM5_NI` are `inline` outside nvcc) with a small harness that calls the
per-pixel functions the kernels call (`sim5::crossing_pixel`,
`sim5::seed_pixel`), the geodesic functions they reach (P_int,
position_pol, momentum, position_azm, timedelay, timedelay_full) on
geodesics made by the plain version, and each special function and Byrd &
Friedman integral one argument tuple a lane.  That checks the kernels'
arithmetic and control flow without a card.  Each harness function takes
the depth policy of its Carlson chains: `FixedDepth` (the plain chains'
16 levels) and `AdaptiveDepth` (Carlson's stopping rule, which the
kernels run) meet the same references and gates, each in a test of its
own (`*_adaptive`).

Cases (32^2 seeds and maps):
* example 07's spot (a = 0.5, 70 deg, rmax 17.5, r_start 40) and a = 0.9
  at 70 deg with rmax 2.5, whose pixels are nearly all inside the shadow:
  RR, RC, CC and vortical (q < 0) lanes occur (asserted).  An observer at
  infinity never sets up a bound RR_BH ray (R_roots' band test needs the
  observer between r3 and r2), so the RR_BH lanes come from the geodesic
  batch below;
* the geodesic batch of test_torch_azimuth.py: RR and RC rays of an image
  grid, CC and vortical rays near an image's centre, and RR_BH rays from
  source points inside the bound band (the port's geodesic_init_src),
  each at four positions P;
* the C goldens geod.txt (phi) and timedelay.txt (the radial time), from
  the harness's own geodesic_init_inf, at phase 13's gates;
* the JAX package's functions on the CPU for the seed (its three stages)
  and the crossing map at 32^2, one program each stage (TestAgainstJax).

Tolerances, and why:
* r, g, P_int, position_pol: 1e-12 relative (same f64 operations; libm
  and the order of a few products differ); the seed's r0, m0 and k:
  `seed_bounds` (copied from chip_smoke.py), 1e-12 of each field's scale
  (m0 and k's components pass through 0) and, where k^r = sqrt(R) / S or
  k^theta = sqrt(M) / S nears a turning point or m0 the equator, the
  square root's and the fold's own spread (on the spot's 512^2 seed one
  ulp of the inclination moves k^theta by 1.6e-9 of its scale);
  for a crossing far out, r and its delay also `far_bound`: there P_inf
  - P ~ 1/r, so dr ~ r^2 dP with dP 32 ulps of Tpp + |Tip| (an order-1
  crossing of example 07's map at 192^2 lies at r ~ 1e5, where one ulp of
  the inclination moves r by 2.3e-11 relative);
* phi and the delay: the per-pixel bounds `phi_bound` / `time_bound`
  (copied from chip_smoke.py): two f64 evaluations of the theta term
  differ by about sqrt(eps) times its turning-point factor, and the delay
  from R_FAR by up to 1e-10 R_FAR (PERF.md §6, PR 6);
* hit and valid sets: equal;
* the special functions: 1e-13 relative where the value is well
  conditioned (each a chain of the same operations);
* the f32 seed against the f64 plain version: no further than 2x the
  plain f32 version's own distance from it (+ 1e-6 of the field's
  scale), and valid sets differing on at most 1% of the pixels: the f32
  geometry's rounding (the quartic's roots, the inversions at r = 40)
  sets the distance, which the kernel shares with the plain f32 chain but
  for libm's ulps.
"""

import ctypes
import functools
import math
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sim5_tpu_torch import _build
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch import special as tsp
from sim5_tpu_torch.core import photon_momentum, r_ms
from sim5_tpu_torch.geodesic import analytic as tan
from sim5_tpu_torch.render import kernel_analytic
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)

NPIX = 32
SPOT = dict(a=0.5, incl=math.radians(70.0), rmax=17.5, r_start=40.0)
SHADOW = dict(a=0.9, incl=math.radians(70.0), rmax=2.5, r_start=40.0)
EPS64 = float(np.finfo(np.float64).eps)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"

HARNESS = r"""
#include "azimuth.cuh"

using sim5::Geod;

static sim5::GaussRule rule(const double* g) {
  sim5::GaussRule q;
  for (int k = 0; k < 16; ++k) {
    q.x[k] = g[k];
    q.w[k] = g[16 + k];
  }
  for (int k = 0; k < 7; ++k) q.edges[k] = g[32 + k];
  return q;
}

// Each function takes the depth policy of its Carlson chains first:
// adaptive != 0 sim5::AdaptiveDepth (the kernels'), else sim5::FixedDepth.
#define SIM5_POLICY(adaptive, CALL)                                        \
  do {                                                                     \
    if (adaptive) {                                                        \
      using D = sim5::AdaptiveDepth;                                       \
      CALL;                                                                \
    } else {                                                               \
      using D = sim5::FixedDepth;                                          \
      CALL;                                                                \
    }                                                                      \
  } while (0)

template <typename D>
static void crossing_t(double a, double incl, double rmax, double rms, int n,
                       int order, const double* gauss, double* r, double* phi,
                       double* g, double* dt, unsigned char* hit) {
  const sim5::GaussRule q = rule(gauss);
  const double c = sim5::Cos(incl), s = sim5::Sin(incl);
  for (int i = 0; i < n * n; ++i) {
    bool h;
    sim5::crossing_pixel<double, D>(a, incl, c, s, rmax, rms, order, i % n,
                                    i / n, n, q, r[i], phi[i], g[i], dt[i], h);
    hit[i] = h;
  }
}

extern "C" void crossing(int adaptive, double a, double incl, double rmax,
                         double rms, int n, int order, const double* gauss,
                         double* r, double* phi, double* g, double* dt,
                         unsigned char* hit) {
  SIM5_POLICY(adaptive, crossing_t<D>(a, incl, rmax, rms, n, order, gauss, r,
                                      phi, g, dt, hit));
}

template <typename T, bool kAzm, typename D>
static void seed_t(double a, double incl, double rmax, double r_start,
                   double t0, int n, const double* gauss, T* x0, T* k,
                   unsigned char* ok) {
  const sim5::GaussRule q = rule(gauss);
  const T i_ = T(incl);
  const T c = sim5::Cos(i_), s = sim5::Sin(i_);
  for (int i = 0; i < n * n; ++i) {
    bool v;
    sim5::seed_pixel<T, kAzm, D>(T(a), i_, c, s, T(rmax), T(r_start), T(t0),
                                 i % n, i / n, n, q, x0 + 4 * i, k + 4 * i, v);
    ok[i] = v;
  }
}

template <typename D>
static void seed_d(int f64, int azm, double a, double incl, double rmax,
                   double r_start, double t0, int n, const double* gauss,
                   void* x0, void* k, unsigned char* ok) {
  if (f64) {
    double *x = static_cast<double*>(x0), *kk = static_cast<double*>(k);
    if (azm) seed_t<double, true, D>(a, incl, rmax, r_start, t0, n, gauss, x, kk, ok);
    else seed_t<double, false, D>(a, incl, rmax, r_start, t0, n, gauss, x, kk, ok);
  } else {
    float *x = static_cast<float*>(x0), *kk = static_cast<float*>(k);
    if (azm) seed_t<float, true, D>(a, incl, rmax, r_start, t0, n, gauss, x, kk, ok);
    else seed_t<float, false, D>(a, incl, rmax, r_start, t0, n, gauss, x, kk, ok);
  }
}

extern "C" void seed(int adaptive, int f64, int azm, double a, double incl,
                     double rmax, double r_start, double t0, int n,
                     const double* gauss, void* x0, void* k,
                     unsigned char* ok) {
  SIM5_POLICY(adaptive, seed_d<D>(f64, azm, a, incl, rmax, r_start, t0, n,
                                  gauss, x0, k, ok));
}

// a geodesic from the plain version's fields: 27 doubles (a, alpha, beta,
// incl, cos_i, l, q, rr[4], ri[4], rr_lo[4], m2p, m2m, mm, mK, rp, Rpc,
// Tpp, Tip) and 3 ints (nrr, gtype, status)
static Geod<double> geod_of(const double* f, const int* k) {
  Geod<double> g;
  g.a = f[0]; g.alpha = f[1]; g.beta = f[2]; g.incl = f[3]; g.cos_i = f[4];
  g.l = f[5]; g.q = f[6];
  for (int j = 0; j < 4; ++j) {
    g.rr[j] = f[7 + j]; g.ri[j] = f[11 + j]; g.rr_lo[j] = f[15 + j];
  }
  g.m2p = f[19]; g.m2m = f[20]; g.mm = f[21]; g.mK = f[22]; g.rp = f[23];
  g.Rpc = f[24]; g.Tpp = f[25]; g.Tip = f[26];
  g.nrr = k[0]; g.gtype = k[1]; g.status = k[2];
  return g;
}

// per lane: position_azm(r, P), timedelay_full(P, r, P2, r2),
// timedelay(P, r, P2, r2), P_int(r, 0), P_int(r, 1), position_pol(P),
// momentum(P, r, position_pol(P)) (4)
template <typename D>
static void geod_t(int n, const double* f, const int* ints, const double* P,
                   const double* r, const double* P2, const double* r2,
                   const double* gauss, double* out) {
  const sim5::GaussRule q = rule(gauss);
  for (int i = 0; i < n; ++i) {
    const Geod<double> g = geod_of(f + 27 * i, ints + 3 * i);
    double* o = out + 10 * i;
    o[0] = sim5::position_azm<double, D>(g, r[i], P[i], q);
    o[1] = sim5::timedelay_full<double, D>(g, P[i], r[i], P2[i], r2[i], q);
    o[2] = sim5::timedelay<double, D>(g, P[i], r[i], P2[i], r2[i], q);
    o[3] = sim5::P_int(g, r[i], 0);
    o[4] = sim5::P_int(g, r[i], 1);
    o[5] = sim5::position_pol(g, P[i]);
    sim5::momentum(g, P[i], r[i], o[5], o + 6);
  }
}

extern "C" void geod(int adaptive, int n, const double* f, const int* ints,
                     const double* P, const double* r, const double* P2,
                     const double* r2, const double* gauss, double* out) {
  SIM5_POLICY(adaptive, geod_t<D>(n, f, ints, P, r, P2, r2, gauss, out));
}

// the goldens' rows: the harness's geodesic_init_inf at (incl, a, alpha,
// beta), then per lane r(P), position_azm(r, P) and the radial
// timedelay(P, r1, P2, r2)
template <typename D>
static void golden_t(int n, const double* a, const double* incl,
                     const double* alpha, const double* beta, const double* P,
                     const double* r1, const double* P2, const double* r2,
                     const double* gauss, double* out) {
  const sim5::GaussRule q = rule(gauss);
  sim5::NoProbe probe;
  for (int i = 0; i < n; ++i) {
    const Geod<double> g =
        sim5::init_inf(incl[i], sim5::Cos(incl[i]), sim5::Sin(incl[i]), a[i],
                       alpha[i], beta[i], probe);
    const double r = sim5::position_rad(g, P[i]);
    out[3 * i] = r;
    out[3 * i + 1] = sim5::position_azm<double, D>(g, r, P[i], q);
    out[3 * i + 2] =
        sim5::timedelay<double, D>(g, P[i], r1[i], P2[i], r2[i], q);
  }
}

extern "C" void golden(int adaptive, int n, const double* a,
                       const double* incl, const double* alpha,
                       const double* beta, const double* P, const double* r1,
                       const double* P2, const double* r2,
                       const double* gauss, double* out) {
  SIM5_POLICY(adaptive, golden_t<D>(n, a, incl, alpha, beta, P, r1, P2, r2,
                                    gauss, out));
}

// the special functions, one argument tuple (6 doubles) a lane
template <typename D>
static void special_t(int which, int n, const double* x, double* out) {
  using namespace sim5;
  for (int i = 0; i < n; ++i) {
    const double* v = x + 6 * i;
    double r = 0.0;
    switch (which) {
      case 0: r = rc<double, D>(v[0], v[1]); break;
      case 1: r = rj<double, D>(v[0], v[1], v[2], v[3]); break;
      case 2: r = rd<double, D>(v[0], v[1], v[2]); break;
      case 3: r = elliptic_f_cos<double, D>(v[0], v[1]); break;
      case 4: r = elliptic_e_cos<double, D>(v[0], v[1]); break;
      case 5: r = elliptic_pi_cos<double, D>(v[0], v[1], v[2]); break;
      case 6: r = elliptic_pi_complete<double, D>(v[0], v[1]); break;
      case 7: r = jacobi_isn<double, D>(v[0], v[1]); break;
      case 8: r = jacobi_icn<double, D>(v[0], v[1]); break;
      case 9: r = icn_signed<double, D>(v[0], v[1]); break;
      case 10: r = jacobi_itn<double, D>(v[0], v[1]); break;
      case 11: r = integral_C1<double>(v[0], v[1]); break;
      case 12: r = integral_C2<double, D>(v[0], v[1]); break;
      case 13: r = integral_C2_cos<double, D>(v[0], v[1]); break;
      case 14: r = integral_Z1<double, D>(v[0], v[1], v[2], v[3]); break;
      case 15: r = integral_Z2<double, D>(v[0], v[1], v[2], v[3]); break;
      case 16: r = integral_Rm1<double>(v[0], v[1], v[2]); break;
      case 17: r = integral_Rm2<double, D>(v[0], v[1], v[2]); break;
      case 18: r = integral_R1<double, D>(v[0], v[1], v[2]); break;
      case 19: r = integral_R2<double, D>(v[0], v[1], v[2]); break;
      case 20: r = integral_R_r0_re<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 21: r = integral_R_r0_re_inf<double, D>(v[0], v[1], v[2], v[3]); break;
      case 22: r = integral_R_r1_re<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 23: r = integral_R_r2_re<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 24: r = integral_R_rp_re<double, D>(v[0], v[1], v[2], v[3], v[4], v[5]); break;
      case 25: r = integral_R_rp_re_inf<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 26: r = integral_R_r0_cc<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 27: r = integral_R_r0_cc_inf<double, D>(v[0], v[1], v[2], v[3]); break;
      case 28: r = integral_R_r1_cc<double, D>(v[0], v[1], v[2], v[3], v[4], v[5]); break;
      case 29: r = integral_R_r2_cc<double, D>(v[0], v[1], v[2], v[3], v[4], v[5]); break;
      case 30: r = integral_R_rp_cc2<double, D>(v[0], v[1], v[2], v[3], 0.5, v[4], v[5]); break;
      case 31: r = integral_R_rp_cc2_inf<double, D>(v[0], v[1], v[2], v[3], v[4], v[5]); break;
      case 32: r = integral_R_r0_bh<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 33: r = integral_R_r1_bh<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 34: r = integral_R_r2_bh<double, D>(v[0], v[1], v[2], v[3], v[4]); break;
      case 35: r = integral_R_rp_bh<double, D>(v[0], v[1], v[2], v[3], v[4], v[5]); break;
      case 36: r = integral_T_m0<double, D>(v[0], v[1], v[2]); break;
      case 37: r = integral_T_m2<double, D>(v[0], v[1], v[2]); break;
      case 38: r = integral_T_m0_dn<double, D>(v[0], v[1], v[2]); break;
      case 39: r = integral_T_m2_dn<double, D>(v[0], v[1], v[2]); break;
      case 40: r = integral_T_mp_dn<double, D>(v[0], v[1], v[2], v[3]); break;
      case 41: r = integral_T_mp<double, D>(v[0], v[1], v[2], v[3]); break;
    }
    out[i] = r;
  }
}

extern "C" void special(int adaptive, int which, int n, const double* x,
                        double* out) {
  SIM5_POLICY(adaptive, special_t<D>(which, n, x, out));
}
"""

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The harness built with g++ (no FMA contraction, as nvcc builds the
    kernels with --fmad=false), or a skip where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the host build of the device "
                    "code cannot be made")
    tmp = tmp_path_factory.mktemp("analytic_host")
    src, so = tmp / "harness.cpp", tmp / "libharness.so"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(_build.CSRC), "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    dll = ctypes.CDLL(str(so))
    dll.crossing.argtypes = [_I] + [_D] * 4 + [_I, _I] + [_P] * 6
    dll.seed.argtypes = [_I, _I, _I] + [_D] * 5 + [_I] + [_P] * 4
    dll.geod.argtypes = [_I, _I] + [_P] * 8
    dll.golden.argtypes = [_I, _I] + [_P] * 10
    dll.special.argtypes = [_I, _I, _I, _P, _P]
    for f in (dll.crossing, dll.seed, dll.geod, dll.golden, dll.special):
        f.restype = None
    return dll


GAUSS = kernel_analytic.gauss_rule()


def _ptr(a):
    return a.ctypes.data


# --- the per-pixel bounds of chip_smoke.py (phi_bound, time_bound)

def phi_bound(g, phi):
    """Two f64 evaluations of phi whose sin/cos round differently by an
    ulp differ near a poloidal turning point by about sqrt(eps) |l/a| /
    ((1 - m2p) sqrt(m2m + m2p)) (module docstring)."""
    S = (g.l / g.a).abs() / ((1.0 - g.m2p).abs()
                              * (g.m2m + g.m2p).abs().sqrt())
    return 8.0 * math.sqrt(EPS64) * S + 1e-12 * (1.0 + phi.abs())


def time_bound(g, t, t_far=0.0):
    """The same for a travel time: its poloidal part has the same turning
    point, sqrt(eps) a m2p / sqrt(m2m + m2p); its radial part from a far
    radius t_far loses up to 1e-10 t_far."""
    return (8.0 * math.sqrt(EPS64) * g.a * g.m2p
            / (g.m2m + g.m2p).abs().sqrt() + 1e-12 * (1.0 + t.abs())
            + 1e-10 * t_far)


def far_bound(g, r):
    """chip_smoke.py's far-field spread of a crossing's radius: dr ~ r^2
    dP where P_inf - P ~ 1/r, P carrying a few dozen roundings (32 ulps)
    of Tpp + |Tip| from K's AGM and Tip's RF chain."""
    return 32.0 * EPS64 * r * r * (g.Tpp + g.Tip.abs())


def _rel(got, want, sel):
    """Max relative difference over `sel` (0 where both are 0)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    d = (got - want).abs()
    scale = want.abs().clamp(min=torch.finfo(want.dtype).tiny)
    r = torch.where(d == 0, 0.0, d / scale)
    return float(r[sel].max()) if bool(sel.any()) else 0.0


def _within(err, bound, sel):
    """Max err / bound over `sel`."""
    return float(torch.where(sel, err / bound, 0.0).max())


# --- runs of the harness

def host_crossing(lib, cfg, order, n=NPIX, adaptive=False):
    a, incl, rmax = cfg["a"], cfg["incl"], cfg["rmax"]
    rms = float(r_ms(torch.tensor(a, dtype=torch.float64)))
    out = [np.empty((n, n)) for _ in range(4)]
    hit = np.empty((n, n), np.uint8)
    lib.crossing(int(adaptive), a, incl, rmax, rms, n, order, _ptr(GAUSS),
                 *(_ptr(o) for o in out), _ptr(hit))
    return dict(zip(("r", "phi", "g", "dt"), map(torch.from_numpy, out)),
                hit=torch.from_numpy(hit.astype(bool)))


def host_seed(lib, cfg, azm, dtype=np.float64, n=NPIX, t0=0.0,
              adaptive=False):
    x0 = np.empty((n, n, 4), dtype)
    k = np.empty_like(x0)
    ok = np.empty((n, n), np.uint8)
    lib.seed(int(adaptive), int(dtype == np.float64), int(azm), cfg["a"],
             cfg["incl"], cfg["rmax"], cfg["r_start"], t0, n, _ptr(GAUSS),
             _ptr(x0), _ptr(k), _ptr(ok))
    return (torch.from_numpy(x0), torch.from_numpy(k),
            torch.from_numpy(ok.astype(bool)))


CASES = dict(spot=SPOT, shadow=SHADOW)


@functools.lru_cache(maxsize=None)
def plain_crossing(order):
    """The plain chain's crossing map of example 07's spot, 32^2
    (cached)."""
    return tlc._crossing_map_unanchored(SPOT["a"], SPOT["incl"], NPIX, 17.5,
                                        order, "cpu")


@functools.lru_cache(maxsize=None)
def plain_seed(case, azm, dtype=torch.float64):
    """The plain chain's (x0, k, ok) of a case's 32^2 seed (cached)."""
    cfg = CASES[case]
    return tlc._volume_seed_plain(cfg["a"], cfg["incl"], 0.0, NPIX,
                                  cfg["rmax"], cfg["r_start"], not azm,
                                  dtype, "cpu")


def seed_geodesic(cfg, dtype=torch.float64, n=NPIX):
    from sim5_tpu_torch.render import image_grid
    alpha, beta = image_grid(n, n, cfg["rmax"], dtype=dtype, device="cpu")
    return tgd.geodesic_init_inf(cfg["incl"], cfg["a"], alpha, beta)


FIELDS = ("a", "alpha", "beta", "incl", "cos_i", "l", "q")
TAIL = ("m2p", "m2m", "mm", "mK", "rp", "Rpc", "Tpp", "Tip")


def pack(g):
    """A plain geodesic's fields as the harness's geod() takes them."""
    f = torch.cat([torch.stack([getattr(g, k) for k in FIELDS], -1),
                   g.rr, g.ri, g.rr_lo,
                   torch.stack([getattr(g, k) for k in TAIL], -1)], -1)
    ints = torch.stack([g.nrr, g.gtype, g.status], -1).to(torch.int32)
    return (np.ascontiguousarray(f.reshape(-1, 27).double().numpy()),
            np.ascontiguousarray(ints.reshape(-1, 3).numpy()))


# ---------------------------------------------------------------------------

def test_signatures_match_the_device_sources():
    """kernel_analytic's ctypes signature tables name each extern "C"
    function of crossing_map.cu and volume_seed.cu, with one argtype a
    parameter, of its C type."""
    ctype = {"int": ctypes.c_int, "double": ctypes.c_double,
             "void": ctypes.c_void_p}
    for src, table in (("crossing_map.cu",
                        kernel_analytic.CROSSING_SIGNATURES),
                       ("volume_seed.cu", kernel_analytic.SEED_SIGNATURES)):
        text = (_build.CSRC / src).read_text()
        decls = re.findall(r'extern "C" (\w+) (\w+)\(([^)]*)\)', text)
        assert sorted(d[1] for d in decls) == sorted(table), src
        for ret, name, params in decls:
            args, restype = table[name]
            types = [p.split()[0] if not p.strip().startswith("const")
                     else p.split()[1] for p in params.split(",")]
            want = [ctypes.c_void_p if "*" in p else ctype[t]
                    for p, t in zip(params.split(","), types)]
            assert args == want, name
            assert restype == (None if ret == "void" else ctype[ret]), name


def test_launch_names_are_the_kernels_instances():
    """LAUNCHES names each pass of the crossing map and of the four seed
    instances (PASSES), and the kernels' orders cap is the wrapper's."""
    assert kernel_analytic.PASSES == {
        "crossing_map<double>": ("crossing_classify<double>",
                                 "crossing_hits<double>"),
        "volume_seed<double, true>": ("seed_geometry<double, true>",
                                      "seed_azimuth<double>"),
        "volume_seed<double, false>": ("seed_geometry<double, false>",),
        "volume_seed<float, true>": ("seed_geometry<float, true>",
                                     "seed_azimuth<float>"),
        "volume_seed<float, false>": ("seed_geometry<float, false>",)}
    assert set(kernel_analytic.LAUNCHES) == {
        p for v in kernel_analytic.PASSES.values() for p in v}
    cu = (_build.CSRC / "crossing_map.cu").read_text()
    assert int(re.search(r"constexpr int kMaxOrders = (\d+);", cu)[1]) \
        == kernel_analytic.MAX_ORDERS


# --- the special functions, lane by lane

def _args(name, rng, n=64):
    """n in-domain argument tuples of `name` and the plain function."""
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    four = np.sort(rng.uniform(-1.0, 8.0, (n, 4)), 1)[:, ::-1]
    a4, b4, c4, d4 = four.T + np.array([[3.0], [1.5], [0.5], [0.0]])
    cc = (u(3.0, 6.0), u(0.5, 2.5), u(-1.0, 1.0), u(0.3, 2.0))
    band = (u(5.0, 6.0), u(3.0, 4.0), u(1.0, 2.0), u(-1.0, 0.0))
    tab = {
        "rc": ((u(0.0, 3.0), np.where(rng.random(n) < 0.3, -1, 1)
                * u(0.1, 3.0)), tsp.rc),
        "rj": ((u(0.0, 3.0), u(0.1, 3.0), u(0.1, 3.0),
                np.where(rng.random(n) < 0.3, -1, 1) * u(0.1, 3.0)), tsp.rj),
        "rd": ((u(0.0, 3.0), u(0.1, 3.0), u(0.1, 3.0)), tsp.rd),
        "elliptic_f_cos": ((u(-1.0, 1.0), u(0.0, 0.99)), tsp.elliptic_f_cos),
        "elliptic_e_cos": ((u(-1.0, 1.0), u(0.0, 0.99)), tsp.elliptic_e_cos),
        "elliptic_pi_cos": ((u(-1.0, 1.0), u(-3.0, 0.9), u(0.0, 0.99)),
                            tsp.elliptic_pi_cos),
        "elliptic_pi_complete": ((u(-3.0, 0.9), u(0.0, 0.99)),
                                 tsp.elliptic_pi_complete),
        "jacobi_isn": ((u(-0.99, 0.99), u(0.0, 0.99)), tsp.jacobi_isn),
        "jacobi_icn": ((u(-1.0, 1.0), u(0.0, 0.99)), tsp.jacobi_icn),
        "icn_signed": ((u(-0.99, 0.99), u(0.01, 0.99)), tsp.icn_signed),
        "jacobi_itn": ((u(-3.0, 3.0), u(0.0, 0.99)), tsp.jacobi_itn),
        "integral_C1": ((u(-2.0, 2.0), u(0.05, 0.95)), tsp.integral_C1),
        "integral_C2": ((u(-2.0, 2.0), u(0.05, 0.95)), tsp.integral_C2),
        "integral_C2_cos": ((u(-1.0, 1.0), u(0.05, 0.95)),
                            tsp.integral_C2_cos),
        "integral_Z1": ((u(-2.0, 0.8), u(-1.0, 1.0), u(-2.0, 2.0),
                         u(0.05, 0.95)), tsp.integral_Z1),
        "integral_Z2": ((u(-2.0, 0.8), u(-1.0, 1.0), u(-2.0, 2.0),
                         u(0.05, 0.95)), tsp.integral_Z2),
        "integral_Rm1": ((u(-0.9, 0.9), u(-2.0, 2.0), u(0.05, 0.95)),
                         tsp.integral_Rm1),
        "integral_Rm2": ((u(-0.9, 0.9), u(-2.0, 2.0), u(0.05, 0.95)),
                         tsp.integral_Rm2),
        "integral_R1": ((u(1.5, 4.0), u(-2.0, 2.0), u(0.05, 0.95)),
                        tsp.integral_R1),
        "integral_R2": ((u(1.5, 4.0), u(-2.0, 2.0), u(0.05, 0.95)),
                        tsp.integral_R2),
        "integral_R_r0_re": ((a4, b4, c4, d4, a4 + u(0.1, 30.0)),
                             tsp.integral_R_r0_re),
        "integral_R_r0_re_inf": ((a4, b4, c4, d4), tsp.integral_R_r0_re_inf),
        "integral_R_r1_re": ((a4, b4, c4, d4, a4 + u(0.1, 30.0)),
                             tsp.integral_R_r1_re),
        "integral_R_r2_re": ((a4, b4, c4, d4, a4 + u(0.1, 30.0)),
                             tsp.integral_R_r2_re),
        "integral_R_rp_re": ((a4, b4, c4, d4, d4 - u(0.1, 1.0),
                              a4 + u(0.1, 30.0)), tsp.integral_R_rp_re),
        "integral_R_rp_re_inf": ((a4, b4, c4, d4, d4 - u(0.1, 1.0)),
                                 tsp.integral_R_rp_re_inf),
        "integral_R_r0_cc": ((*cc, cc[0] + u(0.1, 30.0)),
                             tsp.integral_R_r0_cc),
        "integral_R_r0_cc_inf": (cc, tsp.integral_R_r0_cc_inf),
        "integral_R_r1_cc": ((*cc, cc[0] + u(0.1, 5.0), cc[0] + u(6.0, 30.0)),
                             tsp.integral_R_r1_cc),
        "integral_R_r2_cc": ((*cc, cc[0] + u(0.1, 5.0), cc[0] + u(6.0, 30.0)),
                             tsp.integral_R_r2_cc),
        "integral_R_rp_cc2": ((*cc, cc[0] + u(0.1, 5.0),
                               cc[0] + u(6.0, 30.0)),
                              lambda a, b, u_, v, x1, x2:
                              tsp.integral_R_rp_cc2(a, b, u_, v, 0.5, x1,
                                                    x2)),
        "integral_R_rp_cc2_inf": ((*cc, u(-1.0, 0.9), cc[0] + u(0.1, 30.0)),
                                  tsp.integral_R_rp_cc2_inf),
        "integral_R_r0_bh": ((*band, u(2.0, 3.0) + 1.0),
                             tsp.integral_R_r0_bh),
        "integral_R_r1_bh": ((*band, u(2.0, 3.0) + 1.0),
                             tsp.integral_R_r1_bh),
        "integral_R_r2_bh": ((*band, u(2.0, 3.0) + 1.0),
                             tsp.integral_R_r2_bh),
        "integral_R_rp_bh": ((*band, u(0.2, 0.9), u(2.0, 3.0) + 1.0),
                             tsp.integral_R_rp_bh),
        "integral_T_m0": ((u(0.1, 2.0), u(0.1, 0.9), u(0.0, 0.3)),
                          tsp.integral_T_m0),
        "integral_T_m2": ((u(0.1, 2.0), u(0.1, 0.9), u(0.0, 0.3)),
                          tsp.integral_T_m2),
        "integral_T_m0_dn": ((u(0.05, 0.2), u(0.5, 0.9), u(0.5, 0.7)),
                             tsp.integral_T_m0_dn),
        "integral_T_m2_dn": ((u(0.05, 0.2), u(0.5, 0.9), u(0.5, 0.7)),
                             tsp.integral_T_m2_dn),
        "integral_T_mp_dn": ((u(0.05, 0.2), u(0.5, 0.9), u(1.0, 2.0),
                              u(0.5, 0.7)), tsp.integral_T_mp_dn),
        "integral_T_mp": ((u(0.1, 2.0), u(0.1, 0.9), u(1.0, 2.0),
                           u(-0.3, 0.3)), tsp.integral_T_mp),
    }
    return tab[name]


SPECIALS = ("rc", "rj", "rd", "elliptic_f_cos", "elliptic_e_cos",
            "elliptic_pi_cos", "elliptic_pi_complete", "jacobi_isn",
            "jacobi_icn", "icn_signed", "jacobi_itn", "integral_C1",
            "integral_C2", "integral_C2_cos", "integral_Z1", "integral_Z2",
            "integral_Rm1", "integral_Rm2", "integral_R1", "integral_R2",
            "integral_R_r0_re", "integral_R_r0_re_inf", "integral_R_r1_re",
            "integral_R_r2_re", "integral_R_rp_re", "integral_R_rp_re_inf",
            "integral_R_r0_cc", "integral_R_r0_cc_inf", "integral_R_r1_cc",
            "integral_R_r2_cc", "integral_R_rp_cc2", "integral_R_rp_cc2_inf",
            "integral_R_r0_bh", "integral_R_r1_bh", "integral_R_r2_bh",
            "integral_R_rp_bh", "integral_T_m0", "integral_T_m2",
            "integral_T_m0_dn", "integral_T_m2_dn", "integral_T_mp_dn",
            "integral_T_mp")


@pytest.mark.parametrize("name", SPECIALS)
def test_special_function(lib, name):
    """Each special function and integral of azimuth.cuh against its plain
    version on 64 in-domain argument tuples: within 1e-13 relative (of the
    value, or of 1e-3 of the largest where a difference of integrals
    comes near 0) plus 4x the plain version's own change when its
    arguments move by one ulp (the conditioning of the closed forms, up to
    ~4e-12 for the RC integrals near a pole); NaN where the plain version
    gives NaN."""
    _check_special(lib, name, False)


@pytest.mark.parametrize("name", SPECIALS)
def test_special_function_adaptive(lib, name):
    """test_special_function's check at AdaptiveDepth, the kernels'
    Carlson chains (Carlson's stopping rule, RJ's term in closed form),
    against the same plain torch functions (the JAX package's fixed
    depth): 1e-13 relative plus 4x the plain version's change when its
    arguments move by one ulp, here each argument on its own (the two
    moves of all together and 6 random sign patterns).  The integrals are
    homogeneous in their arguments, so a move of all of them by the same
    factor scales the value exactly and the plain chain's change under it
    is only its own rounding, which a chain that rounds otherwise does
    not share: integral_R_rp_cc2_inf at Carlson's rule lies at 1.6 of
    that narrower bound on one tuple, at 0.44 of this one, and as near a
    30-digit quadrature as the plain chain (median 3.2e-14 against
    2.6e-14 relative over 600 tuples)."""
    _check_special(lib, name, True, patterns=6)


def _check_special(lib, name, adaptive, patterns=0):
    rng = np.random.default_rng(SPECIALS.index(name))
    args, fn = _args(name, rng)
    x = np.zeros((len(args[0]), 6))
    x[:, :len(args)] = np.stack(args, -1)
    got = np.empty(len(x))
    lib.special(int(adaptive), SPECIALS.index(name), len(x),
                _ptr(np.ascontiguousarray(x)), _ptr(got))
    # the values and the one-ulp moves in one call of the plain version:
    # all arguments up and down, then `patterns` random signs an argument
    tens = [torch.tensor(np.ascontiguousarray(v)) for v in args]
    signs = np.concatenate([np.ones((1, len(tens))), -np.ones((1, len(tens))),
                            np.random.default_rng(1000 + SPECIALS.index(
                                name)).choice([-1.0, 1.0],
                                              (patterns, len(tens)))])
    vals = fn(*(torch.cat([t] + [t * (1.0 + s * EPS64) for s in signs[:, j]])
                for j, t in enumerate(tens))).numpy().reshape(
        len(signs) + 1, -1)
    want = vals[0]
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), name
    fin = np.isfinite(want)
    assert fin.mean() > 0.9, f"{name}: {fin.mean():.2f} finite"
    cond = np.abs(vals[1:] - want).max(0)
    scale = np.maximum(np.abs(want[fin]), 1e-3 * np.abs(want[fin]).max())
    err = np.abs(got[fin] - want[fin]) / (1e-13 * scale + 4.0 * cond[fin])
    assert float(err.max()) <= 1.0, f"{name}: {err.max():.3f} of the bound"


# --- the geodesic functions on every trajectory type

def _bh_geodesics():
    """8 RR_BH geodesics from source points inside the bound band
    (test_torch_azimuth.py's, set up by the port's geodesic_init_src)."""
    a = 0.9
    l = (2.5 ** 2 * (3 - 2.5) - a ** 2 * (2.5 + 1)) / (a * (2.5 - 1))
    q0 = 2.5 ** 3 * (4 * a ** 2 - 2.5 * (2.5 - 3) ** 2) \
        / (a ** 2 * (2.5 - 1) ** 2)
    rs = np.repeat([1.7, 1.8, 1.9, 2.0], 2)
    m0 = np.tile([0.05, 0.1], 4)
    q = q0 + np.tile([0.3, 0.5], 4)
    t = lambda v: torch.tensor(np.asarray(v, np.float64))
    k = photon_momentum(t(np.full(8, a)), t(rs), t(m0), t(np.full(8, l)),
                        t(q), t(np.ones(8)), t(np.ones(8)))
    return tgd.geodesic_init_src(t(np.full(8, a)), t(rs), t(m0), k,
                                 t(np.zeros(8)))


# CC rays (all vortical) and vortical RC rays near the image centre at
# a = 0.5, i = 60 deg (test_torch_azimuth.py's)
CENTRE = np.array([(-0.45, 0.05), (-0.4, 0.1), (-0.35, 0.0), (-0.35, 0.05),
                   (-0.3, 0.1), (-0.3, -0.124375), (-0.25, 0.05),
                   (-0.3, 0.124375), (0.2, 0.1), (0.1, -0.05), (0.0, 0.1),
                   (-0.1, -0.1), (0.3, 0.05), (0.15, 0.0), (-0.05, 0.05),
                   (0.25, -0.1)])


@pytest.fixture(scope="module")
def batch():
    """(geodesic, P, r) of 64 geodesics at 4 positions each: RR and RC
    rays of an image grid, CC and vortical rays, RR_BH rays."""
    al, be = np.meshgrid(np.linspace(-7.0, 7.0, 8), np.linspace(-6.0, 6.0, 5))
    t = lambda v: torch.tensor(np.asarray(v, np.float64))
    gs = [tgd.geodesic_init_inf(t(np.full(al.size, np.radians(70.0))),
                                t(np.full(al.size, 0.9)), t(al.ravel()),
                                t(be.ravel())),
          tgd.geodesic_init_inf(t(np.full(16, np.radians(60.0))),
                                t(np.full(16, 0.5)), t(CENTRE[:, 0]),
                                t(CENTRE[:, 1])),
          _bh_geodesics()]
    g = tgd.Geodesic(*(torch.cat([getattr(x, f.name) for x in gs]).repeat_interleave(4, 0)
                       for f in __import__("dataclasses").fields(tgd.Geodesic)))
    frac = {tgd.GEOD_TYPE_RR: (0.2, 0.7, 1.3, 1.8),
            tgd.GEOD_TYPE_RR_BH: (0.2, 0.6, 1.2, 3.3)}
    fr = torch.tensor([frac.get(int(gt), (0.15, 0.4, 0.7, 0.95))[i % 4]
                       for i, gt in enumerate(g.gtype.tolist())],
                      dtype=torch.float64)
    P = fr * g.Rpc
    r = tgd.geodesic_position_rad(g, P)
    return g, P, r


def test_batch_covers_every_type(batch):
    g, P, r = batch
    ok = g.status == 0
    types = set(g.gtype[ok].tolist())
    assert {tgd.GEOD_TYPE_RR, tgd.GEOD_TYPE_RC, tgd.GEOD_TYPE_CC,
            tgd.GEOD_TYPE_RR_BH} <= types
    assert bool((ok & (g.q < 0) & (g.gtype == tgd.GEOD_TYPE_RC)).any())
    assert bool((ok & (g.q < 0) & (g.gtype == tgd.GEOD_TYPE_CC)).any())
    # RR_BH lanes past one radial period (the folded band terms)
    assert bool((ok & (g.gtype == tgd.GEOD_TYPE_RR_BH)
                 & (P > 2.0 * g.Rpc)).any())


def _geod_run(lib, batch, adaptive):
    g, P, r = batch
    f, ints = pack(g)
    P2 = (0.05 * g.Rpc).numpy()
    r2 = tgd.geodesic_position_rad(g, torch.from_numpy(P2)).numpy()
    out = np.empty((len(P), 10))
    lib.geod(int(adaptive), len(P), _ptr(f), _ptr(ints), _ptr(P.numpy()),
             _ptr(r.numpy()), _ptr(np.ascontiguousarray(P2)),
             _ptr(np.ascontiguousarray(r2)), _ptr(GAUSS), _ptr(out))
    return torch.from_numpy(out), torch.from_numpy(P2), torch.from_numpy(r2)


@pytest.fixture(scope="module")
def geod_out(lib, batch):
    return _geod_run(lib, batch, False)


@pytest.fixture(scope="module")
def geod_out_adaptive(lib, batch):
    return _geod_run(lib, batch, True)


@pytest.fixture(scope="module")
def plain_geod(batch, geod_out):
    """The plain versions' azimuth, radial time and full time of the
    batch (P2, r2 geod_out's)."""
    g, P, r = batch
    _, P2, r2 = geod_out
    m = torch.zeros_like(r)
    azm = tgd.geodesic_position_azm(g, r, m, P)
    t_rad = tgd.geodesic_timedelay(g, P, r, m, P2, r2, m)
    # geodesic_timedelay_full's definition, without its second radial pass
    t_full = t_rad + torch.abs(tan._theta_time_cum(g, P2)
                               - tan._theta_time_cum(g, P))
    return azm, t_rad, t_full


def test_geodesic_azimuth(batch, geod_out, plain_geod):
    """position_azm on every type against geodesic_position_azm, within
    phi_bound; NaN where it gives NaN."""
    _check_azimuth(batch, geod_out[0], plain_geod[0])


def test_geodesic_azimuth_adaptive(batch, geod_out_adaptive, plain_geod):
    """test_geodesic_azimuth's check at AdaptiveDepth (every type, RR_BH
    included)."""
    _check_azimuth(batch, geod_out_adaptive[0], plain_geod[0])


def _check_azimuth(batch, out, want):
    g, P, r = batch
    assert torch.equal(torch.isfinite(out[:, 0]), torch.isfinite(want))
    fin = torch.isfinite(want) & (g.status == 0)
    assert int(fin.sum()) > 200
    assert _within((out[:, 0] - want).abs(), phi_bound(g, want), fin) <= 1.0


def test_geodesic_time(batch, geod_out, plain_geod):
    """timedelay and timedelay_full on every type against the plain
    versions, within time_bound."""
    _check_time(batch, geod_out[0], plain_geod)


def test_geodesic_time_adaptive(batch, geod_out_adaptive, plain_geod):
    """test_geodesic_time's check at AdaptiveDepth."""
    _check_time(batch, geod_out_adaptive[0], plain_geod)


def _check_time(batch, out, plain):
    g = batch[0]
    _, t_rad, t_full = plain
    for col, want in ((1, t_full), (2, t_rad)):
        assert torch.equal(torch.isfinite(out[:, col]), torch.isfinite(want))
        fin = torch.isfinite(want) & (g.status == 0)
        assert int(fin.sum()) > 200
        assert _within((out[:, col] - want).abs(), time_bound(g, want),
                       fin) <= 1.0, col


def test_geodesic_position_and_momentum(batch, geod_out):
    """P_int (both sides of the turning point), position_pol and the
    momentum on every type: 1e-12 relative, 1e-12 absolute for m."""
    g, P, r = batch
    out = geod_out[0]
    for col, ppc in ((3, 0), (4, 1)):
        want = tgd.geodesic_P_int(g, r, ppc)
        assert torch.equal(torch.isfinite(out[:, col]), torch.isfinite(want))
        assert _rel(out[:, col], want, torch.isfinite(want)) <= 1e-12
    m = tgd.geodesic_position_pol(g, P)
    fin = torch.isfinite(m)
    assert torch.equal(torch.isfinite(out[:, 5]), fin)
    assert float((out[:, 5] - m).abs()[fin].max()) <= 1e-12
    k = tgd.geodesic_momentum(g, P, r, m)
    kf = torch.isfinite(k)
    assert torch.equal(torch.isfinite(out[:, 6:]), kf)
    assert _rel(out[:, 6:], k, kf) <= 1e-12


# --- the C goldens through the harness's own init

def test_goldens(lib):
    """The harness's init, azimuth and radial time against geod.txt's
    position samples (>= 97% within rtol 1e-4, atol 1e-6) and
    timedelay.txt (finiteness agreeing on > 95%, > 95% within rtol 1e-5,
    atol 1e-7): chip_smoke.py phase 13's gates."""
    _check_goldens(lib, False)


def test_goldens_adaptive(lib):
    """test_goldens' check with the azimuth and the time at
    AdaptiveDepth."""
    _check_goldens(lib, True)


def _check_goldens(lib, adaptive):
    rows, cur = [], None
    for line in (GOLDEN / "geod.txt").read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        vals = [float(v) for v in parts[1:]]
        if parts[0] == "ginit":
            cur = vals if vals[4] == 1 else None
        elif parts[0] == "gpos" and cur is not None:
            rows.append(cur[:4] + [vals[0], vals[3]])
    d = np.asarray(rows)
    n = len(d)
    cols = [np.ascontiguousarray(d[:, i]) for i in range(5)]
    out = np.empty((n, 3))
    lib.golden(int(adaptive), n, *(_ptr(c) for c in cols), _ptr(cols[4]),
               _ptr(cols[4]), _ptr(cols[4]), _ptr(GAUSS), _ptr(out))
    phi, want = out[:, 1], d[:, 5]
    ok = np.isfinite(want) & np.isfinite(phi) & np.isfinite(out[:, 0])
    frac = float((np.abs(phi - want) <= 1e-6 + 1e-4 * np.abs(want))[ok].mean())
    assert ok.sum() > 100 and frac > 0.97, frac
    d = np.asarray([[float(v) for v in line.split()[1:]] for line in
                    (GOLDEN / "timedelay.txt").read_text().splitlines()
                    if line.split()[:1] == ["td"]])
    n = len(d)
    cols = [np.ascontiguousarray(d[:, i]) for i in (0, 1, 2, 3, 4, 5, 7, 8)]
    out = np.empty((n, 3))
    lib.golden(int(adaptive), n, *(_ptr(c) for c in cols), _ptr(GAUSS),
               _ptr(out))
    dt, want = out[:, 2], d[:, 9]
    fin = np.isfinite(dt) == np.isfinite(want)
    both = np.isfinite(dt) & np.isfinite(want)
    td_frac = float((np.abs(dt - want) <= 1e-7 + 1e-5 * np.abs(want))[both]
                    .mean())
    assert fin.mean() > 0.95 and td_frac > 0.95, (fin.mean(), td_frac)


# --- the pixels against the plain version

def seed_bounds(g, x0, k):
    """chip_smoke.py's per-pixel bounds on the f64 seed's r0, m0 and k:
    1e-12 of each field's scale (max(|v|, 1e-3 of its peak)), and where a
    field passes through 0 its own spread: m0 by sqrt(m2p) dT / mK (dT 8
    ulps of Tpp + |Tip| + Rpc), k^r = sqrt(R) / S and k^theta = sqrt(M) /
    S by min(dR / (2 |k| S^2), sqrt(dR) / S) (R and M 8 ulps of their
    terms) near a turning point."""
    r, m = x0[..., 1], x0[..., 2]

    def scale(v):
        return 1e-12 * v.abs().clamp(min=1e-3 * float(v.abs().max()))

    e8 = 8.0 * EPS64
    a, l, q = g.a, g.l, g.q
    a2, r2, m2 = a * a, r * r, m * m
    S = r2 + a2 * m2
    D = r2 - 2.0 * r + a2
    A = r2 + a2 - a * l
    dR = e8 * (A * A + D.abs() * ((l - a) ** 2 + q.abs()))
    dM = e8 * (q.abs() + l * l * m2 / (1.0 - m2) + a2 * m2)

    def root(dX, kc):
        return torch.minimum(dX / (2.0 * kc.abs() * S * S), dX.sqrt() / S)

    b_m = scale(m) + e8 * g.m2p.sqrt() * (g.Tpp + g.Tip.abs() + g.Rpc) / g.mK
    b_k = torch.stack([scale(k[..., 0]), scale(k[..., 1]) + root(dR, k[..., 1]),
                       scale(k[..., 2]) + root(dM, k[..., 2]),
                       scale(k[..., 3])], -1)
    return scale(r), b_m, b_k


def _field_rel(got, want, sel):
    """Max over the last axis's fields of |got - want| relative to
    max(|want|, 1e-3 of the field's largest |want|) over `sel`: m0 = cos
    theta and k's small components pass through 0, where a relative
    error is no measure (module docstring)."""
    worst = 0.0
    for c in range(want.shape[-1]):
        w, gv = want[..., c][sel], got[..., c][sel]
        scale = w.abs().clamp(min=1e-3 * float(w.abs().max()))
        worst = max(worst, float(((gv - w).abs() / scale).max()))
    return worst


@pytest.fixture(scope="module", params=["spot", "shadow"])
def case(request):
    return request.param


def test_seed_types(case):
    """The spot's seed holds RR and RC valid lanes, the shadow's RC, CC
    and vortical (q < 0) ones."""
    g = seed_geodesic(CASES[case])
    _, _, ok = plain_seed(case, False)
    types = set(g.gtype[ok].tolist())
    if case == "spot":
        assert {tgd.GEOD_TYPE_RR, tgd.GEOD_TYPE_RC} <= types
    else:
        assert {tgd.GEOD_TYPE_RC, tgd.GEOD_TYPE_CC} <= types
        assert bool((ok & (g.q < 0) & (g.gtype == tgd.GEOD_TYPE_CC)).any())
        assert bool((ok & (g.q < 0) & (g.gtype == tgd.GEOD_TYPE_RC)).any())


@pytest.mark.parametrize("azm", [True, False])
def test_seed_f64(lib, case, azm):
    """The f64 seed's x0, k and ok against the plain chain: ok equal; t0
    exactly; r0, m0 and k within `seed_bounds`; phi0 within phi_bound (0
    without the azimuth); the invalid pixels' dummy ray exactly."""
    _check_seed_f64(lib, case, azm, False)


@pytest.mark.parametrize("azm", [True, False])
def test_seed_f64_adaptive(lib, case, azm):
    """test_seed_f64's check of seed_pixel at AdaptiveDepth, the kernels'
    policy (its azimuth's Carlson chains; the axisymmetric seed runs
    none)."""
    _check_seed_f64(lib, case, azm, True)


def _check_seed_f64(lib, case, azm, adaptive):
    cfg = CASES[case]
    x0, k, ok = host_seed(lib, cfg, azm, adaptive=adaptive)
    px0, pk, pok = plain_seed(case, azm)
    assert torch.equal(ok, pok)
    assert int(ok.sum()) > NPIX
    assert torch.equal(x0[..., 0], px0[..., 0])
    g = seed_geodesic(cfg)
    b_r, b_m, b_k = seed_bounds(g, px0, pk)
    assert _within((x0[..., 1] - px0[..., 1]).abs(), b_r, ok) <= 1.0
    assert _within((x0[..., 2] - px0[..., 2]).abs(), b_m, ok) <= 1.0
    for c in range(4):
        assert _within((k[..., c] - pk[..., c]).abs(), b_k[..., c], ok) \
            <= 1.0, c
    assert torch.equal(x0[~ok], px0[~ok]) and torch.equal(k[~ok], pk[~ok])
    if not azm:
        assert bool((x0[..., 3] == 0).all())
        return
    assert _within((x0[..., 3] - px0[..., 3]).abs(),
                   phi_bound(g, px0[..., 3]), ok) <= 1.0


def test_seed_f32(lib, case):
    """The f32 seed (with the azimuth) against the f64 plain version, no
    further than 2x the plain f32 chain's own distance (module
    docstring)."""
    _check_seed_f32(lib, case, False)


def test_seed_f32_adaptive(lib, case):
    """test_seed_f32's check at AdaptiveDepth."""
    _check_seed_f32(lib, case, True)


def _check_seed_f32(lib, case, adaptive):
    x0, k, ok = host_seed(lib, CASES[case], True, np.float32,
                          adaptive=adaptive)
    px0, pk, pok = plain_seed(case, True, torch.float32)
    wx0, wk, wok = plain_seed(case, True)
    n = ok.numel()
    assert int((ok != wok).sum()) <= max(2, n // 100)
    assert int((ok != pok).sum()) <= max(2, n // 100)
    both = ok & wok & pok
    for got, plain, want in ((x0, px0, wx0), (k, pk, wk)):
        for c in range(4):
            scale = float(want[..., c][both].abs().max()) or 1.0
            e_k = float((got[..., c].double() - want[..., c]).abs()[both]
                        .max())
            e_p = float((plain[..., c].double() - want[..., c]).abs()[both]
                        .max())
            assert e_k <= 2.0 * e_p + 1e-6 * scale, (c, e_k, e_p, scale)


@pytest.mark.parametrize("order", [0, 1])
def test_crossing_map(lib, order):
    """The crossing map of example 07's spot against the plain chain:
    hit equal; g 1e-12 relative, r 1e-12 relative + `far_bound`; phi
    within phi_bound; the delay before the anchor within time_bound (+
    1e-10 R_FAR, + `far_bound`), and after it (the anchor pixel's bound
    added); the pixels that are no hit exactly
    the plain version's phi = 0, g = 1 and delay 0 (and r = 10 where
    there is no crossing)."""
    _check_crossing(lib, order, False)


@pytest.mark.parametrize("order", [0, 1])
def test_crossing_map_adaptive(lib, order):
    """test_crossing_map's check of crossing_pixel at AdaptiveDepth, the
    kernels' policy."""
    _check_crossing(lib, order, True)


def _check_crossing(lib, order, adaptive):
    cfg = dict(a=SPOT["a"], incl=SPOT["incl"], rmax=17.5)
    m = host_crossing(lib, cfg, order, adaptive=adaptive)
    p = plain_crossing(order)
    hit = p["hit"]
    assert torch.equal(m["hit"], hit)
    assert int(hit.sum()) > 50
    # r on every pixel (a crossing inside the ISCO keeps its radius)
    g = seed_geodesic(cfg)
    far = far_bound(g, p["r"])
    assert _within((m["r"] - p["r"]).abs(), 1e-12 * p["r"].abs() + far,
                   torch.ones_like(hit)) <= 1.0
    assert _rel(m["g"], p["g"], hit) <= 1e-12
    for key in ("phi", "g", "dt"):
        assert torch.equal(m[key][~hit], p[key][~hit]), key
    assert _within((m["phi"] - p["phi"]).abs(), phi_bound(g, p["phi"]),
                   hit) <= 1.0
    tb = time_bound(g, p["dt"], tlc.R_FAR) + far
    assert _within((m["dt"] - p["dt"]).abs(), tb, hit) <= 1.0
    # the anchor, as equatorial_crossing_map(_reference) applies it
    anchored = [d - torch.where(hit, d, math.inf).min()
                for d in (m["dt"], p["dt"])]
    anchor = tb[hit][int(anchored[1][hit].argmin())]
    assert _within((anchored[0] - anchored[1]).abs(), tb + anchor, hit) \
        <= 1.0
    assert float(anchored[0][hit].min()) == 0.0


class TestAgainstJax:
    """The harness against the JAX package's axisymmetric seed (its
    geometry and packing programs) on the CPU, 32^2, both cases: ok
    equal, r0, m0 and k 1e-10 relative (`_field_rel`; the jitted program
    fuses the geometry's f64 operations, as test_torch_volume.py holds the
    plain seed).  The azimuth stage and the crossing map against the JAX
    package's programs, whose compiles take minutes, are in
    test_torch_analytic_slow.py."""

    @pytest.fixture(scope="class")
    def jax_seeds(self):
        from sim5_tpu.render import lightcurve as jlc
        out = {}
        for case, cfg in CASES.items():
            st, ok = jlc._volume_seed(cfg["a"], cfg["incl"], 0.0, NPIX,
                                      cfg["rmax"], cfg["r_start"], 0.02,
                                      axisymmetric=True)
            out[case] = tuple(torch.from_numpy(np.array(v))
                              for v in (st.x, st.k, ok))
        return out

    def test_axisymmetric_seed(self, lib, jax_seeds, case):
        self._check(lib, jax_seeds, case, False)

    def test_axisymmetric_seed_adaptive(self, lib, jax_seeds, case):
        """seed_pixel<T, false> instantiated at AdaptiveDepth: the
        geometry keeps its fixed chains whatever the policy."""
        self._check(lib, jax_seeds, case, True)

    @staticmethod
    def _check(lib, jax_seeds, case, adaptive):
        jx, jk, jok = jax_seeds[case]
        x0, k, ok = host_seed(lib, CASES[case], False, adaptive=adaptive)
        assert torch.equal(ok, jok)
        assert _field_rel(x0[..., 1:3], jx[..., 1:3], ok) <= 1e-10
        assert _field_rel(k, jk, ok) <= 1e-10


class TestOperationCounts:
    """kernel_analytic.operation_counts: the kernels' pixels on the
    counting scalar (csrc/analytic_ops.cpp) give the plain harness's bits,
    and count each precision's operations where the pixel runs them."""

    def test_crossing(self, lib):
        self._crossing(lib, False)

    def test_crossing_adaptive(self, lib):
        """At Carlson's rule (adaptive=True): the harness's AdaptiveDepth
        bits."""
        self._crossing(lib, True)

    @staticmethod
    def _crossing(lib, adaptive):
        cfg = dict(a=SPOT["a"], incl=SPOT["incl"], rmax=17.5)
        ops, out = kernel_analytic.operation_counts(
            "crossing", cfg["a"], cfg["incl"], 16, cfg["rmax"], (0, 1),
            threads=2, adaptive=adaptive)
        for j, order in enumerate((0, 1)):
            m = host_crossing(lib, cfg, order, n=16, adaptive=adaptive)
            for key, v in zip(("r", "phi", "g", "dt", "hit"), out):
                assert np.array_equal(v[j], m[key].numpy()), (order, key)
        assert sum(ops["f32"].values()) == 0
        assert ops["f64"]["add"] > 16 * 16 * 1000
        assert ops["f64"]["sqrt"] > 0 and ops["f64"]["transcendental"] > 0

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_seed(self, lib, dtype):
        self._seed(lib, dtype, False)

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_seed_adaptive(self, lib, dtype):
        """At Carlson's rule (adaptive=True): the harness's AdaptiveDepth
        bits."""
        self._seed(lib, dtype, True)

    @staticmethod
    def _seed(lib, dtype, adaptive):
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        ops, (x0, k, ok) = kernel_analytic.operation_counts(
            "seed", SPOT["a"], SPOT["incl"], 16, SPOT["rmax"],
            r_start=SPOT["r_start"], dtype=dtype, threads=2,
            adaptive=adaptive)
        hx, hk, hok = host_seed(lib, SPOT, True, np_dt, n=16,
                                adaptive=adaptive)
        assert np.array_equal(x0, hx.numpy()) and np.array_equal(k, hk.numpy())
        assert np.array_equal(ok, hok.numpy())
        # the azimuth in f64 whatever the seed's type
        assert ops["f64"]["add"] > 16 * 16 * 1000
        if dtype == torch.float32:
            assert ops["f32"]["add"] > 16 * 16 * 100
        _, (_, _, ok_axi) = kernel_analytic.operation_counts(
            "seed", SPOT["a"], SPOT["incl"], 16, SPOT["rmax"],
            r_start=SPOT["r_start"], dtype=dtype, axisymmetric=True,
            threads=2, adaptive=adaptive)
        assert np.array_equal(ok_axi, ok)
