"""The Carlson chains at Carlson's stopping rule and the two-pass layout of
the crossing-map and volume-seed kernels, built for the host: g++ compiles
`sim5_tpu_torch/csrc/azimuth.cuh` with a small harness.

* The special functions at `AdaptiveDepth` (RF, RC, RJ, RD, and RF with
  RD from one chain) against the plain torch functions
  (`sim5_tpu_torch.special`, the JAX package's fixed 16 levels), on
  argument tuples that stress the depth: the 1e-300 floors, m -> 1, p ->
  0 from either side and p < 0 (the principal value), and generic ones.
  Gate: test_torch_analytic_host.py's test_special_function gate, 1e-13
  relative plus 4x the plain version's own change when its arguments
  move by one ulp.  Each call's levels at most 16 (the fixed depth), and
  fewer on the generic tuples.
* The RR integrals at one point with their shared values computed once
  (`rr_time_terms`, `rp_re_pair`) bitwise the single integrals, and the
  crossing map and the seed with every shared value (`kShare`) bitwise
  those whose integrals each compute their own.
* The operation counter (`kernel_analytic.operation_counts`): at
  Carlson's rule the SPOT crossing map and seed count fewer f64
  operations than at the fixed depth, every chain at most 16 levels.
* The kernels' two passes emulated on the host: the classify (geometry)
  pass over every pixel, the lists by work bin (`sim5::work_bin`; the
  crossing map's delays, then its azimuths), then the second pass's
  functions over the bins in order, each bin's entries in reverse (the
  device takes them in any order): bitwise
  `crossing_pixel` / `seed_pixel` under the same policy, orders 0 and 1,
  f64 and f32, both policies, on the SPOT and SHADOW cases, whose lanes
  hold RR, RC, CC and vortical (q < 0) types (asserted).
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sim5_tpu_torch import _build
from sim5_tpu_torch import special as tsp
from sim5_tpu_torch.core import r_ms
from sim5_tpu_torch.render import kernel_analytic

NPIX = 32
SPOT = dict(a=0.5, incl=math.radians(70.0), rmax=17.5, r_start=40.0)
SHADOW = dict(a=0.9, incl=math.radians(70.0), rmax=2.5, r_start=40.0)
CASES = dict(spot=SPOT, shadow=SHADOW)
EPS64 = float(np.finfo(np.float64).eps)
GAUSS = kernel_analytic.gauss_rule()

HARNESS = r"""
#include <algorithm>
#include <vector>

#include "azimuth.cuh"

using sim5::Geod;

namespace {

thread_local int t_deepest = 0;

// Carlson's rule with every integral computing its own values (kShare
// off): what AdaptiveDepth's shared values must equal bitwise
struct AdaptiveSingle : sim5::AdaptiveDepth {
  static constexpr bool kShare = false;
};

// a depth policy that keeps the deepest chain of a call
template <typename Base>
struct Deepest : Base {
  static void note(int, int levels) { t_deepest = std::max(t_deepest, levels); }
};

sim5::GaussRule rule(const double* g) {
  sim5::GaussRule q;
  for (int k = 0; k < 16; ++k) {
    q.x[k] = g[k];
    q.w[k] = g[16 + k];
  }
  for (int k = 0; k < 7; ++k) q.edges[k] = g[32 + k];
  return q;
}

template <typename D>
double special_d(int which, const double* v) {
  using namespace sim5;
  double f = 0.0, d = 0.0;
  switch (which) {
    case 0: return rf_p<double, D>(v[0], v[1], v[2]);
    case 1: return rc<double, D>(v[0], v[1]);
    case 2: return rj<double, D>(v[0], v[1], v[2], v[3]);
    case 3: return rd<double, D>(v[0], v[1], v[2]);
    case 4: rf_rd<double, D>(v[0], v[1], v[2], f, d); return f;
    case 5: rf_rd<double, D>(v[0], v[1], v[2], f, d); return d;
  }
  return 0.0;
}

// two passes as the kernels run them: geometry over every pixel, lists by
// work bin (the crossing map: each hit's delay in bins 0-7, its azimuth in
// 8-15), then the rest over the bins in order, each bin in reverse
template <typename D>
void crossing_two(double a, double incl, double rmax, double rms, int n,
                  int order, const sim5::GaussRule& q, double* r, double* phi,
                  double* g, double* dt, unsigned char* hit, int* bins) {
  const double c = sim5::Cos(incl), s = sim5::Sin(incl);
  std::vector<Geod<double>> geo(n * n);
  std::vector<double> P(n * n), rs(n * n);
  std::vector<int> list[sim5::kMaxBins];
  for (int i = 0; i < n * n; ++i) {
    double gf;
    const bool h = sim5::crossing_geometry(a, incl, c, s, rmax, rms, order,
                                           i % n, i / n, n, geo[i], P[i],
                                           rs[i], gf);
    r[i] = rs[i];
    g[i] = h ? gf : 1.0;
    hit[i] = h;
    if (h) {
      const int b = sim5::work_bin(geo[i]);
      list[b].push_back(2 * i + 1);
      list[sim5::kWorkBins + b].push_back(2 * i);
    } else {
      phi[i] = 0.0;
      dt[i] = 0.0;
    }
  }
  sim5::NoStage st;
  for (int b = 0; b < sim5::kMaxBins; ++b) {
    if (b < sim5::kWorkBins) bins[b] = (int)list[b].size();
    for (auto it = list[b].rbegin(); it != list[b].rend(); ++it) {
      const int i = *it >> 1;
      if (*it & 1)
        dt[i] = sim5::crossing_delay<double, D>(true, geo[i], P[i], rs[i],
                                                i % n, i / n, n, rmax, q, st);
      else
        phi[i] = sim5::crossing_azimuth<double, D>(true, geo[i], P[i], rs[i],
                                                   q, st);
    }
  }
}

template <typename D>
void crossing_one(double a, double incl, double rmax, double rms, int n,
                  int order, const sim5::GaussRule& q, double* r, double* phi,
                  double* g, double* dt, unsigned char* hit) {
  const double c = sim5::Cos(incl), s = sim5::Sin(incl);
  for (int i = 0; i < n * n; ++i) {
    bool h;
    sim5::crossing_pixel<double, D>(a, incl, c, s, rmax, rms, order, i % n,
                                    i / n, n, q, r[i], phi[i], g[i], dt[i], h);
    hit[i] = h;
  }
}

template <typename T, typename D>
void seed_two(double a, double incl, double rmax, double r_start, double t0,
              int n, const sim5::GaussRule& q, T* x0, T* k, unsigned char* ok,
              int* bins) {
  const T i_ = T(incl);
  const T c = sim5::Cos(i_), s = sim5::Sin(i_);
  std::vector<Geod<T>> geo(n * n);
  std::vector<T> P0(n * n);
  std::vector<int> list[sim5::kWorkBins];
  for (int i = 0; i < n * n; ++i) {
    const bool v = sim5::seed_geometry(T(a), i_, c, s, T(rmax), T(r_start),
                                       T(t0), i % n, i / n, n, geo[i], P0[i],
                                       x0 + 4 * i, k + 4 * i);
    ok[i] = v;
    if (v) list[sim5::work_bin(geo[i])].push_back(i);
  }
  sim5::NoStage st;
  for (int b = 0; b < sim5::kWorkBins; ++b) {
    bins[b] = (int)list[b].size();
    for (auto it = list[b].rbegin(); it != list[b].rend(); ++it) {
      const int i = *it;
      ok[i] = sim5::seed_azimuth<T, D>(true, geo[i], P0[i], T(r_start), q,
                                       x0 + 4 * i, k + 4 * i, st);
    }
  }
}

template <typename T, typename D>
void seed_one(double a, double incl, double rmax, double r_start, double t0,
              int n, const sim5::GaussRule& q, T* x0, T* k, unsigned char* ok) {
  const T i_ = T(incl);
  const T c = sim5::Cos(i_), s = sim5::Sin(i_);
  for (int i = 0; i < n * n; ++i) {
    bool v;
    sim5::seed_pixel<T, true, D>(T(a), i_, c, s, T(rmax), T(r_start), T(t0),
                                 i % n, i / n, n, q, x0 + 4 * i, k + 4 * i, v);
    ok[i] = v;
  }
}

}  // namespace

// special function `which` (0 RF, 1 RC, 2 RJ, 3 RD, 4 RF and 5 RD of
// rf_rd) on n tuples of 4 doubles, at Carlson's rule (adaptive) or the
// fixed depth; each call's deepest chain into levels
extern "C" void special(int which, int adaptive, int n, const double* x,
                        double* out, int* levels) {
  for (int i = 0; i < n; ++i) {
    t_deepest = 0;
    out[i] = adaptive
                 ? special_d<Deepest<sim5::AdaptiveDepth>>(which, x + 4 * i)
                 : special_d<Deepest<sim5::FixedDepth>>(which, x + 4 * i);
    levels[i] = t_deepest;
  }
}

// the RR integrals at the points X of n tuples (a, b, c, d, X, p1, p2) of
// x, 7 doubles each: rr_time_terms and rp_re_pair at X and at infinity
// into shared, the single integrals into single, 9 values a tuple each
extern "C" void rr_terms(int adaptive, int n, const double* x,
                         double* shared, double* single) {
  using namespace sim5;
  for (int i = 0; i < n; ++i) {
    const double* v = x + 7 * i;
    const double a = v[0], b = v[1], c = v[2], d = v[3], X = v[4];
    const double p1 = v[5], p2 = v[6];
    double* sh = shared + 9 * i;
    double* si = single + 9 * i;
    if (adaptive) {
      using D = AdaptiveDepth;
      rr_time_terms<double, D>(a, b, c, d, p1, p2, X, sh);
      rp_re_pair<double, D>(a, b, c, d, p1, p2, re_sn(a, b, d, X), sh + 5);
      rp_re_pair<double, D>(a, b, c, d, p1, p2, Sqrt((b - d) / (a - d)),
                            sh + 7);
      si[0] = integral_R_r0_re<double, D>(a, b, c, d, X);
      si[1] = integral_R_r1_re<double, D>(a, b, c, d, X);
      si[2] = integral_R_r2_re<double, D>(a, b, c, d, X);
      si[3] = integral_R_rp_re<double, D>(a, b, c, d, p1, X);
      si[4] = integral_R_rp_re<double, D>(a, b, c, d, p2, X);
      si[5] = si[3];
      si[6] = si[4];
      si[7] = integral_R_rp_re_inf<double, D>(a, b, c, d, p1);
      si[8] = integral_R_rp_re_inf<double, D>(a, b, c, d, p2);
    } else {
      rr_time_terms(a, b, c, d, p1, p2, X, sh);
      rp_re_pair(a, b, c, d, p1, p2, re_sn(a, b, d, X), sh + 5);
      rp_re_pair(a, b, c, d, p1, p2, Sqrt((b - d) / (a - d)), sh + 7);
      si[0] = integral_R_r0_re(a, b, c, d, X);
      si[1] = integral_R_r1_re(a, b, c, d, X);
      si[2] = integral_R_r2_re(a, b, c, d, X);
      si[3] = integral_R_rp_re(a, b, c, d, p1, X);
      si[4] = integral_R_rp_re(a, b, c, d, p2, X);
      si[5] = si[3];
      si[6] = si[4];
      si[7] = integral_R_rp_re_inf(a, b, c, d, p1);
      si[8] = integral_R_rp_re_inf(a, b, c, d, p2);
    }
  }
}

// the crossing map of one order in two passes (two != 0; bins gets each
// work bin's hits) or through crossing_pixel, at the fixed depth
// (adaptive 0), Carlson's rule (1), or Carlson's rule with no shared
// values (2, one pass only)
extern "C" void crossing(int two, int adaptive, double a, double incl,
                         double rmax, double rms, int n, int order,
                         const double* gauss, double* r, double* phi,
                         double* g, double* dt, unsigned char* hit,
                         int* bins) {
  const sim5::GaussRule q = rule(gauss);
  if (two && adaptive)
    crossing_two<sim5::AdaptiveDepth>(a, incl, rmax, rms, n, order, q, r, phi,
                                      g, dt, hit, bins);
  else if (two)
    crossing_two<sim5::FixedDepth>(a, incl, rmax, rms, n, order, q, r, phi, g,
                                   dt, hit, bins);
  else if (adaptive == 2)
    crossing_one<AdaptiveSingle>(a, incl, rmax, rms, n, order, q, r, phi, g,
                                 dt, hit);
  else if (adaptive)
    crossing_one<sim5::AdaptiveDepth>(a, incl, rmax, rms, n, order, q, r, phi,
                                      g, dt, hit);
  else
    crossing_one<sim5::FixedDepth>(a, incl, rmax, rms, n, order, q, r, phi, g,
                                   dt, hit);
}

// the seed with the azimuth (f64 or f32) in two passes or through
// seed_pixel, the depth as crossing()'s
extern "C" void seed(int two, int adaptive, int f64, double a, double incl,
                     double rmax, double r_start, int n, const double* gauss,
                     void* x0, void* k, unsigned char* ok, int* bins) {
  const sim5::GaussRule q = rule(gauss);
  using A = sim5::AdaptiveDepth;
  using F = sim5::FixedDepth;
  double *xd = static_cast<double*>(x0), *kd = static_cast<double*>(k);
  float *xf = static_cast<float*>(x0), *kf = static_cast<float*>(k);
  if (f64) {
    if (two)
      adaptive ? seed_two<double, A>(a, incl, rmax, r_start, 0.0, n, q, xd, kd,
                                     ok, bins)
               : seed_two<double, F>(a, incl, rmax, r_start, 0.0, n, q, xd, kd,
                                     ok, bins);
    else if (adaptive == 2)
      seed_one<double, AdaptiveSingle>(a, incl, rmax, r_start, 0.0, n, q, xd,
                                       kd, ok);
    else if (adaptive)
      seed_one<double, A>(a, incl, rmax, r_start, 0.0, n, q, xd, kd, ok);
    else
      seed_one<double, F>(a, incl, rmax, r_start, 0.0, n, q, xd, kd, ok);
  } else {
    if (two)
      adaptive ? seed_two<float, A>(a, incl, rmax, r_start, 0.0, n, q, xf, kf,
                                    ok, bins)
               : seed_two<float, F>(a, incl, rmax, r_start, 0.0, n, q, xf, kf,
                                    ok, bins);
    else if (adaptive == 2)
      seed_one<float, AdaptiveSingle>(a, incl, rmax, r_start, 0.0, n, q, xf,
                                      kf, ok);
    else if (adaptive)
      seed_one<float, A>(a, incl, rmax, r_start, 0.0, n, q, xf, kf, ok);
    else
      seed_one<float, F>(a, incl, rmax, r_start, 0.0, n, q, xf, kf, ok);
  }
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
    tmp = tmp_path_factory.mktemp("analytic_adaptive")
    src, so = tmp / "harness.cpp", tmp / "libharness.so"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(_build.CSRC), "-o", str(so), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    dll = ctypes.CDLL(str(so))
    dll.special.argtypes = [_I, _I, _I, _P, _P, _P]
    dll.crossing.argtypes = [_I, _I] + [_D] * 4 + [_I, _I] + [_P] * 7
    dll.seed.argtypes = [_I, _I, _I] + [_D] * 4 + [_I] + [_P] * 5
    dll.rr_terms.argtypes = [_I, _I, _P, _P, _P]
    for f in (dll.special, dll.crossing, dll.seed, dll.rr_terms):
        f.restype = None
    return dll


def _ptr(a):
    return a.ctypes.data


# --- the special functions, adaptive against fixed

def _tuples(name, rng, n=48):
    """n argument tuples of `name` (4 columns) that stress the depth."""
    u = lambda lo, hi, k=n: rng.uniform(lo, hi, k)
    lg = lambda lo, hi, k=n: 10.0 ** rng.uniform(lo, hi, k)
    k = n // 4
    one = np.ones(k)
    if name in ("rf", "rf_rd_f", "rf_rd_d", "rd"):
        rows = [
            # the floors, m -> 1, generic
            np.stack([np.zeros(k), u(0.0, 1.0, k), one, one], -1),
            np.stack([np.full(k, 1e-310), lg(-300, -200, k), one, one], -1),
            np.stack([np.zeros(k), lg(-16, -6, k), one, one], -1),
            np.stack([u(0, 3, k), u(0.1, 3, k), u(0.1, 3, k), one], -1),
        ]
    elif name == "rc":
        rows = [
            # the floor, the principal value, y -> 0, x -> 0
            np.stack([np.zeros(k), u(0.1, 3.0, k), one, one], -1),
            np.stack([u(0.0, 3.0, k), -u(0.1, 3.0, k), one, one], -1),
            np.stack([u(0.0, 3.0, k), lg(-14, -4, k), one, one], -1),
            np.stack([lg(-300, -100, k), u(0.1, 3, k), one, one], -1),
        ]
    else:   # rj
        m1 = lg(-15, -6, k)
        rows = [
            # m -> 1, p -> 0+, p -> 0-, generic (p < 0 on half)
            np.stack([np.zeros(k), m1, one, u(0.1, 2.0, k)], -1),
            np.stack([u(0, 1, k), u(0.1, 1, k), one, lg(-14, -3, k)], -1),
            np.stack([u(0, 1, k), u(0.1, 1, k), one, -lg(-14, -3, k)], -1),
            np.stack([u(0, 3, k), u(0.1, 3, k), u(0.1, 3, k),
                      np.where(rng.random(k) < 0.5, -1, 1) * u(0.1, 3, k)], -1),
        ]
    return np.ascontiguousarray(np.concatenate(rows))


WHICH = {"rf": 0, "rc": 1, "rj": 2, "rd": 3, "rf_rd_f": 4, "rf_rd_d": 5}


def _special(lib, name, adaptive, x):
    out = np.empty(len(x))
    lev = np.empty(len(x), np.int32)
    lib.special(WHICH[name], int(adaptive), len(x), _ptr(x), _ptr(out),
                _ptr(lev))
    return out, lev


# the plain torch version of each (special/carlson.py, the JAX package's
# fixed depth) and its arguments' columns
PLAIN = {"rf": (tsp.rf, 3), "rc": (tsp.rc, 2), "rj": (tsp.rj, 4),
         "rd": (tsp.rd, 3), "rf_rd_f": (tsp.rf, 3), "rf_rd_d": (tsp.rd, 3)}


@pytest.mark.parametrize("name", list(WHICH))
def test_adaptive_special_function(lib, name):
    """Carlson's rule against the plain torch function (its fixed 16
    levels): within 1e-13 relative (of the value, or of 1e-3 of the
    largest) plus 4x the plain version's change under a one-ulp move of
    its arguments; finite where the plain one is; at most 16 levels a
    chain (the fixed policy 16 on every call), and on the generic quarter
    of the tuples fewer than 16 on average."""
    rng = np.random.default_rng(sorted(WHICH).index(name))
    x = _tuples(name, rng)
    _, lev_f = _special(lib, name, False, x)
    got, lev = _special(lib, name, True, x)
    fn, ncol = PLAIN[name]
    cols = [torch.from_numpy(np.ascontiguousarray(x[:, c]))
            for c in range(ncol)]
    # the values and the one-ulp moves in one call of the plain version
    vals = fn(*(torch.cat([t, t * (1.0 + EPS64), t * (1.0 - EPS64)])
                for t in cols)).numpy().reshape(3, -1)
    want = vals[0]
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), name
    fin = np.isfinite(want)
    assert fin.mean() > 0.9
    cond = np.maximum(np.abs(vals[1] - want), np.abs(vals[2] - want))
    scale = np.maximum(np.abs(want[fin]), 1e-3 * np.abs(want[fin]).max())
    err = np.abs(got[fin] - want[fin]) / (1e-13 * scale + 4.0 * cond[fin])
    assert float(err.max()) <= 1.0, f"{name}: {err.max():.3f} of the bound"
    assert int(lev.max()) <= 16 and int(lev_f.min()) == 16
    generic = lev[-(len(x) // 4):]
    assert float(generic.mean()) < 12.0, float(generic.mean())


@pytest.mark.parametrize("adaptive", [False, True])
def test_rr_terms_share_bitwise(lib, adaptive):
    """The RR integrals at one point computed with their shared u,
    sncndn(u) and Pi (rr_time_terms, rp_re_pair: the azimuth's and the
    delay's RR terms) give the single integrals' bits, on 64 RR root
    tuples, points X beyond the largest root and the horizon poles p."""
    rng = np.random.default_rng(7)
    n = 64
    four = np.sort(rng.uniform(-1.0, 8.0, (n, 4)), 1)[:, ::-1]
    a4, b4, c4, d4 = four.T + np.array([[3.0], [1.5], [0.5], [0.0]])
    x = np.ascontiguousarray(np.stack(
        [a4, b4, c4, d4, a4 + rng.uniform(0.1, 30.0, n),
         d4 - rng.uniform(0.1, 1.0, n), d4 - rng.uniform(1.0, 2.0, n)], -1))
    shared, single = np.empty((n, 9)), np.empty((n, 9))
    lib.rr_terms(int(adaptive), n, _ptr(x), _ptr(shared), _ptr(single))
    assert np.isfinite(single).all()
    assert np.array_equal(shared.view(np.uint64), single.view(np.uint64))


@pytest.mark.parametrize("case", ["spot", "shadow"])
def test_shared_values_are_bitwise(lib, case):
    """At Carlson's rule the azimuth and the delay compute the values their
    integrals share once (the RR map, the theta terms' complete
    integrals): the crossing map (orders 0, 1) and the seed (f64, f32)
    bitwise those whose integrals each compute their own."""
    cfg = CASES[case]
    for order in (0, 1):
        shared, _ = _crossing(lib, cfg, order, False, 1)
        single, _ = _crossing(lib, cfg, order, False, 2)
        for x, y in zip(shared, single):
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), order
    for dtype in (np.float64, np.float32):
        shared, _ = _seed(lib, cfg, dtype, False, 1)
        single, _ = _seed(lib, cfg, dtype, False, 2)
        for x, y in zip(shared, single):
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), dtype


# --- the operation counter at both depths

@pytest.mark.parametrize("kind", ["crossing", "seed"])
def test_adaptive_counts_fewer_operations(kind):
    """The SPOT crossing map (orders 0 and 1) and seed (f64, with the
    azimuth) at 16^2: Carlson's rule counts fewer f64 operations and
    square roots than the fixed depth, the geometry pass the same, every
    chain at most 16 levels, and the outputs the two-pass harness's
    neighbours (test below) at either depth."""
    kw = dict(orders=(0, 1)) if kind == "crossing" else dict(
        r_start=SPOT["r_start"])
    counts = {ad: kernel_analytic.operation_counts(
        kind, SPOT["a"], SPOT["incl"], 16, SPOT["rmax"], threads=2,
        adaptive=ad, **kw)[0] for ad in (False, True)}
    new, old = counts[True], counts[False]
    assert sum(new["f64"].values()) < 0.6 * sum(old["f64"].values())
    assert new["f64"]["sqrt"] < old["f64"]["sqrt"]
    assert new["passes"][0] == old["passes"][0]
    for c, v in new["levels"].items():
        assert v["deepest"] <= 16, c
        assert old["levels"][c]["deepest"] in (0, 16), c
    assert new["levels"]["RJ"]["calls"] > 0
    assert new["levels"]["RC"]["calls"] < old["levels"]["RC"]["calls"]


# --- the two passes emulated on the host

def _crossing(lib, cfg, order, two, adaptive):
    a, incl, rmax = cfg["a"], cfg["incl"], cfg["rmax"]
    rms = float(r_ms(torch.tensor(a, dtype=torch.float64)))
    out = [np.empty((NPIX, NPIX)) for _ in range(4)]
    hit = np.empty((NPIX, NPIX), np.uint8)
    bins = np.zeros(8, np.int32)
    lib.crossing(int(two), int(adaptive), a, incl, rmax, rms, NPIX, order,
                 _ptr(GAUSS), *(_ptr(o) for o in out), _ptr(hit), _ptr(bins))
    return out + [hit], bins


def _seed(lib, cfg, dtype, two, adaptive):
    x0 = np.empty((NPIX, NPIX, 4), dtype)
    k = np.empty_like(x0)
    ok = np.empty((NPIX, NPIX), np.uint8)
    bins = np.zeros(8, np.int32)
    lib.seed(int(two), int(adaptive), int(dtype == np.float64), cfg["a"],
             cfg["incl"], cfg["rmax"], cfg["r_start"], NPIX, _ptr(GAUSS),
             _ptr(x0), _ptr(k), _ptr(ok), _ptr(bins))
    return [x0, k, ok], bins


def _bins_text(bins):
    names = [f"{t}{' vortical' if v else ''}"
             for t in kernel_analytic.TYPE_BINS for v in (0, 1)]
    return {n: int(b) for n, b in zip(names, bins) if b}


# the bins (type, vortical) each case's lists must hold somewhere across
# the crossing map's orders and the seed: RR, RC, CC and vortical lanes
WANT_BINS = {"spot": {0, 4}, "shadow": {4, 5, 7}}


@pytest.mark.parametrize("case", ["spot", "shadow"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_two_passes_are_the_pixel_bitwise(lib, case, adaptive):
    """Classify, list by bin, then the hits in bin order: bitwise
    crossing_pixel for orders 0 and 1; the seed's geometry, list and
    azimuth passes bitwise seed_pixel in f64 and f32; the lists hold the
    case's trajectory types (RR and RC on the spot, RC, CC and vortical
    lanes in the shadow)."""
    cfg = CASES[case]
    seen = set()
    for order in (0, 1):
        two, bins = _crossing(lib, cfg, order, True, adaptive)
        one, _ = _crossing(lib, cfg, order, False, adaptive)
        for name, x, y in zip(("r", "phi", "g", "dt", "hit"), two, one):
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
                (order, name)
        assert int(bins.sum()) == int(one[4].sum())
        seen |= set(np.flatnonzero(bins))
    for dtype in (np.float64, np.float32):
        two, bins = _seed(lib, cfg, dtype, True, adaptive)
        one, _ = _seed(lib, cfg, dtype, False, adaptive)
        for name, x, y in zip(("x0", "k", "ok"), two, one):
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
                (dtype, name)
        seen |= set(np.flatnonzero(bins))
    assert WANT_BINS[case] <= seen, _bins_text(np.bincount(
        list(seen), minlength=8))
