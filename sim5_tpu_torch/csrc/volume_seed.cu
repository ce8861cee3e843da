// The volume seed: every pixel's ray of an n x n image placed on its
// analytic geodesic at the sphere r = r_start.
//
// Replaces no Pallas kernel: the three XLA programs _volume_seed_geom,
// _volume_seed_azm and _volume_seed_pack (sim5_tpu/render/lightcurve.py:
// 113-167), which eager PyTorch runs as about 317000 launches for the
// azimuth stage alone.  It writes x0 (4), k (4) and ok; raytrace_prepare,
// a few torch ops, makes the march state from them.  Its plain torch
// version is render/lightcurve.py:_volume_seed_plain.
//
// What bounds it: with the azimuth, FP64 operations (its radial integrals
// and theta term: thousands a pixel, most in Carlson chains whose square
// roots and divisions Hopper runs as FP64 sequences); without, the
// geometry's few thousand operations in T.  The design, as the crossing
// map's (crossing_map.cu):
// - a geometry pass, one pixel a thread (sim5::seed_geometry:
//   geodesic_init_inf, P_int(r_start), the radial and poloidal inversions
//   and the momentum in T), writes x0 with phi0 = 0, k and ok, or an
//   invalid pixel's dummy ray.  That is the whole axisymmetric seed
//   (seed_geometry<T, false>).  With the azimuth it also appends each valid
//   pixel, with its geodesic, to a work list by trajectory type
//   (worklist.cuh);
// - an azimuth pass of persistent blocks takes the list in type order and
//   runs sim5::seed_azimuth: phi0 in double at sim5::AdaptiveDepth, rounded
//   to T once, or the dummy ray where it is not finite.  Each pixel's
//   outputs are those sim5::seed_pixel computes.
// Built with --fmad=false (analytic.cuh) and without fast math.
//
// The counted instance (-DSIM5_COUNTED; entry points never launch it) runs
// the two passes of the f64 seed with the azimuth with probes that time
// each stage and count each Carlson chain's levels (worklist.cuh).

#include "worklist.cuh"

namespace {

// threads a block and minimum resident blocks an SM of each pass
// (__launch_bounds__), chosen by timing pairs in one call
// (chip_smoke.py --tune-analytic; PERF.md)
constexpr int kGeomThreads = 128, kGeomMinBlocks = 4;
constexpr int kAzmThreads = 128, kAzmMinBlocks = 6;
// the work list's entries a valid pixel: its azimuth
constexpr int kParts = 1;
// cards whose resident blocks of the azimuth pass are kept
constexpr int kMaxDevices = 16;

// a valid pixel's geometry, from the geometry pass to the azimuth pass
template <typename T>
struct SeedGeom {
  sim5::Geod<T> g;
  T P0;
  static constexpr int kPlanes = sim5::work::kGeodFields + 1;
  template <typename F>
  __device__ void each(F&& f) {
    sim5::work::geod_fields(g, f);
    f(P0);
  }
};
template <typename T>
using Work = sim5::work::Work<SeedGeom<T>>;

// x0, k: (n, n, 4) of T; ok: (n, n) bools
template <typename T, bool kAzm, typename S>
__global__ void __launch_bounds__(kGeomThreads, kGeomMinBlocks)
seed_geometry(T a, T incl, T rmax, T r_start, T t0, int n, Work<T> w,
              T* __restrict__ x0, T* __restrict__ k, bool* __restrict__ ok) {
  const long long npix = (long long)n * n;
  const long long i = (long long)blockIdx.x * kGeomThreads + threadIdx.x;
  const bool in = i < npix;
  const int iy = in ? (int)(i / n) : 0, ix = in ? (int)(i % n) : 0;
  const T cos_i = sim5::Cos(incl), sin_i = sim5::Sin(incl);
  SeedGeom<T> e;
  T vx[4], vk[4];
  bool valid = false;
  S st;
  st.begin();
  if (in)
    valid = sim5::seed_geometry(a, incl, cos_i, sin_i, rmax, r_start, t0, ix,
                                iy, n, e.g, e.P0, vx, vk);
  st.end(sim5::kStageGeometry, in);
  if (in) {
    for (int c = 0; c < 4; ++c) {
      x0[4 * i + c] = vx[c];
      k[4 * i + c] = vk[c];
    }
    ok[i] = valid;
    if (kAzm && valid) w.put(i, e);
  }
  if (kAzm)
    sim5::work::append(valid, valid ? sim5::work_bin(e.g) : 0, i, w.l);
}

// phi0 of the listed pixels (persistent blocks); the dummy ray where it
// is not finite
template <typename T, typename D, typename S>
__global__ void __launch_bounds__(kAzmThreads, kAzmMinBlocks)
seed_azimuth(T r_start, const __grid_constant__ sim5::GaussRule q, Work<T> w,
             T* __restrict__ x0, T* __restrict__ k, bool* __restrict__ ok) {
  S st;
  sim5::work::for_each_entry(w.l, [&](bool live, long long o) {
    const long long i = live ? o : 0;
    const SeedGeom<T> e = w.get(i);
    T vx[4], vk[4];
    for (int c = 0; c < 4; ++c) {
      vx[c] = x0[4 * i + c];
      vk[c] = T(0);
    }
    const bool v =
        sim5::seed_azimuth<T, D>(live, e.g, e.P0, r_start, q, vx, vk, st);
    if (!live) return;
    if (v) {
      x0[4 * i + 3] = vx[3];
      return;
    }
    for (int c = 0; c < 4; ++c) {
      x0[4 * i + c] = vx[c];
      k[4 * i + c] = vk[c];
    }
    ok[i] = false;
  });
}

sim5::GaussRule rule_of(const double* gauss) {
  sim5::GaussRule q;
  for (int j = 0; j < 16; ++j) {
    q.x[j] = gauss[j];
    q.w[j] = gauss[16 + j];
  }
  for (int j = 0; j < 7; ++j) q.edges[j] = gauss[32 + j];
  return q;
}

// the passes (the axisymmetric seed has the geometry pass only), probes
// S, depth D
template <typename T, bool kAzm, typename D, typename S>
int run(double a, double incl, double rmax, double r_start, double t0, int n,
        const double* gauss, void* x0, void* k, void* ok, void* work,
        cudaStream_t s) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Work<T> w = kAzm ? sim5::work::carve<SeedGeom<T>>(
                               work, (long long)n * n, kParts)
                         : Work<T>{};
  T* x0_ = static_cast<T*>(x0);
  T* k_ = static_cast<T*>(k);
  bool* ok_ = static_cast<bool*>(ok);
  if (kAzm) sim5::work::reset(w, s);
  const long long npix = (long long)n * n;
  seed_geometry<T, kAzm, S>
      <<<(unsigned)((npix + kGeomThreads - 1) / kGeomThreads), kGeomThreads,
         0, s>>>(T(a), T(incl), T(rmax), T(r_start), T(t0), n, w, x0_, k_,
                 ok_);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !kAzm) return static_cast<int>(e);
  static int blocks[kMaxDevices] = {};
  const int b = sim5::work::resident_blocks(seed_azimuth<T, D, S>,
                                            kAzmThreads, blocks);
  seed_azimuth<T, D, S><<<b, kAzmThreads, 0, s>>>(T(r_start), rule_of(gauss),
                                                  w, x0_, k_, ok_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The work buffer's bytes of an n x n seed with the azimuth into *bytes
// (either f64: the list and the valid pixels' geometry, about 256 bytes a
// pixel); cudaErrorInvalidValue for no pixel.
extern "C" int sim5_volume_seed_work(int f64, int n, long long* bytes) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = sim5::work::bytes(n * (long long)n, kParts,
                             SeedGeom<double>::kPlanes);
  return 0;
}

#if !defined(SIM5_COUNTED)
// The seed of an n x n image of half-width rmax, spin a, inclination incl
// [rad], on the sphere r_start at time t0, on `stream`: T double if f64,
// else float (the scalars rounded to T on the card, as torch casts them);
// the geometry pass, then with azm != 0 the azimuth pass.  gauss holds the
// CC rule (sim5::GaussRule, host memory).  x0 and k are (n, n, 4) of T on
// the card, ok (n, n) bools, work sim5_volume_seed_work's bytes on the
// card (unused, and may be null, without the azimuth).  Returns
// cudaGetLastError() (0 on success).
extern "C" int sim5_volume_seed(int f64, int azm, double a, double incl,
                                double rmax, double r_start, double t0, int n,
                                const double* gauss, void* x0, void* k,
                                void* ok, void* work, void* stream) {
  using D = sim5::AdaptiveDepth;
  using S = sim5::NoStage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return azm ? run<double, true, D, S>(a, incl, rmax, r_start, t0, n, gauss,
                                         x0, k, ok, work, s)
               : run<double, false, D, S>(a, incl, rmax, r_start, t0, n,
                                          gauss, x0, k, ok, work, s);
  return azm ? run<float, true, D, S>(a, incl, rmax, r_start, t0, n, gauss, x0,
                                      k, ok, work, s)
             : run<float, false, D, S>(a, incl, rmax, r_start, t0, n, gauss,
                                       x0, k, ok, work, s);
}

// registers a thread, local memory a thread (bytes), resident blocks an SM
// and threads a block of the geometry pass seed_geometry<T, azm != 0>
// (pass 0) or the azimuth pass seed_azimuth<T> (pass 1), T double if f64,
// else float, into out[0..3]; returns the CUDA error
extern "C" int sim5_volume_seed_attributes(int f64, int azm, int pass,
                                           int* out) {
  using D = sim5::AdaptiveDepth;
  using S = sim5::NoStage;
  using sim5::work::attributes;
  if (pass == 1)
    return f64 ? attributes(seed_azimuth<double, D, S>, kAzmThreads, out)
               : attributes(seed_azimuth<float, D, S>, kAzmThreads, out);
  if (f64)
    return azm ? attributes(seed_geometry<double, true, S>, kGeomThreads, out)
               : attributes(seed_geometry<double, false, S>, kGeomThreads,
                            out);
  return azm ? attributes(seed_geometry<float, true, S>, kGeomThreads, out)
             : attributes(seed_geometry<float, false, S>, kGeomThreads, out);
}
#else
// The f64 seed with the azimuth as sim5_volume_seed's, through the counted
// instances of the two passes (AdaptiveDepth, with the stage probes).
// Synchronizes the stream and writes the counters (as
// sim5_crossing_map_counted's) into counters (host memory).
extern "C" int sim5_volume_seed_counted(double a, double incl, double rmax,
                                        double r_start, double t0, int n,
                                        const double* gauss, void* x0,
                                        void* k, void* ok, void* work,
                                        void* stream, long long* counters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sim5::counted::clear(s);
  const int rc =
      run<double, true, sim5::counted::CountedDepth<sim5::AdaptiveDepth>,
          sim5::counted::StageProbe>(a, incl, rmax, r_start, t0, n, gauss, x0,
                                     k, ok, work, s);
  if (rc != 0) return rc;
  return static_cast<int>(sim5::counted::read(counters, s));
}
#endif
