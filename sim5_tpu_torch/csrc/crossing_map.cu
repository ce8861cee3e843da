// The equatorial crossing map: for every pixel of an n x n image and each
// image order of a list, the crossing's radius, azimuth, Keplerian
// g-factor, travel-time delay and hit, in double.
//
// Replaces no Pallas kernel: the XLA program equatorial_crossing_map
// (sim5_tpu/render/lightcurve.py:33-75), which eager PyTorch runs as about
// 890000 launches a map.  Its plain torch version is
// render/lightcurve.py:_crossing_map_unanchored.  The anchor, the delay
// minus its minimum over the hit pixels of an order, is one masked
// reduction that the caller runs on the device
// (lightcurve.equatorial_crossing_map), as the JAX program computes it
// outside any Pallas kernel.
//
// What bounds it: FP64 operations, thousands a hit pixel, most of them in
// Carlson duplication chains where each level waits on the one before, and
// their square roots and divisions, which Hopper runs as sequences of FP64
// instructions; against 33 bytes a pixel written.  The design:
// - two passes over both orders at once (blockIdx.y the order): a classify
//   pass, one pixel a thread (sim5::crossing_geometry: geodesic_init_inf,
//   the midplane crossing of its order, the radius inversion, gfactorK and
//   the ISCO test), writes r, g, hit and the misses' phi = delay = 0, and
//   appends each hit, with its geodesic, to a work list by trajectory type
//   (worklist.cuh), twice: its delay (the travel time from R_FAR, about
//   70% of a hit's cycles) and its azimuth are two entries; a hit pass of
//   persistent blocks takes the list in order, the delays first, each part
//   by type, CC last, and runs sim5::crossing_delay or
//   sim5::crossing_azimuth on warps of one part and type.  Each hit's phi
//   and delay are those sim5::crossing_pixel computes.  The two entries a
//   hit fill more of the card than one (the 192^2 map's hits make about
//   1250 warps against the 2112 a card holds at 16 an SM) and halve the
//   longest warp's chain;
// - the azimuth and the delay run their Carlson chains at
//   sim5::AdaptiveDepth: each lane stops at Carlson's rule, and RJ's term
//   is RC in closed form (azimuth.cuh);
// - each pass has its own threads and minimum blocks an SM.
// Built with --fmad=false (analytic.cuh) and without fast math.
//
// The counted instance (-DSIM5_COUNTED, a library of its own; entry points
// never launch it) runs these two passes with probes that time each stage
// and count each Carlson chain's levels (worklist.cuh).

#include "worklist.cuh"

namespace {

constexpr int kMaxOrders = 8;
// cards whose resident blocks of the hit pass are kept
constexpr int kMaxDevices = 16;
// threads a block and minimum resident blocks an SM of each pass
// (__launch_bounds__), chosen by timing pairs in one call
// (chip_smoke.py --tune-analytic; PERF.md)
constexpr int kClassifyThreads = 128, kClassifyMinBlocks = 5;
constexpr int kHitThreads = 64, kHitMinBlocks = 8;
// the work list's entries a hit: its delay and its azimuth
constexpr int kParts = 2;

struct Orders {
  int k[kMaxOrders];
};

// a hit's geometry, from the classify pass to the hit pass
struct HitGeom {
  sim5::Geod<double> g;
  double P, r;
  static constexpr int kPlanes = sim5::work::kGeodFields + 2;
  template <typename F>
  __device__ void each(F&& f) {
    sim5::work::geod_fields(g, f);
    f(P);
    f(r);
  }
};
using Work = sim5::work::Work<HitGeom>;

// r, phi, g, dt: (orders, n, n) doubles; hit: (orders, n, n) bools
template <typename S>
__global__ void __launch_bounds__(kClassifyThreads, kClassifyMinBlocks)
crossing_classify(double a, double incl, double rmax, double rms, int n,
                  const Orders orders, Work w, double* __restrict__ r,
                  double* __restrict__ phi, double* __restrict__ g,
                  double* __restrict__ dt, bool* __restrict__ hit) {
  const long long npix = (long long)n * n;
  const long long i = (long long)blockIdx.x * kClassifyThreads + threadIdx.x;
  const bool in = i < npix;
  const int iy = in ? (int)(i / n) : 0, ix = in ? (int)(i % n) : 0;
  const double cos_i = sim5::Cos(incl), sin_i = sim5::Sin(incl);
  HitGeom e;
  double gf = 1.0;
  bool h = false;
  S st;
  st.begin();
  if (in)
    h = sim5::crossing_geometry(a, incl, cos_i, sin_i, rmax, rms,
                                orders.k[blockIdx.y], ix, iy, n, e.g, e.P,
                                e.r, gf);
  st.end(sim5::kStageGeometry, in);
  const long long o = blockIdx.y * npix + i;
  if (in) {
    r[o] = e.r;
    g[o] = h ? gf : 1.0;
    hit[o] = h;
    if (h) {
      w.put(o, e);
    } else {
      phi[o] = 0.0;
      dt[o] = 0.0;
    }
  }
  // the delay (bins 0-7), then the azimuth (bins 8-15): the longer part
  // first
  const int bin = h ? sim5::work_bin(e.g) : 0;
  sim5::work::append(h, bin, 2 * o + 1, w.l);
  sim5::work::append(h, sim5::kWorkBins + bin, 2 * o, w.l);
}

// phi or dt of the listed hits (persistent blocks): an entry 2 o + 1 is
// hit o's delay, 2 o its azimuth
template <typename D, typename S>
__global__ void __launch_bounds__(kHitThreads, kHitMinBlocks)
crossing_hits(int n, double rmax, const __grid_constant__ sim5::GaussRule q,
              Work w, double* __restrict__ phi, double* __restrict__ dt) {
  const long long npix = (long long)n * n;
  S st;
  sim5::work::for_each_entry(w.l, [&](bool live, long long entry) {
    const long long o = live ? entry >> 1 : 0;
    const bool delay = live && (entry & 1), azimuth = live && !(entry & 1);
    const HitGeom e = w.get(o);
    const long long i = o % npix;
    const double vphi =
        sim5::crossing_azimuth<double, D>(azimuth, e.g, e.P, e.r, q, st);
    const double vdt = sim5::crossing_delay<double, D>(
        delay, e.g, e.P, e.r, (int)(i % n), (int)(i / n), n, rmax, q, st);
    if (azimuth) phi[o] = vphi;
    if (delay) dt[o] = vdt;
  });
}

// pixels of the work of n_orders maps of n x n
long long work_cap(int n, int n_orders) {
  return (long long)n * n * n_orders;
}

sim5::GaussRule rule_of(const double* gauss) {
  sim5::GaussRule q;
  for (int k = 0; k < 16; ++k) {
    q.x[k] = gauss[k];
    q.w[k] = gauss[16 + k];
  }
  for (int k = 0; k < 7; ++k) q.edges[k] = gauss[32 + k];
  return q;
}

// the two passes, probes S, depth D
template <typename D, typename S>
int run(double a, double incl, double rmax, double rms, int n, int n_orders,
        const int* orders, const double* gauss, void* r, void* phi, void* g,
        void* dt, void* hit, void* work, cudaStream_t s) {
  if (n_orders < 1 || n_orders > kMaxOrders || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = work_cap(n, n_orders);
  Orders o = {};
  for (int k = 0; k < n_orders; ++k) o.k[k] = orders[k];
  const Work w = sim5::work::carve<HitGeom>(work, cap, kParts);
  double* phi_ = static_cast<double*>(phi);
  double* dt_ = static_cast<double*>(dt);
  sim5::work::reset(w, s);
  const long long npix = (long long)n * n;
  const dim3 grid((unsigned)((npix + kClassifyThreads - 1) / kClassifyThreads),
                  (unsigned)n_orders);
  crossing_classify<S><<<grid, kClassifyThreads, 0, s>>>(
      a, incl, rmax, rms, n, o, w, static_cast<double*>(r), phi_,
      static_cast<double*>(g), dt_, static_cast<bool*>(hit));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  static int blocks[kMaxDevices] = {};
  const int b = sim5::work::resident_blocks(crossing_hits<D, S>, kHitThreads,
                                            blocks);
  crossing_hits<D, S><<<b, kHitThreads, 0, s>>>(n, rmax, rule_of(gauss), w,
                                                phi_, dt_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The work buffer's bytes for n_orders maps of n x n into *bytes (device
// memory the caller allocates: the lists and the hits' geometry, about
// 272 bytes a pixel and order); returns cudaErrorInvalidValue for no
// pixel or order.
extern "C" int sim5_crossing_map_work(int n, int n_orders, long long* bytes) {
  if (n < 1 || n_orders < 1) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = sim5::work::bytes(work_cap(n, n_orders), kParts, HitGeom::kPlanes);
  return 0;
}

#if !defined(SIM5_COUNTED)
// The crossing maps of n_orders image orders (orders[0..n_orders)) of an
// n x n image of half-width rmax, spin a, inclination incl [rad], ISCO rms,
// on `stream`: the classify pass, then the hit pass.  gauss holds the CC rule's 16 nodes, 16 weights and 7
// panel edges (sim5::GaussRule, host memory).  r, phi, g and dt are
// (n_orders, n, n) doubles on the card, hit (n_orders, n, n) bools; dt is
// the delay before its anchoring; work is sim5_crossing_map_work's bytes
// on the card.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for more than kMaxOrders orders.
extern "C" int sim5_crossing_map(double a, double incl, double rmax,
                                 double rms, int n, int n_orders,
                                 const int* orders, const double* gauss,
                                 void* r, void* phi, void* g, void* dt,
                                 void* hit, void* work, void* stream) {
  return run<sim5::AdaptiveDepth, sim5::NoStage>(
      a, incl, rmax, rms, n, n_orders, orders, gauss, r, phi, g, dt, hit,
      work, static_cast<cudaStream_t>(stream));
}

// registers a thread, local memory a thread (bytes), resident blocks an SM
// and threads a block of the classify pass (pass 0) or the hit pass (1)
// into out[0..3]; returns the CUDA error
extern "C" int sim5_crossing_map_attributes(int pass, int* out) {
  return pass == 0
             ? sim5::work::attributes(crossing_classify<sim5::NoStage>,
                                      kClassifyThreads, out)
             : sim5::work::attributes(
                   crossing_hits<sim5::AdaptiveDepth, sim5::NoStage>,
                   kHitThreads, out);
}
#else
// The crossing maps as sim5_crossing_map's, through the counted instances
// of the two passes (AdaptiveDepth, with the stage probes).  Synchronizes
// the stream and writes the counters (worklist.cuh: kStages x [warps,
// lanes, cycles], then kChainKinds x [warp calls, lane calls, levels,
// levels issued]) into counters (host memory).
extern "C" int sim5_crossing_map_counted(double a, double incl, double rmax,
                                         double rms, int n, int n_orders,
                                         const int* orders,
                                         const double* gauss, void* r,
                                         void* phi, void* g, void* dt,
                                         void* hit, void* work, void* stream,
                                         long long* counters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sim5::counted::clear(s);
  const int rc =
      run<sim5::counted::CountedDepth<sim5::AdaptiveDepth>,
          sim5::counted::StageProbe>(a, incl, rmax, rms, n, n_orders, orders,
                                     gauss, r, phi, g, dt, hit, work, s);
  if (rc != 0) return rc;
  return static_cast<int>(sim5::counted::read(counters, s));
}
#endif
