// The equatorial crossing map: for every pixel of an n x n image and each
// image order of a list, the crossing's radius, azimuth, Keplerian
// g-factor, travel-time delay and hit, in double, one pixel a thread.
//
// Replaces no Pallas kernel: the XLA program equatorial_crossing_map
// (sim5_tpu/render/lightcurve.py:33-75), which eager PyTorch runs as about
// 890000 launches a map.  Each thread runs sim5::crossing_pixel
// (azimuth.cuh): geodesic_init_inf, the midplane crossing of its order and
// the radius inversion, gfactorK and the ISCO test, and on a hit the
// azimuth (the radial integrals of the lane's own trajectory type and the
// folded theta term) and the travel time from the sphere R_FAR (P_int,
// the inversion there, the radial and poloidal time).  Its plain torch
// version is render/lightcurve.py:_crossing_map_unanchored.  The anchor,
// the delay minus its minimum over the hit pixels of an order, is one
// masked reduction that the caller runs on the device
// (lightcurve.equatorial_crossing_map), as the JAX program computes it
// outside any Pallas kernel.
//
// What bounds it: FP64 operations, tens of thousands a hit pixel (every
// Carlson RJ is 16 duplication levels of an RC of 16), in chains where
// each level waits on the one before, against 33 bytes a pixel written.
// blockIdx.y is the order, so a light curve's orders 0 and 1 are one
// launch.  Built with --fmad=false (analytic.cuh) and without fast math.

#include <cuda_runtime.h>

#include "azimuth.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOrders = 8;

struct Orders {
  int k[kMaxOrders];
};

// r, phi, g, dt: (orders, n, n) doubles; hit: (orders, n, n) bools
__global__ void __launch_bounds__(kThreads)
crossing_map(double a, double incl, double rmax, double rms, int n,
             const Orders orders, const __grid_constant__ sim5::GaussRule q,
             double* __restrict__ r, double* __restrict__ phi,
             double* __restrict__ g, double* __restrict__ dt,
             bool* __restrict__ hit) {
  const long long npix = (long long)n * n;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int iy = (int)(i / n), ix = (int)(i % n);
  const double cos_i = sim5::Cos(incl), sin_i = sim5::Sin(incl);
  double vr, vphi, vg, vdt;
  bool vhit;
  sim5::crossing_pixel(a, incl, cos_i, sin_i, rmax, rms,
                       orders.k[blockIdx.y], ix, iy, n, q, vr, vphi, vg, vdt,
                       vhit);
  const long long o = blockIdx.y * npix + i;
  r[o] = vr;
  phi[o] = vphi;
  g[o] = vg;
  dt[o] = vdt;
  hit[o] = vhit;
}

}  // namespace

// The crossing maps of n_orders image orders (orders[0..n_orders)) of an
// n x n image of half-width rmax, spin a, inclination incl [rad], ISCO rms,
// on `stream`.  gauss holds the CC rule's 16 nodes, 16 weights and 7 panel
// edges (sim5::GaussRule, host memory).  r, phi, g and dt are (n_orders,
// n, n) doubles on the card, hit (n_orders, n, n) bools; dt is the delay
// before its anchoring.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for more than kMaxOrders orders.
extern "C" int sim5_crossing_map(double a, double incl, double rmax,
                                 double rms, int n, int n_orders,
                                 const int* orders, const double* gauss,
                                 void* r, void* phi, void* g, void* dt,
                                 void* hit, void* stream) {
  if (n_orders < 1 || n_orders > kMaxOrders || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Orders o = {};
  for (int k = 0; k < n_orders; ++k) o.k[k] = orders[k];
  sim5::GaussRule q;
  for (int k = 0; k < 16; ++k) {
    q.x[k] = gauss[k];
    q.w[k] = gauss[16 + k];
  }
  for (int k = 0; k < 7; ++k) q.edges[k] = gauss[32 + k];
  const long long npix = (long long)n * n;
  const dim3 grid((unsigned)((npix + kThreads - 1) / kThreads),
                  (unsigned)n_orders);
  crossing_map<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, incl, rmax, rms, n, o, q, static_cast<double*>(r),
      static_cast<double*>(phi), static_cast<double*>(g),
      static_cast<double*>(dt), static_cast<bool*>(hit));
  return static_cast<int>(cudaGetLastError());
}

// registers a thread, local memory a thread (bytes) and resident blocks an
// SM of the kernel into out[0..2]; returns the CUDA error
extern "C" int sim5_crossing_map_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)crossing_map);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, crossing_map,
                                                    kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}
