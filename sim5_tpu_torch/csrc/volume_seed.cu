// The volume seed: every pixel's ray of an n x n image placed on its
// analytic geodesic at the sphere r = r_start, one pixel a thread.
//
// Replaces no Pallas kernel: the three XLA programs _volume_seed_geom,
// _volume_seed_azm and _volume_seed_pack (sim5_tpu/render/lightcurve.py:
// 113-167), which eager PyTorch runs as about 317000 launches for the
// azimuth stage alone.  Each thread runs sim5::seed_pixel (azimuth.cuh):
// geodesic_init_inf, P_int(r_start) and the radial and poloidal
// inversions in T; with kAzm the azimuth in double, rounded to T once
// (without, phi0 = 0: the axisymmetric seed); the momentum with the march's
// k^theta sign, and the dummy ray of an invalid pixel.  It writes x0 (4),
// k (4) and ok; raytrace_prepare, a few torch ops, makes the march state
// from them.  Its plain torch version is
// render/lightcurve.py:_volume_seed_plain.
//
// What bounds it: with kAzm, FP64 operations (the azimuth's radial
// integrals and theta term, tens of thousands a pixel); without, the
// geometry's few thousand operations in T.  Built with --fmad=false
// (analytic.cuh) and without fast math.

#include <cuda_runtime.h>

#include "azimuth.cuh"

namespace {

constexpr int kThreads = 128;

// x0, k: (n, n, 4) of T; ok: (n, n) bools
template <typename T, bool kAzm>
__global__ void __launch_bounds__(kThreads)
volume_seed(T a, T incl, T rmax, T r_start, T t0, int n,
            const __grid_constant__ sim5::GaussRule q, T* __restrict__ x0,
            T* __restrict__ k, bool* __restrict__ ok) {
  const long long npix = (long long)n * n;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int iy = (int)(i / n), ix = (int)(i % n);
  const T cos_i = sim5::Cos(incl), sin_i = sim5::Sin(incl);
  T vx[4], vk[4];
  bool vok;
  sim5::seed_pixel<T, kAzm>(a, incl, cos_i, sin_i, rmax, r_start, t0, ix, iy,
                            n, q, vx, vk, vok);
  for (int c = 0; c < 4; ++c) {
    x0[4 * i + c] = vx[c];
    k[4 * i + c] = vk[c];
  }
  ok[i] = vok;
}

template <typename T, bool kAzm>
int launch(double a, double incl, double rmax, double r_start, double t0,
           int n, const sim5::GaussRule& q, void* x0, void* k, void* ok,
           cudaStream_t stream) {
  const long long npix = (long long)n * n;
  volume_seed<T, kAzm><<<(unsigned)((npix + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      T(a), T(incl), T(rmax), T(r_start), T(t0), n, q, static_cast<T*>(x0),
      static_cast<T*>(k), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAzm>
int attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, (const void*)volume_seed<T, kAzm>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, volume_seed<T, kAzm>, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}

}  // namespace

// The seed of an n x n image of half-width rmax, spin a, inclination incl
// [rad], on the sphere r_start at time t0, on `stream`: volume_seed<T, azm
// != 0>, T double if f64, else float (the scalars rounded to T on the
// card, as torch casts them).  gauss holds the CC rule (sim5::GaussRule,
// host memory).  x0 and k are (n, n, 4) of T on the card, ok (n, n)
// bools.  Returns cudaGetLastError() (0 on success).
extern "C" int sim5_volume_seed(int f64, int azm, double a, double incl,
                                double rmax, double r_start, double t0, int n,
                                const double* gauss, void* x0, void* k,
                                void* ok, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  sim5::GaussRule q;
  for (int j = 0; j < 16; ++j) {
    q.x[j] = gauss[j];
    q.w[j] = gauss[16 + j];
  }
  for (int j = 0; j < 7; ++j) q.edges[j] = gauss[32 + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return azm ? launch<double, true>(a, incl, rmax, r_start, t0, n, q, x0, k,
                                      ok, s)
               : launch<double, false>(a, incl, rmax, r_start, t0, n, q, x0,
                                       k, ok, s);
  return azm ? launch<float, true>(a, incl, rmax, r_start, t0, n, q, x0, k,
                                   ok, s)
             : launch<float, false>(a, incl, rmax, r_start, t0, n, q, x0, k,
                                    ok, s);
}

// registers a thread, local memory a thread (bytes) and resident blocks an
// SM of volume_seed<T, azm != 0>, T double if f64, else float, into
// out[0..2]; returns the CUDA error
extern "C" int sim5_volume_seed_attributes(int f64, int azm, int* out) {
  if (f64) return azm ? attributes<double, true>(out)
                      : attributes<double, false>(out);
  return azm ? attributes<float, true>(out) : attributes<float, false>(out);
}
