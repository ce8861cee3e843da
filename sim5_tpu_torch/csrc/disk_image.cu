// The Novikov-Thorne disk image, one pixel per thread, in one launch.
//
// Replaces no Pallas kernel: the XLA-fused jnp program
// sim5_tpu/render/image.py:35-75 (render_disk_image), which XLA fuses into
// a few programs on the TPU and which eager PyTorch would run as thousands
// of unfused ops.  Each thread forms its pixel's impact parameters in the
// expression order of image_grid, runs the geodesic_init_inf chain
// (quartic roots with the f32 rescale, sort, two-float polish, the R and
// T roots, RF and the K AGM), then for image order 0, and for order 1
// only where order 0 crossed the plane inside the ISCO, the midplane
// crossing, the radius inversion (one Jacobi AGM), the hit test, gfactorK
// and nt_flux, and writes image_f = F g^4 and image_g = g.  The device
// functions are in analytic.cuh; their plain torch versions are
// render/image.py:render_disk_image_reference and the modules it calls.
//
// What bounds it: FP64 (the parity instance) or FP32 (the fast instance)
// operations per pixel, thousands of them (RF duplications, AGMs, square
// roots, divisions), against at most 16 bytes a pixel written and 48
// bytes of frame scalars read.  The design keeps the whole ray in
// registers and local arrays, one branch per trajectory type in place of
// the torch version's masked evaluation of all types, and no loop that
// waits on convergence.
//
// The frame's scalars (spin, inclination, M, mdot, rms, rmax) are read
// from a small device tensor, never compiled in, so one build serves
// every frame and a frame costs no host round trip.  Built with
// --fmad=false (see analytic.cuh) and without fast math.

#include <cuda_runtime.h>

#include "analytic.cuh"

namespace {

constexpr int kThreads = 128;

// frame: a, incl, M, mdot, rms (the disk's edge, ISCO + 1e-3), rmax
template <typename T>
__global__ void __launch_bounds__(kThreads)
nt_image(const T* __restrict__ frame, T* __restrict__ image_f,
         T* __restrict__ image_g, int nx, int ny, T aspect) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)nx * ny) return;
  const int ix = (int)(i % nx), iy = (int)(i / nx);
  const T a = frame[0], incl = frame[1], M = frame[2], mdot = frame[3];
  const T rms_disk = frame[4], rmax = frame[5];
  // the reference compares against r_ms(a), not rms + 1e-3
  const T rms = rms_disk - T(1e-3);
  // image_grid: pixel centres, [0, 0] at the image centre
  const T fx = (T(ix) + T(0.5)) / T(nx) - T(0.5);
  const T fy = (T(iy) + T(0.5)) / T(ny) - T(0.5);
  const T alpha = fx * T(2) * rmax;
  const T beta = fy * T(2) * rmax * aspect;

  const sim5::Geod<T> g = sim5::init_inf(incl, a, alpha, beta);
  T f = T(0), gf = T(0);
  // the reference control flow (disk-image.c:73-104): no order-0 crossing
  // leaves the pixel dark; order 1 only where order 0 fell inside the ISCO
  for (int order = 0; order < 2; ++order) {
    const T P = sim5::find_midplane_crossing(g, order);
    if (order == 0 && !sim5::IsFinite(P)) break;
    const T r = sim5::position_rad(g, P);
    if (sim5::IsFinite(r) && r >= rms && g.status == sim5::kOk) {
      gf = sim5::gfactorK(r, a, g.l);
      const T g2 = gf * gf;
      f = sim5::NTFlux<T>(a, rms_disk, M, mdot)(r) * (g2 * g2);
      break;
    }
  }
  image_f[i] = f;
  image_g[i] = gf;
}

template <typename T>
int launch(const void* frame, void* image_f, void* image_g, int nx, int ny,
           double aspect, cudaStream_t stream) {
  const long long n = (long long)nx * ny;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  nt_image<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(frame), static_cast<T*>(image_f),
      static_cast<T*>(image_g), nx, ny, T(aspect));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)nt_image<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, nt_image<T>,
                                                    kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}

}  // namespace

// Render one (ny, nx) frame on `stream`: nt_image<double> if f64, else
// nt_image<float>.  frame holds six scalars of the image's type (a, incl,
// M, mdot, rms, rmax); image_f and image_g are (ny, nx) of that type;
// aspect is npix_y / npix_x.  Returns cudaGetLastError() (0 on success).
extern "C" int sim5_nt_image(int f64, const void* frame, void* image_f,
                             void* image_g, int nx, int ny, double aspect,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(frame, image_f, image_g, nx, ny, aspect, s)
             : launch<float>(frame, image_f, image_g, nx, ny, aspect, s);
}

// Registers a thread, local memory a thread (bytes) and resident blocks an
// SM of nt_image<double> (f64) or nt_image<float> into out[0..2]; returns
// the CUDA error.
extern "C" int sim5_nt_image_attributes(int f64, int* out) {
  return f64 ? attributes<double>(out) : attributes<float>(out);
}
