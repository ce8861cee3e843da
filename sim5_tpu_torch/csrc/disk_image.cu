// The Novikov-Thorne disk image: n frames (a spin sweep, a fit's trial
// parameters) in one launch, one pixel per thread.
//
// Replaces no Pallas kernel: the XLA-fused jnp program
// sim5_tpu/render/image.py:35-75 (render_disk_image), which XLA fuses into
// a few programs on the TPU and which eager PyTorch would run as thousands
// of unfused ops; a batch of frames is the port's form of jax.vmap or
// jax.lax.map over it (bench.py's spin sweep).  Each thread forms its
// pixel's impact parameters in the expression order of image_grid, runs the
// geodesic_init_inf chain (quartic roots with the f32 rescale, sort,
// two-float polish, the R and T roots, RF and the K AGM), then for image
// order 0, and for order 1 only where order 0 crossed the plane inside the
// ISCO, the midplane crossing and the radius inversion (one Jacobi AGM),
// and shades a hit once: gfactorK and nt_flux, image_f = F g^4 and
// image_g = g.  The per-pixel function is sim5::nt_pixel (analytic.cuh);
// its plain torch version is render/image.py:render_disk_image_reference.
//
// What bounds it: FP64 (the parity instance) or FP32 (the fast instance)
// operations per pixel, thousands of them (RF duplications, AGMs, square
// roots, divisions), in chains where each level waits on the one before,
// against 16 bytes a pixel written.  The design:
// - a frame's constants (cos i, sin i, nt_flux's weights: an acos, five
//   cos and sin, a dozen divisions; sim5::make_frame) are computed once a
//   frame, not once a pixel, by a prologue kernel of one thread a frame,
//   nt_frames, into device memory that every pixel of the frame reads.
//   Computed once a block instead, by the block's first thread into shared
//   memory, they made a frame 9.6% slower in f64 and 15% in a 64-frame
//   f64 launch (the block's warps wait on one thread's chain of FP64
//   divisions and transcendentals), against a second launch of a few
//   microseconds (PERF.md);
// - each special function has one call site that a lane enters whatever
//   its trajectory type (R_roots' rf and K, position_rad's sncndn), so a
//   warp that straddles the shadow's edge or a type boundary runs each
//   chain once, and a hit of either image order is shaded at one site;
// - the grid covers pixel tiles x frames, so a sweep fills the card in one
//   launch and the last wave of one frame overlaps the next frame's.
// The frame's scalars are read from a device tensor, never compiled in.
// Built with --fmad=false (see analytic.cuh) and without fast math.
//
// In-kernel counters, in the instance nt_image<T, true> only (the
// entry point launches nt_image<T, false>, which has none, and a caller
// that wants them asks for the counted instance): per slot of sim5::Slot,
// the warps that entered a stage (or held a pixel of a class) and the lanes
// that did, by a full-warp ballot, summed in shared memory and added to
// device memory once a block, into one of kCounterCopies copies (block
// number modulo the copies), so that no address takes more than a few dozen
// atomics a frame.  Both instances give the same bits.

#include <cuda_runtime.h>

#include "analytic.cuh"

namespace {

constexpr int kThreads = 512;
// a warp covers 32 pixels of a row, a block kTileH rows of 32 pixels
constexpr int kTileW = 32, kTileH = kThreads / 32;
// copies of the counters, summed by the reader
constexpr int kCounterCopies = 64;
// scalars of type T in a frame's constants, sim5::Frame<T>
constexpr int kFrameWords = 18;
static_assert(sizeof(sim5::Frame<double>) == kFrameWords * sizeof(double) &&
                  sizeof(sim5::Frame<float>) == kFrameWords * sizeof(float),
              "sim5::Frame<T> is kFrameWords scalars of T");

// blocks of kThreads each instance asks to keep resident on an SM
// (__launch_bounds__' second argument).  The f32 instance asks for 3: 40
// registers and 68-76 bytes of spills, but 48 warps an SM instead of 32;
// the f64 one gets 128 registers (no spills without the counters), 16
// warps an SM.  Chosen, with kThreads, by timing each pair in one call
// (PERF.md).
template <typename T>
constexpr int min_blocks() {
  return std::is_same<T, double>::value ? 1 : 3;
}

// the counters' probe.  A stage: one full-warp ballot.  A set of
// classes: one vote, and where a lane is of one, one warp-wide sum a word
// (six bits a class, five classes a word), whose fields lanes 0-4 take
// apart.  Then one shared atomic a counted slot into the block's tally of
// (warps << 16 | lanes) a slot.  Host and device, as sim5::nt_pixel is;
// it counts on the device only.
struct Tally {
  unsigned int* t;
  int lane;
  bool live;
  __host__ __device__ void operator()(int slot, bool p) {
#if defined(__CUDA_ARCH__)
    const unsigned m = __ballot_sync(0xffffffffu, live && p);
    if (m != 0 && lane == 0)
      atomicAdd(&t[slot], (1u << 16) | static_cast<unsigned>(__popc(m)));
#endif
  }
  __host__ __device__ void classes(int slot, int k, int n) {
#if defined(__CUDA_ARCH__)
    if (!__any_sync(0xffffffffu, live && k >= 0 && k < n)) return;
    for (int w = 0; w < n; w += 5) {
      const bool mine = live && k >= w && k < w + 5;
      const unsigned sum = __reduce_add_sync(
          0xffffffffu, mine ? 1u << (6 * (k - w)) : 0u);
      const unsigned c =
          lane < 5 && w + lane < n ? (sum >> (6 * lane)) & 63u : 0u;
      if (c != 0) atomicAdd(&t[slot + w + lane], (1u << 16) | c);
    }
#endif
  }
};

// each frame's constants (sim5::make_frame), once a frame, one thread a
// frame: the prologue of every launch
template <typename T>
__global__ void nt_frames(const T* __restrict__ scalars,
                          sim5::Frame<T>* __restrict__ frames, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) frames[k] = sim5::make_frame(scalars + 6 * k);
}

// frames: the n frames' constants (nt_frames); blockIdx.y is the frame,
// blockIdx.x its pixel tile; kCount: count into `counters` (else unused)
template <typename T, bool kCount>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
nt_image(const sim5::Frame<T>* __restrict__ frames, T* __restrict__ image_f,
         T* __restrict__ image_g, int nx, int ny, T aspect,
         unsigned long long* __restrict__ counters) {
  __shared__ unsigned int tally[kCount ? sim5::kSlots : 1];
  const int lane = threadIdx.x & 31;
  const long long k = blockIdx.y;
  const sim5::Frame<T>& frame = frames[k];
  if constexpr (kCount) {
    for (int s = threadIdx.x; s < sim5::kSlots; s += kThreads) tally[s] = 0;
    __syncthreads();
  }
  // every lane runs the pixel (a lane past the edge runs the last one), so
  // that the ballots see full warps; only live lanes write and count
  const int tiles_x = (nx + kTileW - 1) / kTileW;
  const int ix = (blockIdx.x % tiles_x) * kTileW + lane;
  const int iy = (blockIdx.x / tiles_x) * kTileH + (threadIdx.x >> 5);
  const bool live = ix < nx && iy < ny;
  const int px = live ? ix : nx - 1, py = live ? iy : ny - 1;
  T f, g;
  if constexpr (kCount) {
    Tally probe{tally, lane, live};
    sim5::nt_pixel(frame, px, py, nx, ny, aspect, probe, f, g);
  } else {
    sim5::NoProbe probe;
    sim5::nt_pixel(frame, px, py, nx, ny, aspect, probe, f, g);
  }
  if (live) {
    const long long o = (k * ny + iy) * nx + ix;
    image_f[o] = f;
    image_g[o] = g;
  }
  if constexpr (kCount) {
    __syncthreads();
    unsigned long long* copy =
        counters + (blockIdx.x + (long long)blockIdx.y * gridDim.x) %
                       kCounterCopies * (2 * sim5::kSlots);
    for (int s = threadIdx.x; s < sim5::kSlots; s += kThreads)
      if (tally[s] != 0) {
        atomicAdd(&copy[2 * s], (unsigned long long)(tally[s] >> 16));
        atomicAdd(&copy[2 * s + 1],
                  (unsigned long long)(tally[s] & 0xffffu));
      }
  }
}

template <typename T>
int launch(const void* scalars, void* work, int n, void* image_f,
           void* image_g, int nx, int ny, double aspect, void* counters,
           cudaStream_t stream) {
  sim5::Frame<T>* frames = static_cast<sim5::Frame<T>*>(work);
  nt_frames<T><<<(n + 63) / 64, 64, 0, stream>>>(
      static_cast<const T*>(scalars), frames, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)((nx + kTileW - 1) / kTileW) *
                      (unsigned)((ny + kTileH - 1) / kTileH),
                  (unsigned)n);
  unsigned long long* c = static_cast<unsigned long long*>(counters);
  if (c != nullptr)
    nt_image<T, true><<<grid, kThreads, 0, stream>>>(
        frames, static_cast<T*>(image_f), static_cast<T*>(image_g), nx, ny,
        T(aspect), c);
  else
    nt_image<T, false><<<grid, kThreads, 0, stream>>>(
        frames, static_cast<T*>(image_f), static_cast<T*>(image_g), nx, ny,
        T(aspect), c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kCount>
int attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, (const void*)nt_image<T, kCount>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, nt_image<T, kCount>, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}

}  // namespace

// Render n (ny, nx) frames on `stream`: nt_frames<T> then nt_image<T, C>, T
// double if f64, else float, and C whether counters is not null.  scalars holds n x 6 scalars of type T (a,
// incl, M, mdot, rms, rmax); work has room for n frames' constants (n x
// kFrameWords of type T); image_f and image_g are (n, ny, nx) of type T;
// aspect is ny / nx; counters is null, or kCounterCopies x kSlots x 2
// zeroed 64-bit counts (warps, lanes), added to.  Returns cudaGetLastError() (0 on
// success).
extern "C" int sim5_nt_image(int f64, const void* scalars, void* work, int n,
                             void* image_f, void* image_g, int nx, int ny,
                             double aspect, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(scalars, work, n, image_f, image_g, nx, ny,
                              aspect, counters, s)
             : launch<float>(scalars, work, n, image_f, image_g, nx, ny,
                             aspect, counters, s);
}

// The compile-time choices into out[0..7]: threads a block, the block's
// pixel tile (width, height), the counters' slots and copies, the minimum
// resident blocks of nt_image<double> and nt_image<float>, and the scalars
// of a frame's constants (kFrameWords).
extern "C" void sim5_nt_image_config(int* out) {
  out[0] = kThreads;
  out[1] = kTileW;
  out[2] = kTileH;
  out[3] = sim5::kSlots;
  out[4] = kCounterCopies;
  out[5] = min_blocks<double>();
  out[6] = min_blocks<float>();
  out[7] = kFrameWords;
}

// Registers a thread, local memory a thread (bytes) and resident blocks an
// SM of nt_image<T, counted != 0>, T double if f64, else float, into
// out[0..2]; returns the CUDA error.
extern "C" int sim5_nt_image_attributes(int f64, int counted, int* out) {
  if (f64) return counted ? attributes<double, true>(out)
                          : attributes<double, false>(out);
  return counted ? attributes<float, true>(out) : attributes<float, false>(out);
}
