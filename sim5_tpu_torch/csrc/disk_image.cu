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
// The tangent kernel, nt_image_jvp<T, kReduce> after its prologue
// nt_frames_jvp<T>, differentiates the same pixel in forward mode: each
// thread runs sim5::nt_pixel on sim5::Dual<T> (a value and one tangent),
// the frame's constants made on duals from the frames' scalars and one
// tangent of them.  It replaces the JAX package's autodiff of the same
// program (jax.jvp / jax.grad of render_disk_image, bench.py:337-401; XLA,
// no Pallas kernel).  Where plain forward mode would differentiate an
// iteration or a degenerate closed form, the tangent follows the rule the
// plain torch version uses (analytic.cuh: rf's RD rule, sncndn's
// epsilon-function rule, the quartic's implicit root rule).  kReduce = false
// writes the images and their tangents; kReduce = true reads grad_f and
// grad_g and sums grad_f df + grad_g dg over each block's pixels into one
// partial a block, which nt_reduce then sums a frame in a fixed order: the
// backward of the image in one column of the frames, with no float atomics,
// so a repeated backward is bitwise the same and a frame's sum does not
// depend on the other frames of its launch.  One tangent a pass: the
// backward launches once a column that needs grad, forward mode once.
// What bounds it: twice or more the forward's FP64 / FP32 operations (the
// tangent of every product and quotient, the rules' extra duplication
// chains) with twice the live values, so registers: it takes 256 threads a
// block and lets the compiler take up to 255 registers, one block an SM
// at least; the registers, spills and resident blocks are in PERF.md.  Not
// tuned.
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

// ---------------------------------------------------------------------------
// the tangent kernel
// ---------------------------------------------------------------------------

constexpr int kJvpThreads = 256;
constexpr int kJvpTileH = kJvpThreads / 32;
// scalars of type T in a frame's dual constants, sim5::Frame<Dual<T>>
constexpr int kJvpFrameWords = 2 * kFrameWords;
static_assert(sizeof(sim5::Frame<sim5::Dual<double>>) ==
                      kJvpFrameWords * sizeof(double) &&
                  sizeof(sim5::Frame<sim5::Dual<float>>) ==
                      kJvpFrameWords * sizeof(float),
              "sim5::Frame<Dual<T>> is kJvpFrameWords scalars of T");

// each frame's dual constants from its scalars and their tangents
template <typename T>
__global__ void nt_frames_jvp(const T* __restrict__ scalars,
                              const T* __restrict__ tangents,
                              sim5::Frame<sim5::Dual<T>>* __restrict__ frames,
                              int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  sim5::Dual<T> s[6];
  for (int i = 0; i < 6; ++i)
    s[i] = sim5::Dual<T>(scalars[6 * k + i], tangents[6 * k + i]);
  frames[k] = sim5::make_frame(s);
}

// kReduce = false: f, g, df, dg are (n, ny, nx) outputs.  kReduce = true: f
// and g are grad_f and grad_g (n, ny, nx) inputs, and partials (n,
// gridDim.x) takes each block's sum of grad_f df + grad_g dg.
template <typename T, bool kReduce>
__global__ void __launch_bounds__(kJvpThreads, 1)
nt_image_jvp(const sim5::Frame<sim5::Dual<T>>* __restrict__ frames,
             T* __restrict__ f, T* __restrict__ g, T* __restrict__ df,
             T* __restrict__ dg, T* __restrict__ partials, int nx, int ny,
             T aspect) {
  const int lane = threadIdx.x & 31;
  const long long k = blockIdx.y;
  const int tiles_x = (nx + kTileW - 1) / kTileW;
  const int ix = (blockIdx.x % tiles_x) * kTileW + lane;
  const int iy = (blockIdx.x / tiles_x) * kJvpTileH + (threadIdx.x >> 5);
  const bool live = ix < nx && iy < ny;
  const long long o = (k * ny + iy) * nx + ix;
  T part = T(0);
  if (live) {
    sim5::NoProbe probe;
    sim5::Dual<T> fv, gv;
    sim5::nt_pixel(frames[k], ix, iy, nx, ny, aspect, probe, fv, gv);
    if constexpr (kReduce) {
      part = f[o] * fv.d + g[o] * gv.d;
    } else {
      f[o] = fv.v;
      g[o] = gv.v;
      df[o] = fv.d;
      dg[o] = gv.d;
    }
  }
  if constexpr (kReduce) {
    // the block's sum, in a fixed tree order
    __shared__ T buf[kJvpThreads];
    buf[threadIdx.x] = part;
    __syncthreads();
    for (int w = kJvpThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[k * gridDim.x + blockIdx.x] = buf[0];
  }
}

// out[k * stride] = the sum of frame k's m partials, one block a frame, in a
// fixed order (each thread a strided run, then a tree)
template <typename T>
__global__ void nt_reduce(const T* __restrict__ partials, int m,
                          T* __restrict__ out, int stride) {
  __shared__ T buf[kJvpThreads];
  const long long k = blockIdx.x;
  T acc = T(0);
  for (int i = threadIdx.x; i < m; i += kJvpThreads) acc += partials[k * m + i];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kJvpThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k * stride] = buf[0];
}

// grad_f/grad_g null: forward mode into f, g, df, dg.  Else the backward:
// out[k * stride] = sum over frame k's pixels of grad_f df + grad_g dg, with
// partials room for n x jvp_blocks(nx, ny) scalars of type T.
template <typename T>
int launch_jvp(const void* scalars, const void* tangents, void* work, int n,
               void* f, void* g, void* df, void* dg, const void* grad_f,
               const void* grad_g, void* partials, void* out, int stride,
               int nx, int ny, double aspect, cudaStream_t stream) {
  auto* frames = static_cast<sim5::Frame<sim5::Dual<T>>*>(work);
  nt_frames_jvp<T><<<(n + 63) / 64, 64, 0, stream>>>(
      static_cast<const T*>(scalars), static_cast<const T*>(tangents), frames,
      n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = (unsigned)((nx + kTileW - 1) / kTileW) *
                          (unsigned)((ny + kJvpTileH - 1) / kJvpTileH);
  const dim3 grid(blocks, (unsigned)n);
  if (grad_f == nullptr) {
    nt_image_jvp<T, false><<<grid, kJvpThreads, 0, stream>>>(
        frames, static_cast<T*>(f), static_cast<T*>(g), static_cast<T*>(df),
        static_cast<T*>(dg), nullptr, nx, ny, T(aspect));
    return static_cast<int>(cudaGetLastError());
  }
  nt_image_jvp<T, true><<<grid, kJvpThreads, 0, stream>>>(
      frames, const_cast<T*>(static_cast<const T*>(grad_f)),
      const_cast<T*>(static_cast<const T*>(grad_g)), nullptr, nullptr,
      static_cast<T*>(partials), nx, ny, T(aspect));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nt_reduce<T><<<n, kJvpThreads, 0, stream>>>(static_cast<T*>(partials),
                                              (int)blocks, static_cast<T*>(out),
                                              stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kReduce>
int jvp_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, (const void*)nt_image_jvp<T, kReduce>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, nt_image_jvp<T, kReduce>, kJvpThreads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
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

// The tangent kernel, T double if f64, else float: nt_frames_jvp<T> (each
// frame's dual constants into work, n x kJvpFrameWords scalars of T, from
// scalars and tangents, each n x 6 of T) then nt_image_jvp<T, ...>.  With
// grad_f null, forward mode: f, g, df, dg (n, ny, nx) of T take the images
// and their tangents.  Else the backward in the tangents' direction:
// grad_f and grad_g (n, ny, nx) of T are read, partials has room for n x
// sim5_nt_image_jvp_blocks(nx, ny) scalars of T, and nt_reduce<T> writes
// frame k's sum of grad_f df + grad_g dg to out[k * stride].  Returns
// cudaGetLastError() (0 on success).
extern "C" int sim5_nt_image_jvp(int f64, const void* scalars,
                                 const void* tangents, void* work, int n,
                                 void* f, void* g, void* df, void* dg,
                                 const void* grad_f, const void* grad_g,
                                 void* partials, void* out, int stride,
                                 int nx, int ny, double aspect,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_jvp<double>(scalars, tangents, work, n, f, g, df, dg,
                                  grad_f, grad_g, partials, out, stride, nx,
                                  ny, aspect, s)
             : launch_jvp<float>(scalars, tangents, work, n, f, g, df, dg,
                                 grad_f, grad_g, partials, out, stride, nx,
                                 ny, aspect, s);
}

// The tangent kernel's blocks a frame for an (ny, nx) image, its threads a
// block and the scalars of a frame's dual constants, into out[0..2].
extern "C" void sim5_nt_image_jvp_config(int nx, int ny, int* out) {
  out[0] = ((nx + kTileW - 1) / kTileW) * ((ny + kJvpTileH - 1) / kJvpTileH);
  out[1] = kJvpThreads;
  out[2] = kJvpFrameWords;
}

// Registers a thread, local memory a thread (bytes) and resident blocks an
// SM of nt_image_jvp<T, reduce != 0>, T double if f64, else float, into
// out[0..2]; returns the CUDA error.
extern "C" int sim5_nt_image_jvp_attributes(int f64, int reduce, int* out) {
  if (f64) return reduce ? jvp_attributes<double, true>(out)
                         : jvp_attributes<double, false>(out);
  return reduce ? jvp_attributes<float, true>(out)
                : jvp_attributes<float, false>(out);
}
