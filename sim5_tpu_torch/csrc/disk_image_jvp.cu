// The disk image's tangent kernel: the Novikov-Thorne image of n frames
// (disk_image.cu) differentiated in forward mode in K directions at once,
// one pixel a thread.
//
// Replaces no Pallas kernel: the JAX package's autodiff of the image
// (jax.jvp / jax.grad of render_disk_image, bench.py:337-401; XLA).  Its
// plain versions are torch's forward mode and autograd through
// render/image.py:render_disk_image_reference.
//
// A prologue, nt_frames_jvp<T, C, K>, makes each frame's constants on
// duals (sim5::make_frame on sim5::Dual<T, K>) from the frames' (n, 6)
// scalars and an (n, 6, K) tangent matrix: slot j of the frame carries
// column j of the matrix.  nt_image_jvp<T, C, K, kReduce> then runs
// sim5::nt_pixel (analytic.cuh): each pixel's value chain (the quartic and
// its two-float polish, the R and T roots, RF and the K AGM, the Jacobi
// AGM, the shading) and each derivative rule's coefficient chains (rf's
// RD chain, sncndn's two epsilon chains, the quartic's implicit root rule)
// run once, and every slot rides beside them.  Slot j of a K-slot pass
// gives the bits of a one-slot pass seeded with column j (the same
// operations in the same order, analytic.cuh).
//
// The geodesic carries the first C slots (Dual<T, C>, from a second copy
// of the frame's constants with those slots); the shading, all K (Dual<T,
// K>).  The slots after the first C differentiate the shading only: the
// wrapper seeds them with the disk's rms, which moves nt_flux's constants
// and no part of the geodesic (its comparisons with the ISCO carry no
// tangent).  Carried through the chain as a fourth slot, rms made the f32
// backward 1.6x slower (PERF.md).
//
// kReduce = false writes the images and their K tangents (forward mode).
// kReduce = true is the backward: it reads grad_f and grad_g and sums, for
// each slot, grad_f df_j + grad_g dg_j over the block's pixels, and one
// more sum, grad_f f, from which the wrapper forms the gradient in M and
// mdot (f is proportional to mdot / M and g does not depend on them, so
// df/dmdot = f / mdot and df/dM = -f / M: no slot for either).  All K + 1
// sums take one fixed-order tree a block; nt_reduce<T> then sums each
// frame's (blocks, K + 1) partials in a fixed order, in one launch for
// every slot.  No float atomics: a repeated backward is bitwise the same,
// and a frame's sums do not depend on the other frames of its launch.
//
// Compiled: C = K = 1 (forward mode, and a backward in one column) and K =
// kBackwardSlots with C = kChainSlots (a backward in (a, incl, mdot) needs
// the chain columns a, incl and rmax and the shading's rms: rms and the
// default rmax carry the gradient to a); the wrapper gives a smaller
// column set zero slots.
//
// What bounds it: the operations of the value chain and the rules' chains
// once a pixel, plus those of each slot (about the value chain's again
// for each product and quotient), FP64 or FP32, in chains where each level
// waits on the one before; registers, since each dual value is K + 1 live
// scalars.  The threads a block and the minimum resident blocks of each
// instance were chosen by timing (PERF.md).  Built with --fmad=false and
// without fast math, as disk_image.cu.

#include <cuda_runtime.h>

#include "analytic.cuh"

namespace {

// a warp covers 32 pixels of a row, a block threads / 32 rows
constexpr int kTileW = 32;
// scalars of type T in a frame's constants, sim5::Frame<T>
constexpr int kFrameWords = 18;
constexpr int kReduceThreads = 256;

// the slots of the backward's instance, and those of them the geodesic
// carries (the first ones)
constexpr int kBackwardSlots = 4;
constexpr int kChainSlots = 3;

template <typename T, int K>
using DualFrame = sim5::Frame<sim5::Dual<T, K>>;
static_assert(sizeof(DualFrame<double, kBackwardSlots>) ==
                      (kBackwardSlots + 1) * kFrameWords * sizeof(double) &&
                  sizeof(DualFrame<float, kBackwardSlots>) ==
                      (kBackwardSlots + 1) * kFrameWords * sizeof(float),
              "sim5::Frame<Dual<T, K>> is (K + 1) kFrameWords scalars of T");

// threads a block (a power of two) and minimum resident blocks an SM
// (__launch_bounds__) of nt_image_jvp<T, C, K, kReduce>, chosen by timing
// pairs of (128, 256, 512, 1024) x (1-6) on every instance in one call
// (chip_smoke.py --tune-tangent, PERF.md).  The register cap they set
// (65536 / (threads x blocks), at most 255) moves the time most: f64 at
// 128 registers (K = 4) or 64 (K = 1) and f32 at 64, with spills, ran
// 1.5-2.4x faster than uncapped (255 / 174 / 153 / 84 registers) in
// blocks of 256.  At one cap, larger blocks ran the f32 backward faster.
template <typename T, int K, bool kReduce>
__host__ __device__ constexpr int jvp_threads() {
  if (std::is_same<T, double>::value) return K == 1 && kReduce ? 512 : 256;
  return K == 1 && !kReduce ? 512 : 1024;
}
template <typename T, int K, bool kReduce>
__host__ __device__ constexpr int jvp_min_blocks() {
  if (std::is_same<T, double>::value) return K == 1 && !kReduce ? 4 : 2;
  return K == 1 && !kReduce ? 2 : 1;
}

template <typename T, int K, bool kReduce>
int jvp_blocks(int nx, int ny) {
  constexpr int tile_h = jvp_threads<T, K, kReduce>() / kTileW;
  return ((nx + kTileW - 1) / kTileW) * ((ny + tile_h - 1) / tile_h);
}

// the work space of a launch: n frames' constants on Dual<T, K>, then,
// where C < K, on Dual<T, C>
template <typename T, int C, int K>
constexpr int jvp_frame_words() {
  return ((K + 1) + (C < K ? C + 1 : 0)) * kFrameWords;
}

// each frame's dual constants from its scalars (n, 6) and tangents (n, 6,
// K): wide (n) on all K slots; where C < K, chain (n) on the first C
template <typename T, int C, int K>
__global__ void nt_frames_jvp(const T* __restrict__ scalars,
                              const T* __restrict__ tangents,
                              DualFrame<T, K>* __restrict__ wide,
                              DualFrame<T, C>* __restrict__ chain, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  sim5::Dual<T, K> s[6];
  for (int i = 0; i < 6; ++i) {
    s[i].v = scalars[6 * k + i];
#pragma unroll
    for (int j = 0; j < K; ++j) s[i].d[j] = tangents[(6 * k + i) * K + j];
  }
  wide[k] = sim5::make_frame(s);
  if constexpr (C < K) {
    sim5::Dual<T, C> c[6];
    for (int i = 0; i < 6; ++i) {
      c[i].v = s[i].v;
#pragma unroll
      for (int j = 0; j < C; ++j) c[i].d[j] = s[i].d[j];
    }
    chain[k] = sim5::make_frame(c);
  }
}

// The pixels are those of rows [row0, row0 + rows) of the (ny, nx) frame,
// row iy of the window row iy of the arrays below.
// kReduce = false: f, g (n, rows, nx) and df, dg (n, K, rows, nx) are
// outputs.  kReduce = true: f and g are grad_f and grad_g (n, rows, nx)
// inputs, and partials (n, gridDim.x, K + 1) takes each block's sums of
// grad_f df_j + grad_g dg_j, slot by slot, then of grad_f f, over the
// window's pixels.
template <typename T, int C, int K, bool kReduce>
__global__ void __launch_bounds__(jvp_threads<T, K, kReduce>(),
                                  jvp_min_blocks<T, K, kReduce>())
nt_image_jvp(const DualFrame<T, K>* __restrict__ wide,
             const DualFrame<T, C>* __restrict__ chain, T* __restrict__ f,
             T* __restrict__ g, T* __restrict__ df, T* __restrict__ dg,
             T* __restrict__ partials, int nx, int ny, int row0, int rows,
             T aspect) {
  constexpr int kThr = jvp_threads<T, K, kReduce>();
  static_assert(kThr % kTileW == 0 && (kThr & (kThr - 1)) == 0,
                "a block is a power of two of whole warps");
  const int lane = threadIdx.x & 31;
  const long long k = blockIdx.y;
  const int tiles_x = (nx + kTileW - 1) / kTileW;
  const int ix = (blockIdx.x % tiles_x) * kTileW + lane;
  const int iy =
      (blockIdx.x / tiles_x) * (kThr / kTileW) + (threadIdx.x >> 5);
  const bool live = ix < nx && iy < rows;
  const long long npix = (long long)nx * rows;
  const long long p = (long long)iy * nx + ix;
  T part[K + 1];
#pragma unroll
  for (int s = 0; s <= K; ++s) part[s] = T(0);
  if (live) {
    sim5::NoProbe probe;
    sim5::Dual<T, K> fv, gv;
    if constexpr (C < K)
      sim5::nt_pixel(chain[k], wide[k], ix, row0 + iy, nx, ny, aspect,
                     probe, fv, gv);
    else
      sim5::nt_pixel(wide[k], ix, row0 + iy, nx, ny, aspect, probe, fv,
                     gv);
    if constexpr (kReduce) {
      const T wf = f[k * npix + p], wg = g[k * npix + p];
#pragma unroll
      for (int j = 0; j < K; ++j) part[j] = wf * fv.d[j] + wg * gv.d[j];
      part[K] = wf * fv.v;
    } else {
      f[k * npix + p] = fv.v;
      g[k * npix + p] = gv.v;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        df[(k * K + j) * npix + p] = fv.d[j];
        dg[(k * K + j) * npix + p] = gv.d[j];
      }
    }
  }
  if constexpr (kReduce) {
    // the block's sums, every slot in one fixed tree order
    __shared__ T buf[K + 1][kThr];
#pragma unroll
    for (int s = 0; s <= K; ++s) buf[s][threadIdx.x] = part[s];
    __syncthreads();
    for (int w = kThr / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) {
#pragma unroll
        for (int s = 0; s <= K; ++s)
          buf[s][threadIdx.x] += buf[s][threadIdx.x + w];
      }
      __syncthreads();
    }
    if (threadIdx.x <= K)
      partials[(k * gridDim.x + blockIdx.x) * (K + 1) + threadIdx.x] =
          buf[threadIdx.x][0];
  }
}

// out[k * slots + s] = the sum of frame k's m partials of slot s
// (partials (n, m, slots)), one block a frame, in a fixed order (each
// thread a strided run, then a tree), slot after slot
template <typename T>
__global__ void nt_reduce(const T* __restrict__ partials, int m, int slots,
                          T* __restrict__ out) {
  __shared__ T buf[kReduceThreads];
  const long long k = blockIdx.x;
  for (int s = 0; s < slots; ++s) {
    T acc = T(0);
    for (int i = threadIdx.x; i < m; i += kReduceThreads)
      acc += partials[(k * m + i) * slots + s];
    buf[threadIdx.x] = acc;
    __syncthreads();
    for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[k * slots + s] = buf[0];
    __syncthreads();
  }
}

// grad_f null: forward mode into f, g, df, dg.  Else the backward: out (n,
// K + 1) takes frame k's sums, partials room for n x jvp_blocks<T, K,
// true>(nx, rows) x (K + 1) scalars of type T.  The pixels are the row
// window [row0, row0 + rows) of (ny, nx) frames.
template <typename T, int C, int K>
int launch_jvp(const void* scalars, const void* tangents, void* work, int n,
               void* f, void* g, void* df, void* dg, const void* grad_f,
               const void* grad_g, void* partials, void* out, int nx, int ny,
               int row0, int rows, double aspect, cudaStream_t stream) {
  auto* wide = static_cast<DualFrame<T, K>*>(work);
  auto* chain = reinterpret_cast<DualFrame<T, C>*>(wide + n);
  nt_frames_jvp<T, C, K><<<(n + 63) / 64, 64, 0, stream>>>(
      static_cast<const T*>(scalars), static_cast<const T*>(tangents), wide,
      chain, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grad_f == nullptr) {
    const dim3 grid((unsigned)jvp_blocks<T, K, false>(nx, rows),
                    (unsigned)n);
    nt_image_jvp<T, C, K, false>
        <<<grid, jvp_threads<T, K, false>(), 0, stream>>>(
            wide, chain, static_cast<T*>(f), static_cast<T*>(g),
            static_cast<T*>(df), static_cast<T*>(dg), nullptr, nx, ny, row0,
            rows, T(aspect));
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = jvp_blocks<T, K, true>(nx, rows);
  const dim3 grid((unsigned)blocks, (unsigned)n);
  nt_image_jvp<T, C, K, true><<<grid, jvp_threads<T, K, true>(), 0, stream>>>(
      wide, chain, const_cast<T*>(static_cast<const T*>(grad_f)),
      const_cast<T*>(static_cast<const T*>(grad_g)), nullptr, nullptr,
      static_cast<T*>(partials), nx, ny, row0, rows, T(aspect));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nt_reduce<T><<<n, kReduceThreads, 0, stream>>>(
      static_cast<T*>(partials), blocks, K + 1, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, int K, bool kReduce>
int jvp_config(int nx, int ny, int* out) {
  out[0] = jvp_blocks<T, K, kReduce>(nx, ny);
  out[1] = jvp_threads<T, K, kReduce>();
  out[2] = jvp_min_blocks<T, K, kReduce>();
  out[3] = jvp_frame_words<T, C, K>();
  out[4] = C;
  return 0;
}

template <typename T, int C, int K, bool kReduce>
int jvp_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(
      &attr, (const void*)nt_image_jvp<T, C, K, kReduce>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, nt_image_jvp<T, C, K, kReduce>, jvp_threads<T, K, kReduce>(),
      0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}

// The compiled instances of type T: one slot (C = K = 1), and
// kBackwardSlots slots of which the chain carries kChainSlots.  Calls
// F<T, C, K>::run(args...) for the instance with K slots, or returns
// cudaErrorInvalidValue for a K that is not compiled.
template <template <typename, int, int> class F, typename T, typename... A>
int by_slots(int K, A... args) {
  if (K == 1) return F<T, 1, 1>::run(args...);
  if (K == kBackwardSlots)
    return F<T, kChainSlots, kBackwardSlots>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}
template <template <typename, int, int> class F, typename... A>
int by_type(int f64, int K, A... args) {
  return f64 ? by_slots<F, double>(K, args...)
             : by_slots<F, float>(K, args...);
}

template <typename T, int C, int K>
struct Launch {
  template <typename... A>
  static int run(A... args) { return launch_jvp<T, C, K>(args...); }
};
template <typename T, int C, int K>
struct Config {
  static int run(int reduce, int nx, int ny, int* out) {
    return reduce ? jvp_config<T, C, K, true>(nx, ny, out)
                  : jvp_config<T, C, K, false>(nx, ny, out);
  }
};
template <typename T, int C, int K>
struct Attributes {
  static int run(int reduce, int* out) {
    return reduce ? jvp_attributes<T, C, K, true>(out)
                  : jvp_attributes<T, C, K, false>(out);
  }
};

}  // namespace

// The tangent kernel with K slots, T double if f64, else float:
// nt_frames_jvp<T, C, K> (each frame's dual constants into work, n x
// sim5_nt_image_jvp_config's frame words scalars of T, from scalars (n, 6)
// and tangents (n, 6, K) of T), then nt_image_jvp<T, C, K, ...>, whose
// geodesic carries the first C slots (the config's out[4]) and whose
// shading all K: seed the slots after the first C with rms alone (or M
// and mdot), which no part of the geodesic reads.  The pixels are rows
// [row0, row0 + rows) of the (ny, nx) frames (row0 = 0 and rows = ny: the
// whole frames).  With grad_f null, forward mode: f and g (n, rows, nx)
// take the images and df and dg (n, K, rows, nx) their tangents.  Else
// the backward: grad_f and grad_g (n, rows, nx) are read, partials has
// room for n x blocks x (K + 1) scalars (sim5_nt_image_jvp_config with
// reduce = 1 for (nx, rows)), and nt_reduce<T> writes frame k's sums over
// the window of grad_f df_j + grad_g dg_j (j < K) and of grad_f f (j = K)
// to out[k * (K + 1) + j].  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a K that is not compiled.
extern "C" int sim5_nt_image_jvp(int f64, int K, const void* scalars,
                                 const void* tangents, void* work, int n,
                                 void* f, void* g, void* df, void* dg,
                                 const void* grad_f, const void* grad_g,
                                 void* partials, void* out, int nx, int ny,
                                 int row0, int rows, double aspect,
                                 void* stream) {
  return by_type<Launch>(f64, K, scalars, tangents, work, n, f, g, df, dg,
                         grad_f, grad_g, partials, out, nx, ny, row0, rows,
                         aspect, static_cast<cudaStream_t>(stream));
}

// The compile-time choices of the K-slot instance (reduce != 0: the
// backward's) for an (ny, nx) image into out[0..4]: its blocks a frame,
// threads a block, minimum resident blocks, the scalars of a frame's dual
// constants in the work space, and the slots the geodesic carries;
// returns cudaErrorInvalidValue for a K that is not compiled.
extern "C" int sim5_nt_image_jvp_config(int f64, int K, int reduce, int nx,
                                        int ny, int* out) {
  return by_type<Config>(f64, K, reduce, nx, ny, out);
}

// The slot count of the backward's instance, and the slots its geodesic
// carries, into out[0..1].
extern "C" void sim5_nt_image_jvp_slots(int* out) {
  out[0] = kBackwardSlots;
  out[1] = kChainSlots;
}

// Registers a thread, local memory a thread (bytes) and resident blocks an
// SM of the K-slot instance (reduce != 0: the backward's) into out[0..2];
// returns the CUDA error.
extern "C" int sim5_nt_image_jvp_attributes(int f64, int K, int reduce,
                                            int* out) {
  return by_type<Attributes>(f64, K, reduce, out);
}
