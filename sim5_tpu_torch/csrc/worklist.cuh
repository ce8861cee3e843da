// The analytic kernels' work lists and counted instances (crossing_map.cu,
// volume_seed.cu); device code only.
//
// A first pass, one pixel a thread, appends each pixel that needs the
// azimuth chains to a list keyed by its trajectory type (sim5::work_bin:
// the type, vortical lanes apart, CC last), once for each part of its work
// (sim5::kMaxBins), one atomic a bin a warp.  The bins share one pool of
// as many entries as the parts of every pixel (and a chunk a bin), handed
// out to the bins kChunk entries at a time, as they fill: a bin's table
// gives the pool's chunk of each of its chunks.  A second pass of
// persistent blocks takes the list in bin order, 32 entries a warp from an
// atomic cursor, so that its warps mostly hold lanes of one type and part
// that all have work, and no wave of blocks runs nearly empty.  Counts,
// offsets and entries are 64-bit.  The order of a bin's entries varies
// from run to run; each entry's output is its pixel's own, so every output
// is the same from run to run.
//
// The counted instances (built with -DSIM5_COUNTED) time each stage of
// azimuth.cuh (sim5::Stage) by clock64 and count, by a full-warp ballot,
// the warps and lanes that ran it; their depth policy counts each Carlson
// chain's levels (sim5::ChainKind).  The counters are device globals that
// the counted entry points clear before their launches and read after.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "azimuth.cuh"

namespace sim5 {
namespace work {

using u64 = unsigned long long;

// entries of a chunk of the pool (more than a warp appends at once)
constexpr int kChunk = 1024;

// a launch's work header: the entries each bin holds, the chunks handed
// out, and the second pass's cursor
struct Header {
  u64 count[kMaxBins];
  u64 chunks;
  u64 cursor;
};

// The lists: the pool of chunks, and each bin's table of `per_bin` slots,
// slot c the pool chunk (+ 1) of the bin's entries [c kChunk, (c + 1)
// kChunk), 0 until handed out
struct Lists {
  Header* h;
  u64* table;
  long long* pool;
  long long per_bin;
};

// chunks a bin's table and the pool hold for `parts` entries of each of
// `cap` pixels
inline long long chunks_per_bin(long long cap) {
  return (cap + kChunk - 1) / kChunk;
}
inline long long pool_chunks(long long cap, int parts) {
  return (parts * cap + kChunk - 1) / kChunk + kMaxBins;
}

// Appends entry o to bin `bin` for each lane with `want`, one atomic a bin
// a warp.  The warp whose entries take a chunk's first slot hands the
// chunk out; a lane whose chunk another warp hands out waits for its
// number, which that warp publishes right after its own atomic.  Every
// lane of the warp calls it.
__device__ __forceinline__ void append(bool want, int bin, long long o,
                                       const Lists& l) {
  const unsigned active = __ballot_sync(0xffffffffu, want);
  if (!want) return;
  const unsigned peers = __match_any_sync(active, bin);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  const unsigned k = __popc(peers);
  u64* slot = l.table + bin * l.per_bin;
  u64 base = 0;
  if (lane == leader) {
    base = atomicAdd(&l.h->count[bin], static_cast<u64>(k));
    const u64 c = (base + kChunk - 1) / kChunk;
    if (c * kChunk < base + k)
      atomicExch(&slot[c], atomicAdd(&l.h->chunks, 1ull) + 1);
  }
  base = __shfl_sync(peers, base, leader);
  const u64 p = base + __popc(peers & ((1u << lane) - 1u));
  u64 t;
  while ((t = *static_cast<volatile u64*>(&slot[p / kChunk])) == 0) {
  }
  l.pool[(t - 1) * kChunk + p % kChunk] = o;
}

// The second pass's loop: each warp takes the next 32 entries of the bins
// in order from the cursor until none is left, and every lane calls
// fn(live, o), o its entry (live) or -1.
template <typename F>
__device__ __forceinline__ void for_each_entry(const Lists& l, F fn) {
  __shared__ u64 off[kMaxBins + 1];
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int b = 0; b < kMaxBins; ++b) off[b + 1] = off[b] + l.h->count[b];
  }
  __syncthreads();
  const u64 total = off[kMaxBins];
  const int lane = threadIdx.x & 31;
  for (;;) {
    u64 base = 0;
    if (lane == 0) base = atomicAdd(&l.h->cursor, 32ull);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= total) break;
    const u64 j = base + lane;
    long long o = -1;
    if (j < total) {
      int b = 0;
      while (j >= off[b + 1]) ++b;
      const u64 p = j - off[b];
      const u64 t = l.table[b * l.per_bin + p / kChunk];
      o = l.pool[(t - 1) * kChunk + p % kChunk];
    }
    fn(o >= 0, o);
  }
}

// Blocks of `kernel` (`threads` a block) that fill the current card once,
// kept in known[card] (known: an array of 16 cards, 0 until found)
template <typename K>
int resident_blocks(K kernel, int threads, int* known) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && known[dev] > 0) return known[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int b = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < 16) known[dev] = b;
  return b;
}

// registers a thread, local memory a thread (bytes), resident blocks an SM
// and threads a block of `kernel` into out[0..3]; the CUDA error
template <typename K>
int attributes(K kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = threads;
  return static_cast<int>(e);
}

// every field of a geodesic, in order, as f(field): an entry's planes
template <typename T, typename F>
__device__ __forceinline__ void geod_fields(Geod<T>& g, F&& f) {
  f(g.a);
  f(g.alpha);
  f(g.beta);
  f(g.incl);
  f(g.cos_i);
  f(g.l);
  f(g.q);
  for (int i = 0; i < 4; ++i) {
    f(g.rr[i]);
    f(g.ri[i]);
    f(g.rr_lo[i]);
  }
  f(g.nrr);
  f(g.gtype);
  f(g.status);
  f(g.m2p);
  f(g.m2m);
  f(g.mm);
  f(g.mK);
  f(g.rp);
  f(g.Rpc);
  f(g.Tpp);
  f(g.Tip);
}
constexpr int kGeodFields = 30;

inline long long up256(long long b) { return (b + 255) / 256 * 256; }

// bytes of the header and the tables, which reset() clears
inline long long cleared_bytes(long long cap) {
  return up256(sizeof(Header)) + up256(8 * kMaxBins * chunks_per_bin(cap));
}

// bytes of a launch's work of `cap` pixels, `parts` entries each, of
// `planes` fields: the header, the tables, the pool and the pixels'
// planes, each 256-byte aligned
inline long long bytes(long long cap, int parts, int planes) {
  return cleared_bytes(cap) + up256(8 * kChunk * pool_chunks(cap, parts)) +
         up256(8 * planes * cap);
}

// The work's parts in one buffer of bytes(cap, parts, E::kPlanes).  The
// pixels' E (a type with kPlanes and each(f), which calls f on every
// field) lie field by field: field k of pixel i in slot i of plane k (cap
// slots of 8 bytes), so that a warp's stores and loads of a field of
// neighbouring pixels are coalesced.
template <typename E>
struct Work {
  Lists l;
  char* planes;
  long long cap;

  __device__ __forceinline__ void put(long long i, E& e) const {
    int k = 0;
    e.each([&](auto& v) {
      using V = typename std::remove_reference<decltype(v)>::type;
      reinterpret_cast<V*>(planes + 8ll * cap * k++)[i] = v;
    });
  }
  __device__ __forceinline__ E get(long long i) const {
    E e;
    int k = 0;
    e.each([&](auto& v) {
      using V = typename std::remove_reference<decltype(v)>::type;
      v = reinterpret_cast<const V*>(planes + 8ll * cap * k++)[i];
    });
    return e;
  }
};
template <typename E>
Work<E> carve(void* base, long long cap, int parts) {
  char* p = static_cast<char*>(base);
  Work<E> w;
  w.l.h = reinterpret_cast<Header*>(p);
  w.l.table = reinterpret_cast<u64*>(p + up256(sizeof(Header)));
  w.l.pool = reinterpret_cast<long long*>(p + cleared_bytes(cap));
  w.l.per_bin = chunks_per_bin(cap);
  w.planes = p + cleared_bytes(cap) +
             up256(8 * kChunk * pool_chunks(cap, parts));
  w.cap = cap;
  return w;
}

// Clears the counts, the cursor and the tables before the first pass.
template <typename E>
cudaError_t reset(const Work<E>& w, cudaStream_t s) {
  return cudaMemsetAsync(w.l.h, 0, cleared_bytes(w.cap), s);
}

}  // namespace work

#if defined(SIM5_COUNTED)
namespace counted {

// per stage: warps, lanes, cycles (a warp's clock64 from the stage's start
// to its end, summed over the warps that ran it); per chain: warp calls,
// lane calls, the lanes' levels, and the levels issued (each warp call's
// deepest level times its lanes)
constexpr int kStageWords = kStages * 3, kChainWords = kChainKinds * 4;
__device__ unsigned long long g_stage[kStages][3];
__device__ unsigned long long g_chain[kChainKinds][4];

// the stage probe: every lane of the warp calls begin() and end()
struct StageProbe {
  long long t0 = 0;
  __host__ __device__ void begin() {
#if defined(__CUDA_ARCH__)
    __syncwarp();
    t0 = clock64();
#endif
  }
  __host__ __device__ void end(int s, bool p) {
#if defined(__CUDA_ARCH__)
    __syncwarp();
    const long long dt = clock64() - t0;
    const unsigned m = __ballot_sync(0xffffffffu, p);
    if (m != 0 && (threadIdx.x & 31) == 0) {
      atomicAdd(&g_stage[s][0], 1ull);
      atomicAdd(&g_stage[s][1], static_cast<unsigned long long>(__popc(m)));
      atomicAdd(&g_stage[s][2], static_cast<unsigned long long>(dt));
    }
#endif
  }
};

// a depth policy that counts each chain's levels, over the lanes that run
// the call together
template <typename Base>
struct CountedDepth : Base {
  __host__ __device__ static void note(int chain, int levels) {
#if defined(__CUDA_ARCH__)
    const unsigned m = __activemask();
    const unsigned lv = static_cast<unsigned>(levels);
    const unsigned sum = __reduce_add_sync(m, lv);
    const unsigned deep = __reduce_max_sync(m, lv);
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      const unsigned long long lanes = __popc(m);
      atomicAdd(&g_chain[chain][0], 1ull);
      atomicAdd(&g_chain[chain][1], lanes);
      atomicAdd(&g_chain[chain][2], static_cast<unsigned long long>(sum));
      atomicAdd(&g_chain[chain][3], deep * lanes);
    }
#endif
  }
};

inline cudaError_t clear(cudaStream_t s) {
  void *st = nullptr, *ch = nullptr;
  cudaGetSymbolAddress(&st, g_stage);
  cudaGetSymbolAddress(&ch, g_chain);
  cudaMemsetAsync(st, 0, sizeof(g_stage), s);
  return cudaMemsetAsync(ch, 0, sizeof(g_chain), s);
}

// after the stream's work: the stage counters, then the chain counters,
// into out[0 .. kStageWords + kChainWords)
inline cudaError_t read(long long* out, cudaStream_t s) {
  cudaError_t e = cudaStreamSynchronize(s);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyFromSymbol(out, g_stage, sizeof(g_stage));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(out + kStageWords, g_chain, sizeof(g_chain));
}

}  // namespace counted
#endif

}  // namespace sim5
