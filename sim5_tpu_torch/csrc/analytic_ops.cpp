// Operation counts of the crossing-map and volume-seed kernels: a host
// build (g++) of the kernels' per-pixel functions (azimuth.cuh) on a
// counting scalar, sim5::Ops<T>, which wraps T, computes every operation
// in T (the same bits as the kernels' pixels on T) and counts each
// addition or subtraction, multiplication, division, square root and
// transcendental function (sin, cos, acos, asin, atan, atanh, log, log1p,
// pow; each also by name) it executes, by the precision it runs in, and
// by pass: the geometry (crossing_geometry, seed_geometry) and the rest
// (crossing_hit, seed_azimuth), the kernels' two passes.  The control flow
// is the kernels' own: a pixel counts the operations of its trajectory
// type and its branches only.  Either depth policy of azimuth.cuh's
// Carlson chains runs (FixedDepth, the plain chains' depth, or
// AdaptiveDepth, the kernels'), and
// each chain's levels are counted too: its calls, their levels and the
// deepest.  chip_smoke.py divides the counts of a run's pixels by the
// card's peak rates for the kernels' bound.  Built at first use by
// kernel_analytic.operation_counts (_build.load_host); it runs on the
// host's cores, one std::thread a band of pixels.

#include <thread>
#include <type_traits>
#include <vector>

#include "azimuth.cuh"

namespace {

enum Kind { kAdd, kMul, kDiv, kSqrt, kTrans, kKinds };
enum Fn { kSin, kCos, kAcos, kAsin, kAtan, kAtanh, kLog, kLog1p, kPow, kFns };
// the calling thread's counts, [f64, f32][kind], the transcendentals by
// name, and [chain][calls, levels, deepest] of the Carlson chains
thread_local long long t_ops[2][kKinds];
thread_local long long t_fn[2][kFns];
thread_local long long t_levels[sim5::kChainKinds][3];

}  // namespace

namespace sim5 {

template <typename T>
struct Ops {
  T v;
  constexpr Ops() : v(0) {}
  constexpr Ops(T x) : v(x) {}
  template <typename U,
            typename = typename std::enable_if<!std::is_same<U, T>::value>::type>
  explicit constexpr Ops(const Ops<U>& o) : v(T(o.v)) {}
  explicit operator double() const { return v; }

  static constexpr int kPrec = std::is_same<T, double>::value ? 0 : 1;
  static Ops tally(int k, T x) {
    ++t_ops[kPrec][k];
    return Ops(x);
  }
  static Ops fn(int f, T x) {
    ++t_fn[kPrec][f];
    return tally(kTrans, x);
  }
  friend Ops operator+(Ops a, Ops b) { return tally(kAdd, a.v + b.v); }
  friend Ops operator-(Ops a, Ops b) { return tally(kAdd, a.v - b.v); }
  friend Ops operator*(Ops a, Ops b) { return tally(kMul, a.v * b.v); }
  friend Ops operator/(Ops a, Ops b) { return tally(kDiv, a.v / b.v); }
  friend Ops operator-(Ops a) { return Ops(-a.v); }
  friend bool operator<(Ops a, Ops b) { return a.v < b.v; }
  friend bool operator>(Ops a, Ops b) { return a.v > b.v; }
  friend bool operator<=(Ops a, Ops b) { return a.v <= b.v; }
  friend bool operator>=(Ops a, Ops b) { return a.v >= b.v; }
  friend bool operator==(Ops a, Ops b) { return a.v == b.v; }
  friend bool operator!=(Ops a, Ops b) { return a.v != b.v; }

  friend Ops Sqrt(Ops x) { return tally(kSqrt, sim5::Sqrt(x.v)); }
  friend Ops Sin(Ops x) { return fn(kSin, sim5::Sin(x.v)); }
  friend Ops Cos(Ops x) { return fn(kCos, sim5::Cos(x.v)); }
  friend Ops Acos(Ops x) { return fn(kAcos, sim5::Acos(x.v)); }
  friend Ops Asin(Ops x) { return fn(kAsin, sim5::Asin(x.v)); }
  friend Ops Atan(Ops x) { return fn(kAtan, sim5::Atan(x.v)); }
  friend Ops Atanh(Ops x) { return fn(kAtanh, sim5::Atanh(x.v)); }
  friend Ops Log(Ops x) { return fn(kLog, sim5::Log(x.v)); }
  friend Ops Log1p(Ops x) { return fn(kLog1p, sim5::Log1p(x.v)); }
  friend Ops Pow(Ops x, Ops y) { return fn(kPow, sim5::Pow(x.v, y.v)); }
  friend Ops Floor(Ops x) { return Ops(sim5::Floor(x.v)); }
  friend Ops Ceil(Ops x) { return Ops(sim5::Ceil(x.v)); }
  friend Ops Abs(Ops x) { return Ops(sim5::Abs(x.v)); }
  friend Ops Ldexp(Ops x, int e) { return Ops(sim5::Ldexp(x.v, e)); }
  friend Ops Frexp(Ops x, int* e) { return Ops(sim5::Frexp(x.v, e)); }
  friend bool IsFinite(Ops x) { return sim5::IsFinite(x.v); }
  friend bool IsInf(Ops x) { return sim5::IsInf(x.v); }
};

template <typename T>
struct Prec<Ops<T>> {
  static constexpr int kRfDup = Prec<T>::kRfDup, kKAgm = Prec<T>::kKAgm,
                       kJacobiAgm = Prec<T>::kJacobiAgm;
  static constexpr Ops<T> eps() { return Ops<T>(Prec<T>::eps()); }
  static constexpr Ops<T> tiny() { return Ops<T>(Prec<T>::tiny()); }
  static constexpr Ops<T> rf_floor() { return Ops<T>(Prec<T>::rf_floor()); }
  static constexpr Ops<T> splitter() { return Ops<T>(Prec<T>::splitter()); }
  static constexpr Ops<T> guard_1e300() {
    return Ops<T>(Prec<T>::guard_1e300());
  }
  static constexpr Ops<T> r_observer() {
    return Ops<T>(Prec<T>::r_observer());
  }
};

template <>
struct IsF32<Ops<float>> : std::true_type {};

template <typename T>
struct Wide<Ops<T>> {
  using type = Ops<double>;
};

}  // namespace sim5

namespace {

// a depth policy that counts each chain's levels into t_levels
template <typename Base>
struct Counted : Base {
  static void note(int chain, int levels) {
    long long* c = t_levels[chain];
    ++c[0];
    c[1] += levels;
    if (levels > c[2]) c[2] = levels;
  }
};

}  // namespace

namespace {

using sim5::Ops;

sim5::GaussRule rule(const double* g) {
  sim5::GaussRule q;
  for (int k = 0; k < 16; ++k) {
    q.x[k] = g[k];
    q.w[k] = g[16 + k];
  }
  for (int k = 0; k < 7; ++k) q.edges[k] = g[32 + k];
  return q;
}

// the counts of the calling thread: [pass][precision][kind], then
// [pass][precision][transcendental], then [chain][3]
constexpr int kOpWords = 2 * 2 * kKinds, kFnWords = 2 * 2 * kFns,
              kLevelWords = sim5::kChainKinds * 3;

struct Tally {
  long long ops[kOpWords] = {}, fns[kFnWords] = {}, levels[kLevelWords] = {};
};

void clear_thread() {
  for (int p = 0; p < 2; ++p) {
    for (int k = 0; k < kKinds; ++k) t_ops[p][k] = 0;
    for (int f = 0; f < kFns; ++f) t_fn[p][f] = 0;
  }
  for (int c = 0; c < sim5::kChainKinds; ++c)
    for (int j = 0; j < 3; ++j) t_levels[c][j] = 0;
}

// the thread's counts since clear_thread() added to pass `pass` of *t, and
// cleared
void take(Tally* t, int pass) {
  for (int p = 0; p < 2; ++p) {
    for (int k = 0; k < kKinds; ++k)
      t->ops[(pass * 2 + p) * kKinds + k] += t_ops[p][k];
    for (int f = 0; f < kFns; ++f)
      t->fns[(pass * 2 + p) * kFns + f] += t_fn[p][f];
  }
  for (int c = 0; c < sim5::kChainKinds; ++c) {
    long long* l = t->levels + 3 * c;
    l[0] += t_levels[c][0];
    l[1] += t_levels[c][1];
    if (t_levels[c][2] > l[2]) l[2] = t_levels[c][2];
  }
  clear_thread();
}

// fn(i, tally) over pixels [0, npix) in `threads` bands, fn taking each
// pass's counts into its tally; the threads' tallies added into out
template <typename F>
void bands(long long npix, int threads, long long* out, F fn) {
  threads = threads < 1 ? 1 : threads;
  std::vector<Tally> tallies(threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t]() {
      clear_thread();
      for (long long i = t; i < npix; i += threads) fn(i, &tallies[t]);
    });
  for (auto& th : pool) th.join();
  for (const Tally& t : tallies) {
    for (int j = 0; j < kOpWords; ++j) out[j] += t.ops[j];
    for (int j = 0; j < kFnWords; ++j) out[kOpWords + j] += t.fns[j];
    long long* l = out + kOpWords + kFnWords;
    for (int c = 0; c < sim5::kChainKinds; ++c) {
      l[3 * c] += t.levels[3 * c];
      l[3 * c + 1] += t.levels[3 * c + 1];
      if (t.levels[3 * c + 2] > l[3 * c + 2]) l[3 * c + 2] = t.levels[3 * c + 2];
    }
  }
}

template <typename T, bool kAzm, typename D>
void seed_t(double a, double incl, double rmax, double r_start, double t0,
            int n, const sim5::GaussRule& q, T* x0, T* k, unsigned char* ok,
            int threads, long long* ops) {
  using O = Ops<T>;
  bands((long long)n * n, threads, ops, [&](long long i, Tally* tally) {
    const O i_ = O(T(incl));
    const O c = Cos(i_), s = Sin(i_);
    O vx[4], vk[4];
    sim5::Geod<O> g;
    O P0s;
    bool v = sim5::seed_geometry(O(T(a)), i_, c, s, O(T(rmax)), O(T(r_start)),
                                 O(T(t0)), (int)(i % n), (int)(i / n), n, g,
                                 P0s, vx, vk);
    take(tally, 0);
    if (kAzm) {
      sim5::NoStage st;
      v = sim5::seed_azimuth<O, Counted<D>>(v, g, P0s, O(T(r_start)), q, vx,
                                            vk, st);
    }
    take(tally, 1);
    for (int j = 0; j < 4; ++j) {
      x0[4 * i + j] = vx[j].v;
      k[4 * i + j] = vk[j].v;
    }
    ok[i] = v;
  });
}

template <typename T, typename D>
void seed_d(int azm, double a, double incl, double rmax, double r_start,
            double t0, int n, const sim5::GaussRule& q, void* x0, void* k,
            unsigned char* ok, int threads, long long* ops) {
  T *x = static_cast<T*>(x0), *kk = static_cast<T*>(k);
  if (azm)
    seed_t<T, true, D>(a, incl, rmax, r_start, t0, n, q, x, kk, ok, threads,
                       ops);
  else
    seed_t<T, false, D>(a, incl, rmax, r_start, t0, n, q, x, kk, ok, threads,
                        ops);
}

template <typename D>
void crossing_d(double a, double incl, double rmax, double rms, int n,
                int order, const sim5::GaussRule& q, double* r, double* phi,
                double* g, double* dt, unsigned char* hit, int threads,
                long long* ops) {
  using O = Ops<double>;
  bands((long long)n * n, threads, ops, [&](long long i, Tally* tally) {
    const O c = Cos(O(incl)), s = Sin(O(incl));
    const int ix = (int)(i % n), iy = (int)(i / n);
    sim5::Geod<O> geo;
    O P, r_s, gf;
    const bool h = sim5::crossing_geometry(O(a), O(incl), c, s, O(rmax),
                                           O(rms), order, ix, iy, n, geo, P,
                                           r_s, gf);
    take(tally, 0);
    O vphi(0.0), vdt(0.0);
    sim5::NoStage st;
    sim5::crossing_hit<O, Counted<D>>(h, geo, P, r_s, ix, iy, n, O(rmax), q,
                                      vphi, vdt, st);
    take(tally, 1);
    r[i] = r_s.v;
    phi[i] = h ? vphi.v : 0.0;
    g[i] = h ? gf.v : 1.0;
    dt[i] = h ? vdt.v : 0.0;
    hit[i] = h;
  });
}

}  // namespace

// The crossing map of one image order as the crossing-map kernels compute
// it (sim5_crossing_map's arguments; the outputs in host memory), their
// Carlson chains at AdaptiveDepth if `adaptive`, else at FixedDepth (PR
// 14's kernel), and the counts into ops (added to): [pass][f64, f32]
// [additions, multiplications, divisions, square roots, transcendentals],
// then [pass][f64, f32][sin, cos, acos, asin, atan, atanh, log, log1p,
// pow], then [RF, RD, RJ, RC][calls, levels, deepest] (the deepest is the
// largest seen).
extern "C" void sim5_ops_crossing(double a, double incl, double rmax,
                                  double rms, int n, int order, int adaptive,
                                  const double* gauss, double* r, double* phi,
                                  double* g, double* dt, unsigned char* hit,
                                  int threads, long long* ops) {
  const sim5::GaussRule q = rule(gauss);
  if (adaptive)
    crossing_d<sim5::AdaptiveDepth>(a, incl, rmax, rms, n, order, q, r, phi,
                                    g, dt, hit, threads, ops);
  else
    crossing_d<sim5::FixedDepth>(a, incl, rmax, rms, n, order, q, r, phi, g,
                                 dt, hit, threads, ops);
}

// The seed as the volume-seed kernels compute it (sim5_volume_seed's
// arguments; the outputs in host memory), its chains as
// sim5_ops_crossing's, and its counts into ops as sim5_ops_crossing's.
extern "C" void sim5_ops_seed(int f64, int azm, int adaptive, double a,
                              double incl, double rmax, double r_start,
                              double t0, int n, const double* gauss, void* x0,
                              void* k, unsigned char* ok, int threads,
                              long long* ops) {
  const sim5::GaussRule q = rule(gauss);
  if (f64 && adaptive)
    seed_d<double, sim5::AdaptiveDepth>(azm, a, incl, rmax, r_start, t0, n, q,
                                        x0, k, ok, threads, ops);
  else if (f64)
    seed_d<double, sim5::FixedDepth>(azm, a, incl, rmax, r_start, t0, n, q, x0,
                                     k, ok, threads, ops);
  else if (adaptive)
    seed_d<float, sim5::AdaptiveDepth>(azm, a, incl, rmax, r_start, t0, n, q,
                                       x0, k, ok, threads, ops);
  else
    seed_d<float, sim5::FixedDepth>(azm, a, incl, rmax, r_start, t0, n, q, x0,
                                    k, ok, threads, ops);
}
