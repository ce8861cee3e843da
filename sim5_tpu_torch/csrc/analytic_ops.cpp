// Operation counts of the crossing-map and volume-seed kernels: a host
// build (g++) of the kernels' per-pixel functions (azimuth.cuh) on a
// counting scalar, sim5::Ops<T>, which wraps T, computes every operation
// in T (the same bits as the kernels' pixels on T) and counts each
// addition or subtraction, multiplication, division, square root and
// transcendental function (sin, cos, acos, asin, atan, atanh, log, log1p,
// pow) it executes, by the precision it runs in.  The control flow is the
// kernels' own: a pixel counts the operations of its trajectory type and
// its branches only.  chip_smoke.py divides the counts of a run's pixels
// by the card's peak rates for the kernels' bound.  Built at first use by
// kernel_analytic.operation_counts (_build.load_host); it runs on the
// host's cores, one std::thread a band of pixels.

#include <thread>
#include <type_traits>
#include <vector>

#include "azimuth.cuh"

namespace {

enum Kind { kAdd, kMul, kDiv, kSqrt, kTrans, kKinds };
// the calling thread's counts, [f64, f32][kind]
thread_local long long t_ops[2][kKinds];

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

  static Ops tally(int k, T x) {
    ++t_ops[std::is_same<T, double>::value ? 0 : 1][k];
    return Ops(x);
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
  friend Ops Sin(Ops x) { return tally(kTrans, sim5::Sin(x.v)); }
  friend Ops Cos(Ops x) { return tally(kTrans, sim5::Cos(x.v)); }
  friend Ops Acos(Ops x) { return tally(kTrans, sim5::Acos(x.v)); }
  friend Ops Asin(Ops x) { return tally(kTrans, sim5::Asin(x.v)); }
  friend Ops Atan(Ops x) { return tally(kTrans, sim5::Atan(x.v)); }
  friend Ops Atanh(Ops x) { return tally(kTrans, sim5::Atanh(x.v)); }
  friend Ops Log(Ops x) { return tally(kTrans, sim5::Log(x.v)); }
  friend Ops Log1p(Ops x) { return tally(kTrans, sim5::Log1p(x.v)); }
  friend Ops Pow(Ops x, Ops y) { return tally(kTrans, sim5::Pow(x.v, y.v)); }
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

// fn(i) over pixels [0, npix) in `threads` bands; the threads' counts added
// into ops[2][kKinds]
template <typename F>
void bands(long long npix, int threads, long long* ops, F fn) {
  threads = threads < 1 ? 1 : threads;
  std::vector<std::vector<long long>> counts(threads,
                                             std::vector<long long>(2 * kKinds));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t]() {
      for (int p = 0; p < 2; ++p)
        for (int k = 0; k < kKinds; ++k) t_ops[p][k] = 0;
      for (long long i = t; i < npix; i += threads) fn(i);
      for (int p = 0; p < 2; ++p)
        for (int k = 0; k < kKinds; ++k) counts[t][p * kKinds + k] = t_ops[p][k];
    });
  for (auto& th : pool) th.join();
  for (int t = 0; t < threads; ++t)
    for (int j = 0; j < 2 * kKinds; ++j) ops[j] += counts[t][j];
}

template <typename T, bool kAzm>
void seed_t(double a, double incl, double rmax, double r_start, double t0,
            int n, const sim5::GaussRule& q, T* x0, T* k, unsigned char* ok,
            int threads, long long* ops) {
  using O = Ops<T>;
  bands((long long)n * n, threads, ops, [&](long long i) {
    const O i_ = O(T(incl));
    const O c = Cos(i_), s = Sin(i_);
    O vx[4], vk[4];
    bool v;
    sim5::seed_pixel<O, kAzm>(O(T(a)), i_, c, s, O(T(rmax)), O(T(r_start)),
                              O(T(t0)), (int)(i % n), (int)(i / n), n, q, vx,
                              vk, v);
    for (int j = 0; j < 4; ++j) {
      x0[4 * i + j] = vx[j].v;
      k[4 * i + j] = vk[j].v;
    }
    ok[i] = v;
  });
}

}  // namespace

// The crossing map of one image order as crossing_map<double> computes it
// (sim5_crossing_map's arguments; the outputs in host memory), and the
// operations its pixels ran into ops[0..10) (f64 then f32: additions,
// multiplications, divisions, square roots, transcendentals), added to.
extern "C" void sim5_ops_crossing(double a, double incl, double rmax,
                                  double rms, int n, int order,
                                  const double* gauss, double* r, double* phi,
                                  double* g, double* dt, unsigned char* hit,
                                  int threads, long long* ops) {
  const sim5::GaussRule q = rule(gauss);
  using O = Ops<double>;
  bands((long long)n * n, threads, ops, [&](long long i) {
    const O c = Cos(O(incl)), s = Sin(O(incl));
    O vr, vphi, vg, vdt;
    bool h;
    sim5::crossing_pixel<O>(O(a), O(incl), c, s, O(rmax), O(rms), order,
                            (int)(i % n), (int)(i / n), n, q, vr, vphi, vg,
                            vdt, h);
    r[i] = vr.v;
    phi[i] = vphi.v;
    g[i] = vg.v;
    dt[i] = vdt.v;
    hit[i] = h;
  });
}

// The seed as volume_seed<T, azm != 0> computes it (sim5_volume_seed's
// arguments; the outputs in host memory), and its operations into ops as
// sim5_ops_crossing.
extern "C" void sim5_ops_seed(int f64, int azm, double a, double incl,
                              double rmax, double r_start, double t0, int n,
                              const double* gauss, void* x0, void* k,
                              unsigned char* ok, int threads, long long* ops) {
  const sim5::GaussRule q = rule(gauss);
  if (f64) {
    double *x = static_cast<double*>(x0), *kk = static_cast<double*>(k);
    if (azm)
      seed_t<double, true>(a, incl, rmax, r_start, t0, n, q, x, kk, ok,
                           threads, ops);
    else
      seed_t<double, false>(a, incl, rmax, r_start, t0, n, q, x, kk, ok,
                            threads, ops);
  } else {
    float *x = static_cast<float*>(x0), *kk = static_cast<float*>(k);
    if (azm)
      seed_t<float, true>(a, incl, rmax, r_start, t0, n, q, x, kk, ok,
                          threads, ops);
    else
      seed_t<float, false>(a, incl, rmax, r_start, t0, n, q, x, kk, ok,
                           threads, ops);
  }
}
