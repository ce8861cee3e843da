// The analytic geodesic engine of one ray, for one thread: the device
// functions that the disk image kernel (disk_image.cu) runs per pixel, and
// that the crossing-map and volume-seed kernels build on (azimuth.cuh).
//
// Each function is the per-lane form of its plain torch version in
// sim5_tpu_torch (named beside it): the same operations in the same order,
// with the torch version's masked evaluation of every trajectory type
// replaced by a branch on the lane's own type that selects the arguments
// of one call site a special function (R_roots' rf and K, position_rad's
// sncndn), so that a warp holding several types runs each chain once.
// The disk image's frame constants (make_frame) and pixel (nt_pixel) are
// at the end; g++ builds this header too (SIM5_HD is inline there), for a
// host check of the kernel's arithmetic.  Constants are cast to the
// scalar type T first, as torch casts a Python scalar to the tensor's
// dtype, so T = float runs the f32 fast path and T = double the f64
// parity path.  The fixed depths are the port's by dtype (Prec<T>): RF
// duplication 16 / 7, the K AGM 9 / 7 and the Jacobi AGM 13 / 8; they are
// not convergence loops.
//
// The per-pixel chain (the geodesic, the disk, make_frame and nt_pixel) is
// templated on its scalar S: T for the image kernel, Dual<T, K> (a value
// and K tangents) for the tangent kernel, which differentiates the same
// operations in forward mode in K directions at once (see Dual below).
// With S = T the operations are those the chain ran before it was
// templated, bit for bit.
//
// Build without fast math and without FMA contraction (--fmad=false): the
// error-free transforms (two_sum, two_prod, the Veltkamp split) need each
// product and sum rounded on its own, as the torch version rounds them.
#pragma once

#include <cfloat>
#include <cmath>
#include <type_traits>

#if defined(__CUDACC__)
#define SIM5_HD __host__ __device__ __forceinline__
#else
#define SIM5_HD inline
#endif

namespace sim5 {

// ---------------------------------------------------------------------------
// precision traits and IEEE math by scalar type
// ---------------------------------------------------------------------------

template <typename T>
struct Prec;

template <>
struct Prec<double> {
  static constexpr int kRfDup = 16, kKAgm = 9, kJacobiAgm = 13;
  SIM5_HD static constexpr double eps() { return DBL_EPSILON; }
  SIM5_HD static constexpr double tiny() { return DBL_MIN; }
  SIM5_HD static constexpr double rf_floor() { return 1e-300; }
  SIM5_HD static constexpr double splitter() { return 134217729.0; }
  // the torch version's literal 1e-300 guard, and the observer's radius
  // 1e300, in this type
  SIM5_HD static constexpr double guard_1e300() { return 1e-300; }
  SIM5_HD static constexpr double r_observer() { return 1e300; }
};

template <>
struct Prec<float> {
  static constexpr int kRfDup = 7, kKAgm = 7, kJacobiAgm = 8;
  SIM5_HD static constexpr float eps() { return FLT_EPSILON; }
  SIM5_HD static constexpr float tiny() { return FLT_MIN; }
  SIM5_HD static constexpr float rf_floor() { return 1e-37f; }
  SIM5_HD static constexpr float splitter() { return 4097.0f; }
  // 1e-300 and 1e300 cast to f32, as torch casts the literals: 0 and inf
  SIM5_HD static constexpr float guard_1e300() { return 0.0f; }
  SIM5_HD static constexpr float r_observer() { return INFINITY; }
};

constexpr double kPi = 3.141592653589793;
constexpr double kSqrt3 = 1.7320508075688772;

#define SIM5_MATH1(NAME, FN)                          \
  SIM5_HD double NAME(double x) { return ::FN(x); }   \
  SIM5_HD float NAME(float x) { return ::FN##f(x); }
SIM5_MATH1(Sqrt, sqrt)
SIM5_MATH1(Sin, sin)
SIM5_MATH1(Cos, cos)
SIM5_MATH1(Acos, acos)
SIM5_MATH1(Log, log)
SIM5_MATH1(Log1p, log1p)
SIM5_MATH1(Floor, floor)
SIM5_MATH1(Abs, fabs)
#undef SIM5_MATH1
SIM5_HD double Pow(double x, double y) { return ::pow(x, y); }
SIM5_HD float Pow(float x, float y) { return ::powf(x, y); }
SIM5_HD double Ldexp(double x, int e) { return ::ldexp(x, e); }
SIM5_HD float Ldexp(float x, int e) { return ::ldexpf(x, e); }
SIM5_HD double Frexp(double x, int* e) { return ::frexp(x, e); }
SIM5_HD float Frexp(float x, int* e) { return ::frexpf(x, e); }

template <typename T>
SIM5_HD bool IsFinite(T x) {
#if defined(__CUDA_ARCH__)
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

// whether T computes in f32 (the f32 rescale of quartic_roots and the f32
// tolerances): float; a host build's counting scalar specializes it
template <typename T>
struct IsF32 : std::is_same<T, float> {};

template <typename T>
SIM5_HD T Nan() {
  return T(NAN);
}

// torch.maximum / torch.minimum: NaN in either operand gives NaN
template <typename T>
SIM5_HD T Max(T a, T b) {
  return (a != a || b != b) ? Nan<T>() : (a > b ? a : b);
}
template <typename T>
SIM5_HD T Min(T a, T b) {
  return (a != a || b != b) ? Nan<T>() : (a < b ? a : b);
}
// torch.clamp: NaN passes through
template <typename T>
SIM5_HD T ClampMin(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
SIM5_HD T ClampMax(T x, T hi) { return x > hi ? hi : x; }
template <typename T>
SIM5_HD T Clamp(T x, T lo, T hi) { return ClampMax(ClampMin(x, lo), hi); }
// torch.sign: 0 for 0 and NaN
template <typename T>
SIM5_HD T Sign(T x) { return T((x > T(0)) - (x < T(0))); }

// ---------------------------------------------------------------------------
// forward mode: a value and K tangents
// ---------------------------------------------------------------------------

// Dual<T, K>: v + sum_j d[j] eps_j, eps_i eps_j = 0: a value and K
// tangents (slots), one a direction.  The functions of the per-pixel chain
// are templated on their scalar S (T, or Dual<T, K> for the tangent
// kernel) with T = Base<S> the type of their constants, so a constant
// stays a T and multiplies a tangent as torch multiplies by a Python
// number.  Comparisons and masks read the value only and carry no tangent,
// as torch.where's condition.  Every operation computes what depends on
// the values alone once, then applies it to each slot in the expression
// order of the one-tangent form, so slot j of a K-slot pass runs the
// arithmetic of a one-slot pass seeded with direction j and gives its
// bits.  The elementary functions below give the derivative torch's
// autograd gives; the special functions whose plain version carries a
// rule (rf, sncndn), the two-float transforms and the quartic's roots have
// overloads of their own further on, which likewise compute the rule's
// coefficients once and apply them to every slot.
#define SIM5_SLOTS _Pragma("unroll") for (int j = 0; j < K; ++j)

template <typename T, int K = 1>
struct Dual {
  T v, d[K];
  Dual() = default;
  template <typename C,
            typename = typename std::enable_if<std::is_arithmetic<C>::value>::type>
  SIM5_HD Dual(C c) : v(T(c)) {
    SIM5_SLOTS d[j] = T(0);
  }

  SIM5_HD friend Dual operator-(Dual a) {
    a.v = -a.v;
    SIM5_SLOTS a.d[j] = -a.d[j];
    return a;
  }
  SIM5_HD friend Dual operator+(Dual a, Dual b) {
    a.v = a.v + b.v;
    SIM5_SLOTS a.d[j] = a.d[j] + b.d[j];
    return a;
  }
  SIM5_HD friend Dual operator+(Dual a, T b) {
    a.v = a.v + b;
    return a;
  }
  SIM5_HD friend Dual operator+(T a, Dual b) {
    b.v = a + b.v;
    return b;
  }
  SIM5_HD friend Dual operator-(Dual a, Dual b) {
    a.v = a.v - b.v;
    SIM5_SLOTS a.d[j] = a.d[j] - b.d[j];
    return a;
  }
  SIM5_HD friend Dual operator-(Dual a, T b) {
    a.v = a.v - b;
    return a;
  }
  SIM5_HD friend Dual operator-(T a, Dual b) {
    b.v = a - b.v;
    SIM5_SLOTS b.d[j] = -b.d[j];
    return b;
  }
  SIM5_HD friend Dual operator*(Dual a, Dual b) {
    Dual r;
    r.v = a.v * b.v;
    SIM5_SLOTS r.d[j] = a.d[j] * b.v + a.v * b.d[j];
    return r;
  }
  SIM5_HD friend Dual operator*(Dual a, T b) {
    a.v = a.v * b;
    SIM5_SLOTS a.d[j] = a.d[j] * b;
    return a;
  }
  SIM5_HD friend Dual operator*(T a, Dual b) {
    b.v = a * b.v;
    SIM5_SLOTS b.d[j] = a * b.d[j];
    return b;
  }
  // the quotient rule as torch's forward mode writes it: (da - q db) / b
  SIM5_HD friend Dual operator/(Dual a, Dual b) {
    Dual r;
    r.v = a.v / b.v;
    SIM5_SLOTS r.d[j] = (a.d[j] - r.v * b.d[j]) / b.v;
    return r;
  }
  SIM5_HD friend Dual operator/(Dual a, T b) {
    a.v = a.v / b;
    SIM5_SLOTS a.d[j] = a.d[j] / b;
    return a;
  }
  SIM5_HD friend Dual operator/(T a, Dual b) {
    Dual r;
    r.v = a / b.v;
    SIM5_SLOTS r.d[j] = -(r.v * b.d[j]) / b.v;
    return r;
  }
#define SIM5_DUAL_CMP(OP)                                                    \
  SIM5_HD friend bool operator OP(Dual a, Dual b) { return a.v OP b.v; }     \
  SIM5_HD friend bool operator OP(Dual a, T b) { return a.v OP b; }          \
  SIM5_HD friend bool operator OP(T a, Dual b) { return a OP b.v; }
  SIM5_DUAL_CMP(<)
  SIM5_DUAL_CMP(<=)
  SIM5_DUAL_CMP(>)
  SIM5_DUAL_CMP(>=)
  SIM5_DUAL_CMP(==)
  SIM5_DUAL_CMP(!=)
#undef SIM5_DUAL_CMP
};

template <typename S>
struct BaseOf {
  using type = S;
};
template <typename T, int K>
struct BaseOf<Dual<T, K>> {
  using type = T;
};
// the type of a scalar's value: T for T and for Dual<T, K>
template <typename S>
using Base = typename BaseOf<S>::type;

// x's tangents times c (a coefficient of the values) into r
template <typename T, int K>
SIM5_HD Dual<T, K> scaled(T v, T c, const Dual<T, K>& x) {
  Dual<T, K> r;
  r.v = v;
  SIM5_SLOTS r.d[j] = c * x.d[j];
  return r;
}
// x's tangents over c into r
template <typename T, int K>
SIM5_HD Dual<T, K> divided(T v, const Dual<T, K>& x, T c) {
  Dual<T, K> r;
  r.v = v;
  SIM5_SLOTS r.d[j] = x.d[j] / c;
  return r;
}

template <typename T, int K>
SIM5_HD Dual<T, K> Sqrt(Dual<T, K> x) {
  const T s = Sqrt(x.v);
  return divided(s, x, T(2) * s);
}
template <typename T, int K>
SIM5_HD Dual<T, K> Sin(Dual<T, K> x) { return scaled(Sin(x.v), Cos(x.v), x); }
template <typename T, int K>
SIM5_HD Dual<T, K> Cos(Dual<T, K> x) { return scaled(Cos(x.v), -Sin(x.v), x); }
template <typename T, int K>
SIM5_HD Dual<T, K> Acos(Dual<T, K> x) {
  const T den = Sqrt(T(1) - x.v * x.v);
  Dual<T, K> r;
  r.v = Acos(x.v);
  SIM5_SLOTS r.d[j] = -x.d[j] / den;
  return r;
}
template <typename T, int K>
SIM5_HD Dual<T, K> Log(Dual<T, K> x) { return divided(Log(x.v), x, x.v); }
template <typename T, int K>
SIM5_HD Dual<T, K> Log1p(Dual<T, K> x) {
  return divided(Log1p(x.v), x, T(1) + x.v);
}
template <typename T, int K>
SIM5_HD Dual<T, K> Floor(Dual<T, K> x) { return Dual<T, K>(Floor(x.v)); }
// torch.abs: sgn(x) dx, 0 at x == 0
template <typename T, int K>
SIM5_HD Dual<T, K> Abs(Dual<T, K> x) {
  Dual<T, K> r;
  r.v = Abs(x.v);
  SIM5_SLOTS r.d[j] = x.v > T(0) ? x.d[j] : (x.v < T(0) ? -x.d[j] : T(0));
  return r;
}
template <typename T, int K>
SIM5_HD bool IsFinite(Dual<T, K> x) { return IsFinite(x.v); }
// torch.clamp: the tangent passes where the bound does not bite
template <typename T, int K>
SIM5_HD Dual<T, K> ClampMin(Dual<T, K> x, T lo) {
  return x < lo ? Dual<T, K>(lo) : x;
}
template <typename T, int K>
SIM5_HD Dual<T, K> ClampMax(Dual<T, K> x, T hi) {
  return x > hi ? Dual<T, K>(hi) : x;
}
template <typename T, int K>
SIM5_HD Dual<T, K> Clamp(Dual<T, K> x, T lo, T hi) {
  return ClampMax(ClampMin(x, lo), hi);
}

// ---------------------------------------------------------------------------
// error-free transforms (utils/fastmath.py)
// ---------------------------------------------------------------------------

// two_sum: a + b = s + e exactly
template <typename T>
SIM5_HD void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// Veltkamp split a = hi + lo, both halves exact (polyroots.py:_split)
template <typename T>
SIM5_HD void split(T a, T& hi, T& lo) {
  const T c = a * Prec<T>::splitter();
  hi = c - (c - a);
  lo = a - hi;
}

// two_prod (Dekker): a * b = p + e exactly
template <typename T>
SIM5_HD void two_prod(T a, T b, T& p, T& e) {
  T ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  p = a * b;
  e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo;
}

// sqrt_df: sqrt(x) = hi + lo to ~ulp^2
template <typename T>
SIM5_HD void sqrt_df(T x, T& hi, T& lo) {
  hi = Sqrt(x);
  const T hs = hi > T(0) ? hi : T(1);
  T p, e;
  two_prod(hs, hs, p, e);
  lo = hi > T(0) ? ((x - p) - e) / (T(2) * hs) : T(0);
}

// vlog(u) = u - log1p(u) without cancellation; log is IEEE-accurate here
template <typename T>
SIM5_HD T vlog(T u) {
  if (std::is_same<T, double>::value) return u - Log1p(u);
  if (u <= T(0.5)) {
    const T s = u / (T(2) + u);
    const T s2 = s * s;
    return u * u / (T(2) + u) -
           T(2) * s * s2 *
               (T(1.0 / 3.0) +
                s2 * (T(0.2) + s2 * (T(1.0 / 7.0) + s2 / T(9))));
  }
  return u - Log(T(1) + u);
}

// The two-float transforms on duals: the values as above; the tangent of
// hi + lo, in plain arithmetic, all on hi (the error terms carry none, as
// autodiff through the transforms gives them up to rounding)
template <typename T, int K>
SIM5_HD void two_sum(Dual<T, K> a, Dual<T, K> b, Dual<T, K>& s,
                     Dual<T, K>& e) {
  two_sum(a.v, b.v, s.v, e.v);
  SIM5_SLOTS {
    s.d[j] = a.d[j] + b.d[j];
    e.d[j] = T(0);
  }
}
template <typename T, int K>
SIM5_HD void two_prod(Dual<T, K> a, Dual<T, K> b, Dual<T, K>& p,
                      Dual<T, K>& e) {
  two_prod(a.v, b.v, p.v, e.v);
  SIM5_SLOTS {
    p.d[j] = a.d[j] * b.v + a.v * b.d[j];
    e.d[j] = T(0);
  }
}
template <typename T, int K>
SIM5_HD void sqrt_df(Dual<T, K> x, Dual<T, K>& hi, Dual<T, K>& lo) {
  sqrt_df(x.v, hi.v, lo.v);
  const T den = T(2) * hi.v;
  SIM5_SLOTS {
    hi.d[j] = x.d[j] / den;
    lo.d[j] = T(0);
  }
}
// d vlog(u) = (1 - 1 / (1 + u)) du = u / (1 + u) du
template <typename T, int K>
SIM5_HD Dual<T, K> vlog(Dual<T, K> u) {
  return scaled(vlog(u.v), u.v / (T(1) + u.v), u);
}

// ---------------------------------------------------------------------------
// polynomial roots (special/polyroots.py)
// ---------------------------------------------------------------------------

// _cbrt: real cube root of x >= 0, power form plus one Newton step
template <typename T>
SIM5_HD T cbrt_pos(T x) {
  const T y = Pow(x, T(1.0 / 3.0));
  const T ys = y > T(0) ? y : T(1);
  return y > T(0) ? y - (y * y * y - x) / (T(3) * ys * ys) : y;
}

// quadratic_roots: a x^2 + b x + c; returns the number of real roots
template <typename T>
SIM5_HD int quadratic_roots(T a, T b, T c, T re[2], T im[2]) {
  const T d = b * b - T(4) * a * c;
  const T sq = Sqrt(Abs(d));
  const T qq = T(-0.5) * (b + Sign(b) * sq);
  const T a_safe = a == T(0) ? T(1) : a;
  const T qq_safe = qq == T(0) ? T(1) : qq;
  if (d >= T(0)) {
    const T r1 = qq / a_safe, r2 = c / qq_safe;
    re[0] = Max(r1, r2);
    re[1] = Min(r1, r2);
    im[0] = im[1] = T(0);
    return 2;
  }
  re[0] = re[1] = -b / (T(2) * a_safe);
  im[0] = sq / (T(2) * a_safe);
  im[1] = -sq / (T(2) * a_safe);
  return 0;
}

// cubic_roots: x^3 + p x^2 + q x + r (monic)
template <typename T>
SIM5_HD void cubic_roots(T p, T q, T r, T re[3], T im[3]) {
  const T Q = (p * p - T(3) * q) / T(9);
  const T R = (T(2) * (p * p * p) - T(9) * p * q + T(27) * r) / T(54);
  if (R * R < Q * Q * Q) {
    const T Qs = Q > T(0) ? Q : T(1);
    const T arg = R / Sqrt(Qs * Qs * Qs);
    const T th = Acos(Clamp(arg, T(-1), T(1)));
    const T sq = Sqrt(Qs);
    re[0] = T(-2) * sq * Cos(th / T(3)) - p / T(3);
    re[1] = T(-2) * sq * Cos((th + T(2.0 * kPi)) / T(3)) - p / T(3);
    re[2] = T(-2) * sq * Cos((th - T(2.0 * kPi)) / T(3)) - p / T(3);
    im[0] = im[1] = im[2] = T(0);
    return;
  }
  const T disc = R * R - Q * Q * Q;
  const T A = -Sign(R) * cbrt_pos(Abs(R) + Sqrt(disc));
  const T As = A == T(0) ? T(1) : A;
  const T B = A == T(0) ? T(0) : Q / As;
  const T yi = T(kSqrt3 / 2.0) * (A - B);
  re[0] = (A + B) - p / T(3);
  re[1] = re[2] = T(-0.5) * (A + B) - p / T(3);
  im[0] = T(0);
  im[1] = yi;
  im[2] = -yi;
}

// frexp exponent of v (of 1 where v == 0, 0 for inf and NaN)
template <typename T>
SIM5_HD int exponent(T v) {
  if (!IsFinite(v)) return 0;
  int e = 0;
  (void)Frexp(v == T(0) ? T(1) : v, &e);
  return e;
}

SIM5_HD int floordiv(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// quartic_roots: z^4 + a3 z^3 + a2 z^2 + a1 z + a0; returns n_real
template <typename T>
SIM5_HD int quartic_roots(T a3, T a2, T a1, T a0, T re[4], T im[4]) {
  const T sh = a3 / T(4);
  T p = a2 - T(3) * a3 * a3 / T(8);
  T q = a1 - a3 * a2 / T(2) + a3 * a3 * a3 / T(8);
  T r = a0 - a3 * a1 / T(4) + a3 * a3 * a2 / T(16) -
        T(3) * Pow(a3, T(4)) / T(256);
  T lam = T(1);
  if (IsF32<T>::value) {
    // exact power-of-two rescale into the f32 exponent range
    int e = floordiv(exponent(p) + 1, 2);
    const int eq = floordiv(exponent(q) + 2, 3);
    const int er = floordiv(exponent(r) + 3, 4);
    e = e > eq ? e : eq;
    e = e > (er > 0 ? er : 0) ? e : (er > 0 ? er : 0);
    lam = Ldexp(T(1), e);
    const T il = T(1) / lam;
    p = p * il * il;
    q = q * il * il * il;
    r = r * (il * il) * (il * il);
  }
  T cre[3], cim[3];
  cubic_roots(-p, T(-4) * r, T(4) * p * r - q * q, cre, cim);
  T u = -T(INFINITY);
  for (int i = 0; i < 3; ++i)
    u = Max(u, cim[i] == T(0) ? cre[i] : -T(INFINITY));
  const T k100 = T(100.0 * static_cast<double>(Prec<T>::eps()));
  const bool one_real = cim[1] != T(0);
  const T utol = k100 * (Abs(u) + Abs(p));
  const T yr = cre[1];
  if (one_real && (u - p < utol) && (yr - p > utol)) u = yr;
  const T w2 = u - p;
  T w = Sqrt(ClampMin(w2, T(0)));
  const bool w_zero = w2 <= k100 * (Abs(u) + Abs(p));
  const T ws = w_zero ? T(1) : w;
  T c1 = u / T(2) - (w_zero ? T(0) : q / (T(2) * ws));
  T c2 = u / T(2) + (w_zero ? T(0) : q / (T(2) * ws));
  if (w_zero) {
    // biquadratic case, the cancelling partner by Vieta
    const T d_b = p * p - T(4) * r;
    const T sd_b = Sqrt(Abs(d_b));
    T c_big = T(0.5) * (p + Sign(p) * sd_b);
    if (Sign(p) == T(0)) c_big = T(0.5) * sd_b;
    const T cbs = c_big == T(0) ? T(1) : c_big;
    const T c_small = c_big == T(0) ? T(0) : r / cbs;
    if (d_b >= T(0)) {
      c1 = p >= T(0) ? c_small : c_big;
      c2 = p >= T(0) ? c_big : c_small;
    } else {
      c1 = (p - sd_b) / T(2);
      c2 = (p + sd_b) / T(2);
    }
    w = T(0);
  }
  const int n1 = quadratic_roots(T(1), w, c1, re, im);
  const int n2 = quadratic_roots(T(1), -w, c2, re + 2, im + 2);
  for (int i = 0; i < 4; ++i) {
    re[i] = re[i] * lam - sh;
    im[i] = im[i] * lam;
  }
  return n1 + n2;
}

// sort_quartic_roots: real roots first, descending; complex keep order
template <typename T>
SIM5_HD int sort_quartic_roots(T re[4], T im[4]) {
  T key[4];
  int n_real = 0;
  for (int j = 0; j < 4; ++j) {
    const bool real = im[j] == T(0);
    n_real += real;
    key[j] = real ? -re[j] : T(INFINITY);
  }
  const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
  for (int c = 0; c < 5; ++c) {
    const int i = net[c][0], j = net[c][1];
    if (key[i] > key[j]) {
      T t = key[i]; key[i] = key[j]; key[j] = t;
      t = re[i]; re[i] = re[j]; re[j] = t;
      t = im[i]; im[i] = im[j]; im[j] = t;
    }
  }
  return n_real;
}

// _compensated_R: z^4 + c2 z^2 + c1 z + c0 by compensated Horner
template <typename T>
SIM5_HD T compensated_R(T z, T c2, T c1, T c0) {
  T zh, zl, sh, sl, e2;
  split(z, zh, zl);
  T s = z * z;
  T e = (zh * zh - s + T(2) * zh * zl) + zl * zl;
  two_sum(s, c2, s, e2);
  T err = e + e2;
  split(s, sh, sl);
  T p = s * z;
  e = (sh * zh - p + sh * zl + sl * zh) + sl * zl;
  err = err * z + e;
  two_sum(p, c1, s, e2);
  err = err + e2;
  split(s, sh, sl);
  p = s * z;
  e = (sh * zh - p + sh * zl + sl * zh) + sl * zl;
  err = err * z + e;
  two_sum(p, c0, s, e2);
  return s + (err + e2);
}

// polish_quartic_real_roots_df, one root: hi + lo
template <typename T>
SIM5_HD void polish_root_df(T re, T im, T c2, T c1, T c0, T& hi, T& lo) {
  const T z0 = re;
  const T R0 = compensated_R(z0, c2, c1, c0);
  const T dR0 = (T(4) * z0 * z0 + T(2) * c2) * z0 + c1;
  const T az = Abs(z0);
  const T scale = T(4) * (az * az * az) + T(2) * Abs(c2 * z0) + Abs(c1);
  const bool ok = im == T(0) && Abs(dR0) > T(1e-5) * scale && IsFinite(R0);
  if (!ok) {
    hi = re;
    lo = T(0);
    return;
  }
  const T da = -R0 / dR0;
  T z1f, rho;
  two_sum(z0, da, z1f, rho);
  const T dp = da - rho;
  const T dp2 = dp * dp;
  const T R1 = R0 + dR0 * dp + (T(6) * z0 * z0 + c2) * dp2 +
               T(4) * z0 * dp * dp2 + dp2 * dp2;
  const T dR1 = (T(4) * z1f * z1f + T(2) * c2) * z1f + c1;
  two_sum(z1f, -R1 / dR1, hi, lo);
}

// the radial quartic z^4 + c2 z^2 + c1 z + c0: its roots sorted (real ones
// first, descending), the real ones polished to hi + lo; returns n_real
template <typename T>
SIM5_HD int radial_roots(T c2, T c1, T c0, T rr[4], T ri[4], T lo[4]) {
  quartic_roots(T(0), c2, c1, c0, rr, ri);
  const int nrr = sort_quartic_roots(rr, ri);
  for (int j = 0; j < 4; ++j) polish_root_df(rr[j], ri[j], c2, c1, c0, rr[j], lo[j]);
  return nrr;
}

// the roots on duals: the values as above, the tangents by the implicit
// rule dz = -(dc2 z^2 + dc1 z + dc0) / R'(z) at each root (the polished hi
// of a real one, in complex arithmetic for a complex one), which autodiff
// through the closed form and the polish gives to the polish's residual;
// lo carries none.  R'(z) (and its squared modulus) once a root, the
// numerator and the quotient once a slot.
template <typename T, int K>
SIM5_HD int radial_roots(Dual<T, K> c2, Dual<T, K> c1, Dual<T, K> c0,
                         Dual<T, K> rr[4], Dual<T, K> ri[4],
                         Dual<T, K> lo[4]) {
  T vr[4], vi[4], vl[4];
  const int nrr = radial_roots(c2.v, c1.v, c0.v, vr, vi, vl);
  for (int i = 0; i < 4; ++i) {
    const T x = vr[i], y = vi[i];
    rr[i].v = x;
    ri[i].v = y;
    lo[i] = Dual<T, K>(vl[i]);
    if (y == T(0)) {
      const T Rp = (T(4) * x * x + T(2) * c2.v) * x + c1.v;
      SIM5_SLOTS {
        rr[i].d[j] = -((c2.d[j] * x + c1.d[j]) * x + c0.d[j]) / Rp;
        ri[i].d[j] = T(0);
      }
    } else {
      const T z2r = x * x - y * y, z2i = T(2) * x * y;
      const T z3r = z2r * x - z2i * y, z3i = z2r * y + z2i * x;
      const T pr = T(4) * z3r + T(2) * c2.v * x + c1.v;
      const T pi = T(4) * z3i + T(2) * c2.v * y;
      const T den = pr * pr + pi * pi;
      SIM5_SLOTS {
        const T nr = c2.d[j] * z2r + c1.d[j] * x + c0.d[j];
        const T ni = c2.d[j] * z2i + c1.d[j] * y;
        rr[i].d[j] = -(nr * pr + ni * pi) / den;
        ri[i].d[j] = -(ni * pr - nr * pi) / den;
      }
    }
  }
  return nrr;
}

// ---------------------------------------------------------------------------
// elliptic integrals and functions (special/carlson.py, legendre.py,
// jacobi.py)
// ---------------------------------------------------------------------------

// _rf_tail: the 5th-order RF series at the converged triple
template <typename T>
SIM5_HD T rf_tail(T xt, T yt, T zt) {
  const T ave = (xt + yt + zt) / T(3);
  const T dx = (ave - xt) / ave, dy = (ave - yt) / ave, dz = (ave - zt) / ave;
  const T e2 = dx * dy - dz * dz;
  const T e3 = dx * dy * dz;
  return (T(1) + (T(1.0 / 24.0) * e2 - T(0.1) - T(3.0 / 44.0) * e3) * e2 +
          T(1.0 / 14.0) * e3) /
         Sqrt(ave);
}

// Carlson RF(x, y, z), fixed duplication depth
template <typename T>
SIM5_HD T rf(T x, T y, T z) {
  T xt = ClampMin(x, Prec<T>::rf_floor());
  T yt = ClampMin(y, Prec<T>::rf_floor());
  T zt = z;
  for (int i = 0; i < Prec<T>::kRfDup; ++i) {
    const T sx = Sqrt(xt), sy = Sqrt(yt), sz = Sqrt(zt);
    const T lam = sx * (sy + sz) + sy * sz;
    xt = T(0.25) * (xt + lam);
    yt = T(0.25) * (yt + lam);
    zt = T(0.25) * (zt + lam);
  }
  return rf_tail(xt, yt, zt);
}

// _rd_tail: the RD series tail at the converged triple, xc in the -3/2 slot
template <typename T>
SIM5_HD T rd_tail(T xa, T xb, T xc) {
  const T ave = T(0.2) * (xa + xb + T(3) * xc);
  const T dx = (ave - xa) / ave, dy = (ave - xb) / ave, dz = (ave - xc) / ave;
  const T C1 = T(3.0 / 14.0), C2 = T(1.0 / 6.0), C3 = T(9.0 / 22.0),
          C4 = T(3.0 / 26.0), C5 = T(0.25 * (9.0 / 22.0)),
          C6 = T(1.5 * (3.0 / 26.0));
  const T ea = dx * dy;
  const T eb = dz * dz;
  const T ec = ea - eb;
  const T ed = ea - T(6) * eb;
  const T ee = ed + ec + ec;
  const T tail = T(1) + ed * (-C1 + C5 * ed - C6 * dz * ee) +
                 dz * (C2 * ee + dz * (-C3 * ec + dz * C4 * ea));
  return tail / (ave * Sqrt(ave));
}

// _rd_chain: the duplication chain on (x, y, z), carrying the RD series
// accumulator s_i of each slot i in kSlots (a bit mask), so that RD with v_i
// in the -3/2 slot is 3 s_i + fac tail_i (perm_tail)
template <typename T>
struct Chain {
  T v[3], fac, s[3];
  // RD with the original slot i in the -3/2 slot, from this chain
  SIM5_HD T rd(int i) const {
    const int j = i == 0 ? 1 : 0, k = i == 2 ? 1 : 2;
    return T(3) * s[i] + fac * rd_tail(v[j], v[k], v[i]);
  }
};

template <typename T, int kSlots>
SIM5_HD Chain<T> rd_chain(T x, T y, T z) {
  Chain<T> c;
  c.v[0] = x;
  c.v[1] = y;
  c.v[2] = z;
  c.fac = T(1);
  for (int i = 0; i < 3; ++i) c.s[i] = T(0);
  for (int n = 0; n < Prec<T>::kRfDup; ++n) {
    T sq[3];
    for (int i = 0; i < 3; ++i) sq[i] = Sqrt(c.v[i]);
    const T lam = sq[0] * (sq[1] + sq[2]) + sq[1] * sq[2];
    for (int i = 0; i < 3; ++i)
      if (kSlots & (1 << i)) c.s[i] = c.s[i] + c.fac / (sq[i] * (c.v[i] + lam));
    for (int i = 0; i < 3; ++i) c.v[i] = T(0.25) * (c.v[i] + lam);
    c.fac = T(0.25) * c.fac;
  }
  return c;
}

// RF on duals with a constant z, by the rule of special/carlson.py:
// dRF/dx_i = -RD(., ., x_i) / 6 from one chain; a slot at the zero floor
// has a zero coefficient.  The value is rf's, from the same chain; the
// coefficients once, for every tangent slot.
template <typename T, int K>
SIM5_HD Dual<T, K> rf(Dual<T, K> x, Dual<T, K> y, T z) {
  const T fl = Prec<T>::rf_floor();
  const Chain<T> c = rd_chain<T, 3>(ClampMin(x.v, fl), ClampMin(y.v, fl), z);
  const T cx = x.v < fl ? T(0) : -c.rd(0) / T(6);
  const T cy = y.v < fl ? T(0) : -c.rd(1) / T(6);
  Dual<T, K> r;
  r.v = rf_tail(c.v[0], c.v[1], c.v[2]);
  SIM5_SLOTS r.d[j] = cx * x.d[j] + cy * y.d[j];
  return r;
}

// elliptic_k_mc: K from the complement mc = 1 - m by a fixed-depth AGM
// (on duals: plain forward mode through the short chain, as autodiff)
template <typename S>
SIM5_HD S elliptic_k_mc(S mc) {
  using T = Base<S>;
  S a = T(1);
  S b = Sqrt(ClampMin(mc, T(1e-30)));
  for (int i = 0; i < Prec<T>::kKAgm; ++i) {
    const S an = T(0.5) * (a + b);
    b = Sqrt(a * b);
    a = an;
  }
  return T(1) / (a + b) * T(kPi);   // torch's pi / x is reciprocal(x) * pi
}

// _sncndn_core: (sn, cn, dn)(u | 1 - emc), the AGM frozen at convergence
template <typename T>
SIM5_HD void sncndn(T u, T emc, T& sn_out, T& cn_out, T& dn) {
  constexpr int depth = Prec<T>::kJacobiAgm;
  T em[depth], en[depth];
  T a = T(1), c_sel = T(1);
  bool done = false;
  int l = 0;
  for (int i = 0; i < depth; ++i) {
    const T emc_s = Sqrt(emc);
    const T c = T(0.5) * (a + emc_s);
    const bool newly = Abs(a - emc_s) <= T(1e-8) * a;
    if (!done) {
      c_sel = c;
      l = i;
    }
    const bool stop = done || newly;
    em[i] = a;
    en[i] = emc_s;
    if (!stop) {
      emc = emc_s * a;
      a = c;
    }
    done = stop;
  }
  const T uu = u * c_sel;
  const T sn = Sin(uu), cn = Cos(uu);
  dn = T(1);
  if (sn == T(0)) {
    sn_out = sn;
    cn_out = cn;
    return;
  }
  T aa = cn / sn;
  T cc = c_sel * aa;
  for (int ii = depth - 1; ii >= 0; --ii) {
    if (ii <= l) {
      const T b = em[ii];
      const T aa_n = aa * cc;
      const T cc_n = cc * dn;
      dn = (en[ii] + aa_n) / (b + aa_n);
      aa = cc_n / b;
      cc = cc_n;
    }
  }
  const T amp = T(1) / Sqrt(cc * cc + T(1));
  sn_out = sn >= T(0) ? amp : -amp;
  cn_out = cc * sn_out;
}

// sncndn on duals, by the rule of special/jacobi.py (_sncndn_partials): the
// u-derivatives algebraic in (sn, cn, dn), the m-derivatives through the
// Jacobi epsilon eps(u, m) from two duplication chains (K and E; the
// incomplete F and D at (cn^2, dn^2, 1)) with the quasi-period reduction,
// and the exact endpoint asymptotics within sqrt(eps) of m = 0 and m = 1;
// the six coefficients once, for every tangent slot
template <typename T, int K>
SIM5_HD void sncndn(Dual<T, K> u, Dual<T, K> emc, Dual<T, K>& sn,
                    Dual<T, K>& cn, Dual<T, K>& dn) {
  sncndn(u.v, emc.v, sn.v, cn.v, dn.v);
  const T U = u.v, E_ = emc.v, s = sn.v, c = cn.v, d = dn.v;
  const T m = T(1) - E_;
  const T tiny = Prec<T>::rf_floor();
  const Chain<T> ck = rd_chain<T, 4>(tiny, ClampMin(E_, tiny), T(1));
  const T Kc = rf_tail(ck.v[0], ck.v[1], ck.v[2]);   // K(m)
  const T E = Kc - m * ck.rd(2) / T(3);
  const Chain<T> ci =
      rd_chain<T, 4>(ClampMin(c * c, tiny), ClampMin(d * d, tiny), T(1));
  const T F_inc = rf_tail(ci.v[0], ci.v[1], ci.v[2]);
  const T eps_inc = s * F_inc - m / T(3) * (s * s * s) * ci.rd(2);
  const T n = Floor((U + Kc) / (T(2) * Kc));
  const T sgn = n - T(2) * Floor(n / T(2)) == T(0) ? T(1) : T(-1);
  const T eps_u = T(2) * n * E + sgn * eps_inc;
  const T W = U * E_ - eps_u;
  const T m_s = ClampMin(m, T(1e-30)), emc_s = ClampMin(E_, T(1e-30));
  const T N = W * d + m * s * c;
  const T g_sn = c * N / (T(2) * m_s * emc_s);
  const T g_cn = -s * N / (T(2) * m_s * emc_s);
  const T g_dn = -s * (s * d + c * W) / (T(2) * emc_s);
  // the endpoint asymptotics, m -> 0 and m -> 1
  const T ucd = U * c * d;
  const T a0_sn = -(U - s * c) * c / T(4);
  const T a0_cn = s * (U - s * c) / T(4);
  const T a0_dn = -s * s / T(2);
  const T cn_g = Abs(c) > T(1e-30) ? c : (c >= T(0) ? T(1e-30) : T(-1e-30));
  const T a1_sn = -(s - ucd) / T(4);
  const T a1_cn = s / cn_g * (s - ucd) / T(4);
  const T a1_dn = -s * (s + ucd) / (T(4) * ClampMin(d, T(1e-30)));
  const T th = Sqrt(Prec<T>::eps());
  const bool lo = m < th, hi = E_ < th;
  // d/d emc = -d/dm
  const T e_sn = -(lo ? a0_sn : (hi ? a1_sn : g_sn));
  const T e_cn = -(lo ? a0_cn : (hi ? a1_cn : g_cn));
  const T e_dn = -(lo ? a0_dn : (hi ? a1_dn : g_dn));
  // the u-coefficients once (the products left to right, as the
  // one-tangent form rounds them), then every slot
  const T u_sn = c * d, u_cn = -s * d, u_dn = -m * s * c;
  SIM5_SLOTS {
    sn.d[j] = u_sn * u.d[j] + e_sn * emc.d[j];
    cn.d[j] = u_cn * u.d[j] + e_cn * emc.d[j];
    dn.d[j] = u_dn * u.d[j] + e_dn * emc.d[j];
  }
}

// ---------------------------------------------------------------------------
// the geodesic (geodesic/types.py, geodesic/analytic.py)
// ---------------------------------------------------------------------------

enum : int {
  kTypeRR = 40, kTypeRRDbl = 41, kTypeRRBH = 42, kTypeRC = 2, kTypeCC = 0
};
enum : int {
  kOk = 0, kErrUnknownSolution = 3, kErrRRDouble = 4, kErrQRange = 7,
  kErrMuPlusRange = 8, kErrMu0Range = 9, kErrMMRange = 10,
  kErrInclRange = 11, kErrSpinRange = 12
};

// The counters' slots.  A probe is called by every lane of a warp at the
// same points (in R_roots before its calls, the rest at the end of
// nt_pixel): probe(slot, p) with whether the lane enters a stage, and
// probe.classes(slot, k, n) with the lane's class k of n consecutive
// slots (k < 0: none).  Each stage has one call
// site, which a warp runs once if any of its lanes enters, so the warps
// with at least one such lane are the stage's runs.  The kernel's probe
// counts, per slot, those warps and the lanes; kernel_image.COUNTERS names
// them in this order.
enum Slot : int {
  kSlotPixels,    // the init: every pixel
  kSlotRfR,       // R_roots' rf
  kSlotKR,        // R_roots' K
  kSlotRad0,      // the order-0 inversion (one sncndn)
  kSlotOrder1,    // the order-1 pass (crossing and inversion)
  kSlotShade,     // gfactorK and the flux
  kSlotRad0RR, kSlotRad0RC, kSlotRad0CC,   // order-0 inversions by type
  kSlotRad1RR, kSlotRad1RC, kSlotRad1CC,   // order-1 inversions by type
  kSlotTypeRR, kSlotTypeRRBH, kSlotTypeRRDbl, kSlotTypeRC, kSlotTypeCC,
  kSlotHit0, kSlotHit1, kSlotDark,
  kSlotStatus0, kSlotStatus3, kSlotStatus4, kSlotStatus7, kSlotStatus8,
  kSlotStatus9, kSlotStatus10, kSlotStatus11, kSlotStatus12,
  kSlots
};

// a probe that counts nothing
struct NoProbe {
  SIM5_HD void operator()(int, bool) const {}
  SIM5_HD void classes(int, int, int) const {}
};

// The functions below are templated on the scalar S (T, or Dual<T, K> for
// the tangent kernel), T = Base<S> the type of their constants.

template <typename S>
struct Geod {
  S a, alpha, beta, incl, cos_i, l, q;
  S rr[4], ri[4], rr_lo[4];
  int nrr, gtype, status;
  S m2p, m2m, mm, mK, rp, Rpc, Tpp, Tip;

  SIM5_HD S root_diff(int i, int j) const {
    return (rr[i] - rr[j]) + (rr_lo[i] - rr_lo[j]);
  }
};

// _rc_geometry: A, B, A - B, mm and 1 - mm of the RC branch
template <typename S>
SIM5_HD void rc_geometry(S t1, S t2, S tu, S tv, S& A, S& B, S& AmB, S& mm,
                         S& mmc) {
  using T = Base<S>;
  const S x1 = t1 - tu, x2 = t2 - tu;
  A = Sqrt(x1 * x1 + tv * tv);
  B = Sqrt(x2 * x2 + tv * tv);
  const S tv2 = tv * tv;
  const S hm1 = x1 > T(0) ? tv2 / (A + x1) : A - x1;
  const S hp1 = x1 < T(0) ? tv2 / (A - x1) : A + x1;
  const S hm2 = x2 > T(0) ? tv2 / (B + x2) : B - x2;
  const S hp2 = x2 < T(0) ? tv2 / (B - x2) : B + x2;
  const S ApB = A + B, d = t1 - t2;
  AmB = d * (x1 + x2) / ApB;
  mm = Clamp((ApB * ApB - d * d) / (T(4) * A * B), T(0), T(1));
  mmc = Clamp(d * d * (hm1 + hm2) * (hp1 + hp2) / (T(4) * A * B * (ApB * ApB)),
              Prec<T>::tiny(), T(1));
}

// _cc_map: the CC map's parameters from the two complex pairs
template <typename S>
struct CCMap {
  S b1, a1, A, B, mmc, g1, mm;
};

template <typename S>
SIM5_HD CCMap<S> cc_map(const Geod<S>& g) {
  using T = Base<S>;
  CCMap<S> c;
  c.b1 = g.rr[0];
  c.a1 = Abs(g.ri[0]);
  const S b2 = g.rr[2], a2 = Abs(g.ri[2]);
  const S db = c.b1 - b2, sp = c.a1 + a2, sm = c.a1 - a2;
  c.A = Sqrt(db * db + sp * sp);
  c.B = Sqrt(db * db + sm * sm);
  const S ApB = c.A + c.B;
  const S AmB = T(4) * c.a1 * a2 / ApB;
  const S ratio = AmB / ApB;
  c.mmc = Clamp(ratio * ratio, Prec<T>::tiny(), T(1));
  const S g1num = ClampMin(T(4) * c.a1 * c.a1 - AmB * AmB, T(1e-30));
  const S g1den = ClampMin(ApB * ApB - T(4) * c.a1 * c.a1, T(1e-30));
  c.g1 = Sqrt(g1num / g1den);
  c.mm = T(4) * c.A * c.B / (ApB * ApB);
  return c;
}

// _R_roots: radial roots, type, periastron rp and Rpc for an observer at r0.
// Each lane selects the arguments of its one rf and its one K by type (a
// type that needs neither keeps the dummies, rf(1, 1, 1) and K(1)), the two
// calls sit outside the type branches, entered by the lanes that need them,
// and the per-type combination follows: a warp that holds several types
// runs each chain once.  `probe` counts the lanes that enter each call, at
// the point where they are chosen: a flag carried to the end of the pixel
// would hold registers through the whole chain.
template <typename S, typename Probe>
SIM5_HD void R_roots(Geod<S>& g, Base<S> r0, Probe& probe) {
  using T = Base<S>;
  const S a = g.a, l = g.l, q = g.q;
  const S a2 = a * a;
  const S c2 = a2 - l * l - q;
  const S lma = l - a;
  const S c1 = T(2) * (q + lma * lma);
  const S c0 = -a2 * q;
  g.nrr = radial_roots(c2, c1, c0, g.rr, g.ri, g.rr_lo);

  const S r1 = g.rr[0], r2 = g.rr[1], r3 = g.rr[2];
  g.status = kOk;
  // rf(x, y, 1) and K(kmc); the combination Rpc of the two results uses
  // the scalars u and v and, for RC, the sign of z
  S x = T(1), y = T(1), kmc = T(1), u = T(0), v = T(0);
  bool need_rf = false, need_k = false, z_pos = true;
  if (g.nrr == 4) {
    const bool dbl = Abs(r1 - r2) < T(1e-8);
    const bool inner = r0 >= r3 && r0 <= r2;
    const bool bad4 = r0 < r3 || (r0 > r2 && r0 < r1);
    g.gtype = dbl ? kTypeRRDbl : (inner ? kTypeRRBH : kTypeRR);
    g.status = bad4 ? kErrUnknownSolution : (dbl ? kErrRRDouble : kOk);
    const S d12 = g.root_diff(0, 1), d13 = g.root_diff(0, 2);
    const S d14 = g.root_diff(0, 3), d24 = g.root_diff(1, 3);
    const S d34 = g.root_diff(2, 3);
    const S c4 = T(2) / Sqrt(d13 * d24);
    if (inner) {
      g.rp = r2;
      kmc = d12 * d34 / (d24 * d13);
      need_k = true;
      u = c4;                            // Rpc = c4 K
    } else {
      const S z4 = Clamp(Sqrt(d24 / d14), T(0), T(1));
      g.rp = r1;
      x = d12 / d14;
      y = d12 / d13;
      need_rf = true;
      u = c4 * z4;                       // Rpc = c4 z4 rf
    }
  } else if (g.nrr == 2) {
    g.gtype = kTypeRC;
    S A, B, AmB, mm, mmc;
    rc_geometry(r1, r2, g.rr[2], Abs(g.ri[2]), A, B, AmB, mm, mmc);
    const S zr = AmB / (A + B);
    const T feps = T(8.0 * static_cast<double>(Prec<T>::eps()));
    const S az = Clamp(Abs(zr), feps, T(1) - feps);
    x = az * az;
    y = mmc + mm * az * az;
    need_rf = true;
    z_pos = zr >= T(0);
    need_k = !z_pos;
    kmc = mmc;
    u = Sqrt(T(1) - az * az);            // icn1 = u rf
    v = Sqrt(A * B);                     // Rpc = (icn1 or 2K - icn1) / v
    g.rp = r1;
  } else {
    g.gtype = kTypeCC;
    const CCMap<S> c = cc_map(g);
    const S zg = T(1) / c.g1;
    const S w2 = zg * zg / (T(1) + zg * zg);
    const S w2c = T(1) / (T(1) + zg * zg);
    x = w2c;
    y = c.mmc + c.mm * w2c;
    kmc = c.mmc;
    need_rf = need_k = true;
    u = T(2) / (c.A + c.B);              // Rpc = u (2K - v rf)
    v = Sqrt(w2);
    g.rp = c.b1 - c.a1 * c.g1;
  }
  probe(kSlotRfR, need_rf);
  probe(kSlotKR, need_k);
  S rfv = T(1);
  if (need_rf) rfv = rf(x, y, T(1));
  S kv = T(0);
  if (need_k) kv = elliptic_k_mc(kmc);
  if (g.nrr == 4) {
    g.Rpc = u * (need_k ? kv : rfv);
  } else if (g.nrr == 2) {
    const S icn1 = u * rfv;
    g.Rpc = (z_pos ? icn1 : T(2) * kv - icn1) / v;
  } else {
    g.Rpc = u * (T(2) * kv - v * rfv);
  }
}

// _T_roots: theta roots m2p, m2m, modulus mm and scale mK; returns status
template <typename S>
SIM5_HD int T_roots(Geod<S>& g, S m0) {
  using T = Base<S>;
  const S a = g.a, l = g.l, q = g.q;
  const S a2 = a * a;
  const S qla = q + l * l - a2;
  const S S_ = Sqrt(qla * qla + T(4) * q * a2);
  const S denom = S_ - qla;
  const S X = qla >= T(0) ? S_ + qla
                          : T(4) * q * a2 / (denom != T(0) ? denom : S(T(1)));
  g.m2m = X / (T(2) * a2);
  g.m2p = (T(2) * q) / X;
  const double feps_d = 8.0 * static_cast<double>(Prec<T>::eps());
  const T feps = T(feps_d > 1e-12 ? feps_d : 1e-12);
  const bool bad_mp = g.m2p <= T(0) || g.m2p > T(1) + feps;
  const bool qpos = q > T(0), qneg = q < T(0);
  g.mm = qpos ? g.m2p / (g.m2p + g.m2m) : (g.m2p + g.m2m) / g.m2p;
  g.mm = ClampMax(g.mm, T(1) - feps);
  const bool bad_mm = g.mm < T(0) || g.mm >= T(1);
  const S slack = Sqrt(ClampMin(g.m2p, T(0))) * (T(1) + feps);
  bool bad_m0 = Abs(m0) > slack;
  if (!qpos)
    bad_m0 = bad_m0 ||
             Abs(m0) < Sqrt(ClampMin(-g.m2m, T(0))) * (T(1) - feps);
  g.mK = qpos ? T(1) / Sqrt(a2 * (g.m2p + g.m2m))
              : T(1) / Sqrt(a2 * ClampMin(g.m2p, Prec<T>::tiny()));
  return bad_mp ? kErrMuPlusRange
                : bad_mm ? kErrMMRange
                         : bad_m0 ? kErrMu0Range
                                  : (!qpos && !qneg) ? kErrQRange : kOk;
}

// geodesic_init_inf: the geodesic of impact parameters (alpha, beta) for
// an observer at inclination i, with cos_i = Cos(i) and sin_i = Sin(i)
// computed once for the frame
template <typename S, typename Probe>
SIM5_HD Geod<S> init_inf(S i, S cos_i, S sin_i, S a, S alpha, S beta,
                         Probe& probe) {
  using T = Base<S>;
  Geod<S> g;
  const bool bad_spin = a < T(0) || a > T(1.0 - 1e-6);
  const bool bad_incl = i <= T(0) || i >= T(kPi / 2.0);
  beta = beta == T(0) ? S(T(1e-6)) : beta;
  const S a_eff = ClampMin(a, T(1e-4));
  g.a = a_eff;
  g.alpha = alpha;
  g.beta = beta;
  g.incl = i;
  g.cos_i = cos_i;
  g.l = -alpha * sin_i;
  S q = beta * beta + cos_i * cos_i * (alpha * alpha - a_eff * a_eff);
  const bool bad_q = q == T(0);
  g.q = q = bad_q ? S(T(1)) : q;

  R_roots(g, Prec<T>::r_observer(), probe);   // the observer at r0 = 1e300
  const int st_r = g.status;
  const int st_t = T_roots(g, cos_i);
  g.status = bad_spin ? kErrSpinRange
                      : bad_incl ? kErrInclRange
                                 : bad_q ? kErrQRange
                                         : (st_r != 0 ? st_r : st_t);

  // Tpp = 2 mK K(mm), K from the exact theta-root complement of mm
  S mm_c = q > T(0) ? g.m2m / (g.m2p + g.m2m)
                    : -g.m2m / (g.m2p != T(0) ? g.m2p : S(T(1)));
  mm_c = Clamp(mm_c, T(1e-12), T(1));
  g.Tpp = T(2) * g.mK * elliptic_k_mc(mm_c);
  // Tip = mK icn(cos_i/sqrt(m2p), mm), 1 - u^2 cancellation-free
  const S denom = a_eff * a_eff * (g.m2m + cos_i * cos_i) * g.m2p;
  const S bs = beta * sin_i;
  const S eps_ident = denom > T(0) ? bs * bs / denom : S(T(0.5));
  const S eps_direct = (g.m2p - cos_i * cos_i) / g.m2p;
  const S eps = Clamp(eps_direct > T(1e-6) ? eps_direct : eps_ident,
                      Prec<T>::tiny(), T(1));
  S e_sel, y_sel;
  if (q < T(0)) {   // vortical: the dn-form integral in the same slot
    e_sel = Clamp(eps / ClampMin(g.mm, Prec<T>::tiny()), T(0),
                  T(1.0 - 1e-12));
    y_sel = T(1) - g.mm * e_sel;
  } else {
    e_sel = eps;
    y_sel = (T(1) - eps) + eps * mm_c;
  }
  g.Tip = g.mK * Sqrt(e_sel) * rf(T(1) - e_sel, y_sel, T(1));
  return g;
}

// geodesic_find_midplane_crossing: P of the order-th equatorial crossing
template <typename S>
SIM5_HD S find_midplane_crossing(const Geod<S>& g, int order) {
  using T = Base<S>;
  const S u = g.cos_i / Sqrt(g.m2p);
  const bool u_ok = Abs(u) <= T(1.0 + 1e-4);
  S pos = T((2.0 * order + 1.0) * 0.5) * g.Tpp +
          (g.beta > T(0) ? g.Tip : (g.beta < T(0) ? -g.Tip : S(T(0))));
  if (pos > T(2) * g.Rpc) pos = Nan<T>();
  if (g.q <= T(0) || !u_ok || g.status != kOk) pos = Nan<T>();
  return pos;
}

// geodesic_position_rad: r(P), NaN outside the valid range.  Each lane
// selects the argument u and parameter of its one sncndn by type, makes
// the one call, then applies its type's formula to (sn, cn) and the three
// scalars p0-p2 its branch kept.
template <typename S>
SIM5_HD S position_rad(const Geod<S>& g, S P) {
  using T = Base<S>;
  const bool is_rr = g.gtype == kTypeRR, is_bh = g.gtype == kTypeRRBH;
  const bool is_rc = g.gtype == kTypeRC, is_cc = g.gtype == kTypeCC;
  const bool finite = IsFinite(P);
  const S Pz = finite ? P : T(0.5) * g.Rpc;
  const S Pf = is_bh ? Pz - T(2) * g.Rpc * Floor(Pz / (T(2) * g.Rpc)) : Pz;
  const bool P_valid = finite && Pf > T(0) && Pf < T(2) * g.Rpc;
  const S Ps = P_valid ? Pf : T(0.5) * g.Rpc;
  S u = T(0), m = T(1), p0 = T(0), p1 = T(0), p2 = T(0);
  if (is_rr || is_bh) {
    const S d12 = g.root_diff(0, 1), d13 = g.root_diff(0, 2);
    const S d23 = g.root_diff(1, 2), d24 = g.root_diff(1, 3);
    const S d34 = g.root_diff(2, 3);
    const S m4c = Clamp(d12 * d34 / (d24 * d13), Prec<T>::tiny(), T(1));
    u = T(0.5) * Abs(Ps - g.Rpc) * Sqrt(d13 * d24);
    m = m4c <= T(0) ? S(T(1e-9)) : m4c;
    p0 = is_rr ? d12 : d23;
    p1 = is_rr ? d24 : d13;
  } else if (is_rc) {
    S A, B, AmB, m2, m2c;
    rc_geometry(g.rr[0], g.rr[1], g.rr[2], Abs(g.ri[2]), A, B, AmB, m2, m2c);
    const S Ps_rc = (P_valid && Pf < g.Rpc) ? Ps : T(0.5) * g.Rpc;
    u = Sqrt(A * B) * (g.Rpc - Ps_rc);
    m = m2c <= T(0) ? S(T(1e-9)) : m2c;
    p0 = A;
    p1 = B;
    p2 = AmB;
  } else if (is_cc) {
    const CCMap<S> c = cc_map(g);
    const S Ps_cc = (P_valid && Pf <= g.Rpc) ? Ps : T(0.5) * g.Rpc;
    u = T(0.5) * (c.A + c.B) * (g.Rpc - Ps_cc);
    m = c.mmc <= T(0) ? S(T(1e-9)) : c.mmc;
    p0 = c.a1;
    p1 = c.b1;
    p2 = c.g1;
  }
  S sn = T(0), cn = T(1), dn = T(1);
  if (is_rr || is_bh || is_rc || is_cc) sncndn(u, m, sn, cn, dn);
  S r = Nan<T>();
  if (is_rr) {
    // r = r2 + d12 d24 / (d24 cn^2 - d12 sn^2), no cancellation in r - r2
    const S sn2 = sn * sn;
    const S D = p1 * (cn * cn) - p0 * sn2;
    r = g.rr[1] + p0 * p1 / (D != T(0) ? D : S(Prec<T>::tiny()));
  } else if (is_bh) {
    const S w = sn * sn * p0 / p1;
    r = (g.rr[1] - w * g.rr[0]) / (T(1) - w);
  } else if (is_rc) {
    const S t1 = g.rr[0], t2 = g.rr[1];
    r = (t2 * p0 - t1 * p1 - (t2 * p0 + t1 * p1) * cn) /
        (p2 - (p0 + p1) * cn);
    if (Pf > g.Rpc) r = Nan<T>();   // no turning point
  } else if (is_cc) {
    const S cs = Abs(cn) > T(1e-30) ? cn
                                    : S(cn >= T(0) ? T(1e-30) : T(-1e-30));
    const S z = sn / cs;
    r = (z * (p0 + p1 * p2) + p1 - p0 * p2) / (T(1) + p2 * z);
    if (Pf > g.Rpc) r = Nan<T>();   // no turning point
  }
  if (Pf <= T(0) || Pf >= T(2) * g.Rpc || !finite) r = Nan<T>();
  if (Pf == g.Rpc) r = g.rp;
  return r;
}

// ---------------------------------------------------------------------------
// Keplerian disk (core/orbits.py, disk/nt.py)
// ---------------------------------------------------------------------------

// gfactorK: redshift of Keplerian equatorial emission toward a photon of
// motion constant l, with the compensated Keplerian bracket
template <typename S>
SIM5_HD S gfactorK(S r, S a, S l) {
  using T = Base<S>;
  const S s = Sqrt(r);
  S p, ep, u, eu, m3, em3, v, ev, w, ew;
  two_prod(s, s, p, ep);
  const S s_safe = ClampMin(s, Prec<T>::tiny());
  const S s_l = ((r - p) - ep) / (T(2) * s_safe);
  two_prod(p, s, u, eu);
  two_sum(T(2) * s, s, m3, em3);
  two_sum(u, -m3, v, ev);
  two_sum(v, T(2) * a, w, ew);
  const S kep =
      w + (((ew + ev) - em3) + (eu + ep * s) + (T(3) * p - T(3)) * s_l);
  const S s3 = s * r;
  return Sqrt(ClampMin(s3 * kep, T(0))) / (s3 + a - l);
}

// ---------------------------------------------------------------------------
// the disk image (render/image.py:render_disk_image_reference), one pixel
// ---------------------------------------------------------------------------

// A frame's constants: its six scalars, what the pixels derive from them
// alone (cos i, sin i, the reference's r_ms), and nt_flux's per-disk
// constants (the partial-fraction weights c1-c3, x0 = sqrt(rms) as
// x0h + x0l, x0 - x_i, the linear coefficient C1).  make_frame computes
// it once; every pixel of the frame reads it.
template <typename S>
struct Frame {
  S a, incl, cos_i, sin_i, M, mdot, rms_disk, rms, rmax;
  S x0h, x0l, x0mx1, x0mx2, x0mx3, c1, c2, c3, C1;
};

// the frame of the six scalars s = (a, incl, M, mdot, rms_disk, rmax),
// rms_disk being the disk's edge, ISCO + 1e-3
template <typename S>
SIM5_HD Frame<S> make_frame(const S* s) {
  using T = Base<S>;
  Frame<S> d;
  d.a = s[0];
  d.incl = s[1];
  d.M = s[2];
  d.mdot = s[3];
  d.rms_disk = s[4];
  d.rmax = s[5];
  d.cos_i = Cos(d.incl);
  d.sin_i = Sin(d.incl);
  // the reference compares against r_ms(a), not rms + 1e-3
  d.rms = d.rms_disk - T(1e-3);
  const S a = d.a, rms = d.rms_disk;
  const S th = Acos(Clamp(a, T(-1), T(1))) / T(3);
  const S x1 = T(2) * Cos(th - T(kPi / 3.0));
  const S x2 = T(2) * Cos(th + T(kPi / 3.0));
  const S x3 = T(-2) * Cos(th);
  const T s3 = T(kSqrt3);
  const S sth = Sin(th), s2th = Sin(T(2) * th), cth = Cos(th);
  const S d12x = T(2.0 * kSqrt3) * sth;
  const S d13x = T(3) * cth + s3 * sth;
  const S d23x = T(3) * cth - s3 * sth;
  const S x1ma = sth * (s3 + T(2) * s2th);
  const S x3ma = x3 - a;
  const S x2ma =
      a * (T(1) - a) * (T(1) + a) / ((x1ma == T(0) ? S(T(1)) : x1ma) * x3ma);
  const S x2s = x2 == T(0) ? S(Prec<T>::guard_1e300()) : x2;
  d.c1 = T(3) * (x1ma * x1ma) / (x1 * d12x * d13x);
  d.c2 = T(-3) * (x2ma * x2ma) / (x2s * d12x * d23x);
  d.c3 = T(3) * (x3ma * x3ma) / (x3 * (x3 - x1) * (x3 - x2));
  sqrt_df(rms, d.x0h, d.x0l);
  const S x0 = d.x0h;
  const S rms1 = rms - T(1);
  d.x0mx1 = (rms1 - T(2) * sth * sth - s3 * s2th) / (x0 + x1);
  d.x0mx2 = (rms1 - T(2) * sth * sth + s3 * s2th) / (x0 + x2);
  d.x0mx3 = x0 + T(2) * cth;
  d.C1 = T(1) - T(1.5) * a / x0 - d.c1 / d.x0mx1 - d.c2 / d.x0mx2 -
         d.c3 / d.x0mx3;
  return d;
}

// nt_flux(disk, r) [erg cm-2 s-1], in the delta form, from the frame's
// constants
template <typename S>
SIM5_HD S nt_flux(const Frame<S>& d, S r) {
  using T = Base<S>;
  const S rms = d.rms_disk;
  const bool inside = r <= rms;
  const S rs = inside ? rms * T(1.0001) : r;
  S xh, xl;
  sqrt_df(rs, xh, xl);
  const S x0 = d.x0h;
  const S delta = (xh - d.x0h) + (xl - d.x0l);
  const S B = delta * d.C1 + T(1.5) * d.a * vlog(delta / x0) +
              d.c1 * vlog(delta / d.x0mx1) + d.c2 * vlog(delta / d.x0mx2) +
              d.c3 * vlog(delta / d.x0mx3);
  const S F = T(1) / (T(4.0 * kPi) * rs) * T(1.5) /
              (xh * xh *
               ((d.x0mx1 + delta) * (d.x0mx2 + delta) * (d.x0mx3 + delta))) *
              B;
  const S out = T(9.1721376255e+28) * F * d.mdot / d.M;
  return inside ? S(T(0)) : out;
}

// x as a scalar of the shading: x itself where the chain and the shading
// share their scalar; else x's slots, then zero slots (a direction that
// enters the shading only, which the chain does not carry)
template <typename S>
SIM5_HD S widen(const S& x, const S*) {
  return x;
}
template <typename T, int K, int KW,
          typename = typename std::enable_if<(K < KW)>::type>
SIM5_HD Dual<T, KW> widen(const Dual<T, K>& x, const Dual<T, KW>*) {
  Dual<T, KW> w(x.v);
#pragma unroll
  for (int j = 0; j < K; ++j) w.d[j] = x.d[j];
  return w;
}

// One pixel (ix, iy) of an nx x ny frame with aspect ny / nx: image_f =
// F g^4 and image_g = g, 0 where the ray misses the disk.  The reference
// control flow (disk-image.c:73-104): no order-0 crossing leaves the pixel
// dark; order 1 only where order 0 fell inside the ISCO; the hit, of
// either order, is shaded once.  Every lane runs the probes in the same
// order whatever its path.  The geodesic runs on S from the frame d; the
// shading (gfactorK, nt_flux) on W from the frame dw, the same frame on
// a scalar with the slots of S and more after them: directions that move
// only the flux constants (the disk's rms) need no slot in the chain.
template <typename S, typename W, typename Probe>
SIM5_HD void nt_pixel(const Frame<S>& d, const Frame<W>& dw, int ix, int iy,
                      int nx, int ny, Base<S> aspect, Probe& probe,
                      W& f_out, W& g_out) {
  using T = Base<S>;
  const W* wide = nullptr;
  // image_grid: pixel centres, [0, 0] at the image centre
  const T fx = (T(ix) + T(0.5)) / T(nx) - T(0.5);
  const T fy = (T(iy) + T(0.5)) / T(ny) - T(0.5);
  const S alpha = fx * T(2) * d.rmax;
  const S beta = fy * T(2) * d.rmax * aspect;
  const Geod<S> g =
      init_inf(d.incl, d.cos_i, d.sin_i, d.a, alpha, beta, probe);
  const bool ok = g.status == kOk;

  const S P0 = find_midplane_crossing(g, 0);
  const bool has0 = IsFinite(P0);
  S r = Nan<T>();
  if (has0) r = position_rad(g, P0);
  const bool hit0 = IsFinite(r) && r >= d.rms && ok;
  const bool use1 = has0 && !hit0;
  if (use1) r = position_rad(g, find_midplane_crossing(g, 1));
  const bool hit1 = use1 && IsFinite(r) && r >= d.rms && ok;
  const bool hit = hit0 || hit1;
  W f = T(0), gf = T(0);
  if (hit) {
    const W rw = widen(r, wide);
    gf = gfactorK(rw, dw.a, widen(g.l, wide));
    const W g2 = gf * gf;
    f = nt_flux(dw, rw) * (g2 * g2);
  }
  f_out = f;
  g_out = gf;

  // the counters, once the pixel is done (R_roots counts its two calls)
  probe(kSlotPixels, true);
  probe(kSlotRad0, has0);
  probe(kSlotOrder1, use1);
  probe(kSlotShade, hit);
  // the inversion's type: RR (or RR_BH), RC, CC, or none (RR double)
  const bool is_rc = g.gtype == kTypeRC, is_cc = g.gtype == kTypeCC;
  const int inv = g.gtype == kTypeRR || g.gtype == kTypeRRBH ? 0
                  : is_rc                                     ? 1
                  : is_cc                                     ? 2
                                                              : -1;
  probe.classes(kSlotRad0RR, has0 ? inv : -1, 3);
  probe.classes(kSlotRad1RR, use1 ? inv : -1, 3);
  const int type = g.gtype == kTypeRR      ? 0
                   : g.gtype == kTypeRRBH  ? 1
                   : g.gtype == kTypeRRDbl ? 2
                   : is_rc                 ? 3
                   : is_cc                 ? 4
                                           : -1;
  probe.classes(kSlotTypeRR, type, 5);
  probe.classes(kSlotHit0, hit0 ? 0 : hit1 ? 1 : 2, 3);
  // the error codes, rare, apart from kOk
  const int codes[8] = {kErrUnknownSolution, kErrRRDouble, kErrQRange,
                        kErrMuPlusRange, kErrMu0Range, kErrMMRange,
                        kErrInclRange, kErrSpinRange};
  int err = -1;
  for (int k = 0; k < 8; ++k) err = g.status == codes[k] ? k : err;
  probe(kSlotStatus0, ok);
  probe.classes(kSlotStatus3, err, 8);
}

// the pixel with the chain and the shading on one scalar and one frame
template <typename S, typename Probe>
SIM5_HD void nt_pixel(const Frame<S>& d, int ix, int iy, int nx, int ny,
                      Base<S> aspect, Probe& probe, S& f_out, S& g_out) {
  nt_pixel(d, d, ix, iy, nx, ny, aspect, probe, f_out, g_out);
}

}  // namespace sim5
