// The analytic geodesic engine of one ray, for one thread: the device
// functions that the disk image kernel (disk_image.cu) runs per pixel, and
// that a fused volume-seed kernel can reuse.
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
  if (std::is_same<T, float>::value) {
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

// ---------------------------------------------------------------------------
// elliptic integrals and functions (special/carlson.py, legendre.py,
// jacobi.py)
// ---------------------------------------------------------------------------

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
  const T ave = (xt + yt + zt) / T(3);
  const T dx = (ave - xt) / ave, dy = (ave - yt) / ave, dz = (ave - zt) / ave;
  const T e2 = dx * dy - dz * dz;
  const T e3 = dx * dy * dz;
  return (T(1) + (T(1.0 / 24.0) * e2 - T(0.1) - T(3.0 / 44.0) * e3) * e2 +
          T(1.0 / 14.0) * e3) /
         Sqrt(ave);
}

// elliptic_k_mc: K from the complement mc = 1 - m by a fixed-depth AGM
template <typename T>
SIM5_HD T elliptic_k_mc(T mc) {
  T a = T(1);
  T b = Sqrt(ClampMin(mc, T(1e-30)));
  for (int i = 0; i < Prec<T>::kKAgm; ++i) {
    const T an = T(0.5) * (a + b);
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

template <typename T>
struct Geod {
  T a, alpha, beta, incl, cos_i, l, q;
  T rr[4], ri[4], rr_lo[4];
  int nrr, gtype, status;
  T m2p, m2m, mm, mK, rp, Rpc, Tpp, Tip;

  SIM5_HD T root_diff(int i, int j) const {
    return (rr[i] - rr[j]) + (rr_lo[i] - rr_lo[j]);
  }
};

// _rc_geometry: A, B, A - B, mm and 1 - mm of the RC branch
template <typename T>
SIM5_HD void rc_geometry(T t1, T t2, T tu, T tv, T& A, T& B, T& AmB, T& mm,
                         T& mmc) {
  const T x1 = t1 - tu, x2 = t2 - tu;
  A = Sqrt(x1 * x1 + tv * tv);
  B = Sqrt(x2 * x2 + tv * tv);
  const T tv2 = tv * tv;
  const T hm1 = x1 > T(0) ? tv2 / (A + x1) : A - x1;
  const T hp1 = x1 < T(0) ? tv2 / (A - x1) : A + x1;
  const T hm2 = x2 > T(0) ? tv2 / (B + x2) : B - x2;
  const T hp2 = x2 < T(0) ? tv2 / (B - x2) : B + x2;
  const T ApB = A + B, d = t1 - t2;
  AmB = d * (x1 + x2) / ApB;
  mm = Clamp((ApB * ApB - d * d) / (T(4) * A * B), T(0), T(1));
  mmc = Clamp(d * d * (hm1 + hm2) * (hp1 + hp2) / (T(4) * A * B * (ApB * ApB)),
              Prec<T>::tiny(), T(1));
}

// _cc_map: the CC map's parameters from the two complex pairs
template <typename T>
struct CCMap {
  T b1, a1, A, B, mmc, g1, mm;
};

template <typename T>
SIM5_HD CCMap<T> cc_map(const Geod<T>& g) {
  CCMap<T> c;
  c.b1 = g.rr[0];
  c.a1 = Abs(g.ri[0]);
  const T b2 = g.rr[2], a2 = Abs(g.ri[2]);
  const T db = c.b1 - b2, sp = c.a1 + a2, sm = c.a1 - a2;
  c.A = Sqrt(db * db + sp * sp);
  c.B = Sqrt(db * db + sm * sm);
  const T ApB = c.A + c.B;
  const T AmB = T(4) * c.a1 * a2 / ApB;
  const T ratio = AmB / ApB;
  c.mmc = Clamp(ratio * ratio, Prec<T>::tiny(), T(1));
  const T g1num = ClampMin(T(4) * c.a1 * c.a1 - AmB * AmB, T(1e-30));
  const T g1den = ClampMin(ApB * ApB - T(4) * c.a1 * c.a1, T(1e-30));
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
template <typename T, typename Probe>
SIM5_HD void R_roots(Geod<T>& g, T r0, Probe& probe) {
  const T a = g.a, l = g.l, q = g.q;
  const T a2 = a * a;
  const T c2 = a2 - l * l - q;
  const T lma = l - a;
  const T c1 = T(2) * (q + lma * lma);
  const T c0 = -a2 * q;
  quartic_roots(T(0), c2, c1, c0, g.rr, g.ri);
  g.nrr = sort_quartic_roots(g.rr, g.ri);
  for (int j = 0; j < 4; ++j)
    polish_root_df(g.rr[j], g.ri[j], c2, c1, c0, g.rr[j], g.rr_lo[j]);

  const T r1 = g.rr[0], r2 = g.rr[1], r3 = g.rr[2];
  g.status = kOk;
  // rf(x, y, 1) and K(kmc); the combination Rpc of the two results uses
  // the scalars u and v and, for RC, the sign of z
  T x = T(1), y = T(1), kmc = T(1), u = T(0), v = T(0);
  bool need_rf = false, need_k = false, z_pos = true;
  if (g.nrr == 4) {
    const bool dbl = Abs(r1 - r2) < T(1e-8);
    const bool inner = r0 >= r3 && r0 <= r2;
    const bool bad4 = r0 < r3 || (r0 > r2 && r0 < r1);
    g.gtype = dbl ? kTypeRRDbl : (inner ? kTypeRRBH : kTypeRR);
    g.status = bad4 ? kErrUnknownSolution : (dbl ? kErrRRDouble : kOk);
    const T d12 = g.root_diff(0, 1), d13 = g.root_diff(0, 2);
    const T d14 = g.root_diff(0, 3), d24 = g.root_diff(1, 3);
    const T d34 = g.root_diff(2, 3);
    const T c4 = T(2) / Sqrt(d13 * d24);
    if (inner) {
      g.rp = r2;
      kmc = d12 * d34 / (d24 * d13);
      need_k = true;
      u = c4;                            // Rpc = c4 K
    } else {
      const T z4 = Clamp(Sqrt(d24 / d14), T(0), T(1));
      g.rp = r1;
      x = d12 / d14;
      y = d12 / d13;
      need_rf = true;
      u = c4 * z4;                       // Rpc = c4 z4 rf
    }
  } else if (g.nrr == 2) {
    g.gtype = kTypeRC;
    T A, B, AmB, mm, mmc;
    rc_geometry(r1, r2, g.rr[2], Abs(g.ri[2]), A, B, AmB, mm, mmc);
    const T zr = AmB / (A + B);
    const T feps = T(8.0 * static_cast<double>(Prec<T>::eps()));
    const T az = Clamp(Abs(zr), feps, T(1) - feps);
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
    const CCMap<T> c = cc_map(g);
    const T zg = T(1) / c.g1;
    const T w2 = zg * zg / (T(1) + zg * zg);
    const T w2c = T(1) / (T(1) + zg * zg);
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
  T rfv = T(1);
  if (need_rf) rfv = rf(x, y, T(1));
  T kv = T(0);
  if (need_k) kv = elliptic_k_mc(kmc);
  if (g.nrr == 4) {
    g.Rpc = u * (need_k ? kv : rfv);
  } else if (g.nrr == 2) {
    const T icn1 = u * rfv;
    g.Rpc = (z_pos ? icn1 : T(2) * kv - icn1) / v;
  } else {
    g.Rpc = u * (T(2) * kv - v * rfv);
  }
}

// _T_roots: theta roots m2p, m2m, modulus mm and scale mK; returns status
template <typename T>
SIM5_HD int T_roots(Geod<T>& g, T m0) {
  const T a = g.a, l = g.l, q = g.q;
  const T a2 = a * a;
  const T qla = q + l * l - a2;
  const T S = Sqrt(qla * qla + T(4) * q * a2);
  const T denom = S - qla;
  const T X = qla >= T(0) ? S + qla
                          : T(4) * q * a2 / (denom != T(0) ? denom : T(1));
  g.m2m = X / (T(2) * a2);
  g.m2p = (T(2) * q) / X;
  const double feps_d = 8.0 * static_cast<double>(Prec<T>::eps());
  const T feps = T(feps_d > 1e-12 ? feps_d : 1e-12);
  const bool bad_mp = g.m2p <= T(0) || g.m2p > T(1) + feps;
  const bool qpos = q > T(0), qneg = q < T(0);
  g.mm = qpos ? g.m2p / (g.m2p + g.m2m) : (g.m2p + g.m2m) / g.m2p;
  g.mm = ClampMax(g.mm, T(1) - feps);
  const bool bad_mm = g.mm < T(0) || g.mm >= T(1);
  const T slack = Sqrt(ClampMin(g.m2p, T(0))) * (T(1) + feps);
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
template <typename T, typename Probe>
SIM5_HD Geod<T> init_inf(T i, T cos_i, T sin_i, T a, T alpha, T beta,
                         Probe& probe) {
  Geod<T> g;
  const bool bad_spin = a < T(0) || a > T(1.0 - 1e-6);
  const bool bad_incl = i <= T(0) || i >= T(kPi / 2.0);
  beta = beta == T(0) ? T(1e-6) : beta;
  const T a_eff = ClampMin(a, T(1e-4));
  g.a = a_eff;
  g.alpha = alpha;
  g.beta = beta;
  g.incl = i;
  g.cos_i = cos_i;
  g.l = -alpha * sin_i;
  T q = beta * beta + cos_i * cos_i * (alpha * alpha - a_eff * a_eff);
  const bool bad_q = q == T(0);
  g.q = q = bad_q ? T(1) : q;

  R_roots(g, Prec<T>::r_observer(), probe);   // the observer at r0 = 1e300
  const int st_r = g.status;
  const int st_t = T_roots(g, cos_i);
  g.status = bad_spin ? kErrSpinRange
                      : bad_incl ? kErrInclRange
                                 : bad_q ? kErrQRange
                                         : (st_r != 0 ? st_r : st_t);

  // Tpp = 2 mK K(mm), K from the exact theta-root complement of mm
  T mm_c = q > T(0) ? g.m2m / (g.m2p + g.m2m)
                    : -g.m2m / (g.m2p != T(0) ? g.m2p : T(1));
  mm_c = Clamp(mm_c, T(1e-12), T(1));
  g.Tpp = T(2) * g.mK * elliptic_k_mc(mm_c);
  // Tip = mK icn(cos_i/sqrt(m2p), mm), 1 - u^2 cancellation-free
  const T denom = a_eff * a_eff * (g.m2m + cos_i * cos_i) * g.m2p;
  const T bs = beta * sin_i;
  const T eps_ident = denom > T(0) ? bs * bs / denom : T(0.5);
  const T eps_direct = (g.m2p - cos_i * cos_i) / g.m2p;
  const T eps = Clamp(eps_direct > T(1e-6) ? eps_direct : eps_ident,
                      Prec<T>::tiny(), T(1));
  T e_sel, y_sel;
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
template <typename T>
SIM5_HD T find_midplane_crossing(const Geod<T>& g, int order) {
  const T u = g.cos_i / Sqrt(g.m2p);
  const bool u_ok = Abs(u) <= T(1.0 + 1e-4);
  T pos = T((2.0 * order + 1.0) * 0.5) * g.Tpp +
          (g.beta > T(0) ? g.Tip : (g.beta < T(0) ? -g.Tip : T(0)));
  if (pos > T(2) * g.Rpc) pos = Nan<T>();
  if (g.q <= T(0) || !u_ok || g.status != kOk) pos = Nan<T>();
  return pos;
}

// geodesic_position_rad: r(P), NaN outside the valid range.  Each lane
// selects the argument u and parameter of its one sncndn by type, makes
// the one call, then applies its type's formula to (sn, cn) and the three
// scalars p0-p2 its branch kept.
template <typename T>
SIM5_HD T position_rad(const Geod<T>& g, T P) {
  const bool is_rr = g.gtype == kTypeRR, is_bh = g.gtype == kTypeRRBH;
  const bool is_rc = g.gtype == kTypeRC, is_cc = g.gtype == kTypeCC;
  const bool finite = IsFinite(P);
  const T Pz = finite ? P : T(0.5) * g.Rpc;
  const T Pf = is_bh ? Pz - T(2) * g.Rpc * Floor(Pz / (T(2) * g.Rpc)) : Pz;
  const bool P_valid = finite && Pf > T(0) && Pf < T(2) * g.Rpc;
  const T Ps = P_valid ? Pf : T(0.5) * g.Rpc;
  T u = T(0), m = T(1), p0 = T(0), p1 = T(0), p2 = T(0);
  if (is_rr || is_bh) {
    const T d12 = g.root_diff(0, 1), d13 = g.root_diff(0, 2);
    const T d23 = g.root_diff(1, 2), d24 = g.root_diff(1, 3);
    const T d34 = g.root_diff(2, 3);
    const T m4c = Clamp(d12 * d34 / (d24 * d13), Prec<T>::tiny(), T(1));
    u = T(0.5) * Abs(Ps - g.Rpc) * Sqrt(d13 * d24);
    m = m4c <= T(0) ? T(1e-9) : m4c;
    p0 = is_rr ? d12 : d23;
    p1 = is_rr ? d24 : d13;
  } else if (is_rc) {
    T A, B, AmB, m2, m2c;
    rc_geometry(g.rr[0], g.rr[1], g.rr[2], Abs(g.ri[2]), A, B, AmB, m2, m2c);
    const T Ps_rc = (P_valid && Pf < g.Rpc) ? Ps : T(0.5) * g.Rpc;
    u = Sqrt(A * B) * (g.Rpc - Ps_rc);
    m = m2c <= T(0) ? T(1e-9) : m2c;
    p0 = A;
    p1 = B;
    p2 = AmB;
  } else if (is_cc) {
    const CCMap<T> c = cc_map(g);
    const T Ps_cc = (P_valid && Pf <= g.Rpc) ? Ps : T(0.5) * g.Rpc;
    u = T(0.5) * (c.A + c.B) * (g.Rpc - Ps_cc);
    m = c.mmc <= T(0) ? T(1e-9) : c.mmc;
    p0 = c.a1;
    p1 = c.b1;
    p2 = c.g1;
  }
  T sn = T(0), cn = T(1), dn = T(1);
  if (is_rr || is_bh || is_rc || is_cc) sncndn(u, m, sn, cn, dn);
  T r = Nan<T>();
  if (is_rr) {
    // r = r2 + d12 d24 / (d24 cn^2 - d12 sn^2), no cancellation in r - r2
    const T sn2 = sn * sn;
    const T D = p1 * (cn * cn) - p0 * sn2;
    r = g.rr[1] + p0 * p1 / (D != T(0) ? D : Prec<T>::tiny());
  } else if (is_bh) {
    const T w = sn * sn * p0 / p1;
    r = (g.rr[1] - w * g.rr[0]) / (T(1) - w);
  } else if (is_rc) {
    const T t1 = g.rr[0], t2 = g.rr[1];
    r = (t2 * p0 - t1 * p1 - (t2 * p0 + t1 * p1) * cn) /
        (p2 - (p0 + p1) * cn);
    if (Pf > g.Rpc) r = Nan<T>();   // no turning point
  } else if (is_cc) {
    const T cs = Abs(cn) > T(1e-30) ? cn : (cn >= T(0) ? T(1e-30) : T(-1e-30));
    const T z = sn / cs;
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
template <typename T>
SIM5_HD T gfactorK(T r, T a, T l) {
  const T s = Sqrt(r);
  T p, ep, u, eu, m3, em3, v, ev, w, ew;
  two_prod(s, s, p, ep);
  const T s_safe = ClampMin(s, Prec<T>::tiny());
  const T s_l = ((r - p) - ep) / (T(2) * s_safe);
  two_prod(p, s, u, eu);
  two_sum(T(2) * s, s, m3, em3);
  two_sum(u, -m3, v, ev);
  two_sum(v, T(2) * a, w, ew);
  const T kep =
      w + (((ew + ev) - em3) + (eu + ep * s) + (T(3) * p - T(3)) * s_l);
  const T s3 = s * r;
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
template <typename T>
struct Frame {
  T a, incl, cos_i, sin_i, M, mdot, rms_disk, rms, rmax;
  T x0h, x0l, x0mx1, x0mx2, x0mx3, c1, c2, c3, C1;
};

// the frame of the six scalars s = (a, incl, M, mdot, rms_disk, rmax),
// rms_disk being the disk's edge, ISCO + 1e-3
template <typename T>
SIM5_HD Frame<T> make_frame(const T* s) {
  Frame<T> d;
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
  const T a = d.a, rms = d.rms_disk;
  const T th = Acos(Clamp(a, T(-1), T(1))) / T(3);
  const T x1 = T(2) * Cos(th - T(kPi / 3.0));
  const T x2 = T(2) * Cos(th + T(kPi / 3.0));
  const T x3 = T(-2) * Cos(th);
  const T s3 = T(kSqrt3);
  const T sth = Sin(th), s2th = Sin(T(2) * th), cth = Cos(th);
  const T d12x = T(2.0 * kSqrt3) * sth;
  const T d13x = T(3) * cth + s3 * sth;
  const T d23x = T(3) * cth - s3 * sth;
  const T x1ma = sth * (s3 + T(2) * s2th);
  const T x3ma = x3 - a;
  const T x2ma =
      a * (T(1) - a) * (T(1) + a) / ((x1ma == T(0) ? T(1) : x1ma) * x3ma);
  const T x2s = x2 == T(0) ? Prec<T>::guard_1e300() : x2;
  d.c1 = T(3) * (x1ma * x1ma) / (x1 * d12x * d13x);
  d.c2 = T(-3) * (x2ma * x2ma) / (x2s * d12x * d23x);
  d.c3 = T(3) * (x3ma * x3ma) / (x3 * (x3 - x1) * (x3 - x2));
  sqrt_df(rms, d.x0h, d.x0l);
  const T x0 = d.x0h;
  const T rms1 = rms - T(1);
  d.x0mx1 = (rms1 - T(2) * sth * sth - s3 * s2th) / (x0 + x1);
  d.x0mx2 = (rms1 - T(2) * sth * sth + s3 * s2th) / (x0 + x2);
  d.x0mx3 = x0 + T(2) * cth;
  d.C1 = T(1) - T(1.5) * a / x0 - d.c1 / d.x0mx1 - d.c2 / d.x0mx2 -
         d.c3 / d.x0mx3;
  return d;
}

// nt_flux(disk, r) [erg cm-2 s-1], in the delta form, from the frame's
// constants
template <typename T>
SIM5_HD T nt_flux(const Frame<T>& d, T r) {
  const T rms = d.rms_disk;
  const bool inside = r <= rms;
  const T rs = inside ? rms * T(1.0001) : r;
  T xh, xl;
  sqrt_df(rs, xh, xl);
  const T x0 = d.x0h;
  const T delta = (xh - d.x0h) + (xl - d.x0l);
  const T B = delta * d.C1 + T(1.5) * d.a * vlog(delta / x0) +
              d.c1 * vlog(delta / d.x0mx1) + d.c2 * vlog(delta / d.x0mx2) +
              d.c3 * vlog(delta / d.x0mx3);
  const T F = T(1) / (T(4.0 * kPi) * rs) * T(1.5) /
              (xh * xh *
               ((d.x0mx1 + delta) * (d.x0mx2 + delta) * (d.x0mx3 + delta))) *
              B;
  const T out = T(9.1721376255e+28) * F * d.mdot / d.M;
  return inside ? T(0) : out;
}

// One pixel (ix, iy) of an nx x ny frame with aspect ny / nx: image_f =
// F g^4 and image_g = g, 0 where the ray misses the disk.  The reference
// control flow (disk-image.c:73-104): no order-0 crossing leaves the pixel
// dark; order 1 only where order 0 fell inside the ISCO; the hit, of
// either order, is shaded once.  Every lane runs the probes in the same
// order whatever its path.
template <typename T, typename Probe>
SIM5_HD void nt_pixel(const Frame<T>& d, int ix, int iy, int nx, int ny,
                      T aspect, Probe& probe, T& f_out, T& g_out) {
  // image_grid: pixel centres, [0, 0] at the image centre
  const T fx = (T(ix) + T(0.5)) / T(nx) - T(0.5);
  const T fy = (T(iy) + T(0.5)) / T(ny) - T(0.5);
  const T alpha = fx * T(2) * d.rmax;
  const T beta = fy * T(2) * d.rmax * aspect;
  const Geod<T> g =
      init_inf(d.incl, d.cos_i, d.sin_i, d.a, alpha, beta, probe);
  const bool ok = g.status == kOk;

  const T P0 = find_midplane_crossing(g, 0);
  const bool has0 = IsFinite(P0);
  T r = Nan<T>();
  if (has0) r = position_rad(g, P0);
  const bool hit0 = IsFinite(r) && r >= d.rms && ok;
  const bool use1 = has0 && !hit0;
  if (use1) r = position_rad(g, find_midplane_crossing(g, 1));
  const bool hit1 = use1 && IsFinite(r) && r >= d.rms && ok;
  const bool hit = hit0 || hit1;
  T f = T(0), gf = T(0);
  if (hit) {
    gf = gfactorK(r, d.a, g.l);
    const T g2 = gf * gf;
    f = nt_flux(d, r) * (g2 * g2);
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

}  // namespace sim5
