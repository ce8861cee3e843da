// The analytic engine's azimuth, travel time and volume seed for one
// thread: the device functions of the crossing-map kernel (crossing_map.cu)
// and the volume-seed kernel (volume_seed.cu), on the geodesic of
// analytic.cuh.
//
// Each function is the per-lane form of its plain torch version in
// sim5_tpu_torch (named beside it): the same operations in the same order.
// Where the torch version evaluates every trajectory type, or every branch
// of a special function, and selects with torch.where (its untaken lanes
// fed finite dummies), the function here branches on its lane's own type
// or argument and computes only the taken branch: it has no dummy lanes,
// and a selected value is the one the masked form selects.  Constants are
// cast to the scalar type T first, as torch casts a Python scalar to the
// tensor's dtype.  The azimuth and the travel time run in double whatever
// the geodesic's type, as their plain versions do (geodesic_position_azm's
// _as_f64).
//
// The large functions are __noinline__ on the device: each special
// function and each integral has one body that every call site shares,
// so that the compiler sizes registers for one function at a time.  g++
// builds this header too (SIM5_HD and SIM5_NI are inline there), for the
// host check of the kernels' arithmetic (tests/test_torch_analytic_host.py).
// Build without fast math and without FMA contraction (analytic.cuh).
#pragma once

#include "analytic.cuh"

#if defined(__CUDACC__)
#define SIM5_NI __host__ __device__ __noinline__
#else
#define SIM5_NI inline
#endif

namespace sim5 {

#define SIM5_MATH1(NAME, FN)                          \
  SIM5_HD double NAME(double x) { return ::FN(x); }   \
  SIM5_HD float NAME(float x) { return ::FN##f(x); }
SIM5_MATH1(Asin, asin)
SIM5_MATH1(Atan, atan)
SIM5_MATH1(Atanh, atanh)
SIM5_MATH1(Ceil, ceil)
#undef SIM5_MATH1

template <typename T>
SIM5_HD bool IsInf(T x) {
#if defined(__CUDA_ARCH__)
  return isinf(x);
#else
  return std::isinf(x);
#endif
}

// torch.remainder(n, 2.0) of an integral n
template <typename T>
SIM5_HD T Rem2(T n) {
  return n - T(2) * Floor(n / T(2));
}

// ---------------------------------------------------------------------------
// The depth of the Carlson chains that the azimuth and the time run
// ---------------------------------------------------------------------------
//
// The special functions below, the integrals and the azimuth and time
// functions take a depth policy D (FixedDepth unless given) for their RF,
// RD, RJ and RC duplication chains:
// - FixedDepth: Prec<T>::kRfDup levels on every lane, RJ's term a nested RC
//   of as many: the plain version's chains (special/carlson.py), which the
//   JAX package unrolls for lanes that run in lockstep;
// - AdaptiveDepth: Carlson's stopping rule (B. C. Carlson, Numer.
//   Algorithms 10 (1995) 13-26).  Q = r^(-1/6) max |A_0 - v| over the
//   chain's arguments v about their mean A_0, r the tolerance of the 5th-
//   order series tail at f64 rounding (3u for RF and RC, u / 4 for RD and
//   RJ, u the unit roundoff), and a lane stops at the first level m with
//   4^-m Q < |A_m|, A_m the chain's own mean, which it updates as it runs;
//   at most kRfDup levels, so that no lane does more than the fixed chain.
//   A warp runs its deepest lane's depth.  RJ's term is Carlson's 6 sum
//   4^-m RC(1, 1 + e_m) / d_m, RC in closed form (atan or atanh of
//   sqrt|e_m| over sqrt|e_m|, its series where |e_m| is small), 1 + e_m =
//   2 sqrt(p_m) (p_m + lambda_m) / d_m free of cancellation.  Each tail
//   takes one reciprocal of its mean in place of its divisions.
// The geometry that the crossing map and the seed share with the disk image
// (init_inf, P_int, position_rad, position_pol) keeps analytic.cuh's fixed
// chains whatever the policy.  D::note(chain, levels) sees each chain's
// depth: the kernels' counted instances count them (crossing_map.cu,
// volume_seed.cu), and a host build may.  D::kShare: the azimuth and the
// delay compute the values their integrals share once (the RR integrals'
// map, the theta terms' complete integrals), the same bits as computing
// them in each integral, which FixedDepth keeps (the plain chains' operations).

enum ChainKind : int { kChainRF, kChainRD, kChainRJ, kChainRC, kChainKinds };

struct FixedDepth {
  static constexpr bool kAdaptive = false, kShare = false;
  SIM5_HD static void note(int, int) {}
};
struct AdaptiveDepth {
  static constexpr bool kAdaptive = true, kShare = true;
  SIM5_HD static void note(int, int) {}
};

// Carlson's r^(-1/6): (3u)^(-1/6) for RF and RC, (u / 4)^(-1/6) for RD
// and RJ, u = 2^-53 (f64) or 2^-24 (f32).  Carlson takes (3r)^(-1/8) for
// RC's 7th-order series; the port's RC tail stops at the 5th order.
template <typename T>
SIM5_HD T stop_q_rf() {
  return T(IsF32<T>::value ? 13.322930842489667 : 379.82022430228585);
}
template <typename T>
SIM5_HD T stop_q_rd() {
  return T(IsF32<T>::value ? 20.158736798317967 : 574.7005687343988);
}

// ---------------------------------------------------------------------------
// Carlson RF, RC, RJ and RD (special/carlson.py)
// ---------------------------------------------------------------------------

// RF(x, y, z) under policy D: analytic.cuh's fixed chain, or Carlson's rule
// with the tail's one reciprocal
template <typename T, typename D = FixedDepth>
SIM5_HD T rf_p(T x, T y, T z) {
  if constexpr (!D::kAdaptive) {
    D::note(kChainRF, Prec<T>::kRfDup);
    return rf(x, y, z);
  } else {
    T xt = ClampMin(x, Prec<T>::rf_floor());
    T yt = ClampMin(y, Prec<T>::rf_floor());
    T zt = z;
    T A = (xt + yt + zt) / T(3);
    T Q = stop_q_rf<T>() * Max(Max(Abs(A - xt), Abs(A - yt)), Abs(A - zt));
    int m = 0;
    for (; m < Prec<T>::kRfDup && !(Q < Abs(A)); ++m) {
      const T sx = Sqrt(xt), sy = Sqrt(yt), sz = Sqrt(zt);
      const T lam = sx * (sy + sz) + sy * sz;
      xt = T(0.25) * (xt + lam);
      yt = T(0.25) * (yt + lam);
      zt = T(0.25) * (zt + lam);
      A = T(0.25) * (A + lam);
      Q = T(0.25) * Q;
    }
    D::note(kChainRF, m);
    const T ave = (xt + yt + zt) / T(3);
    const T inv = T(1) / ave;
    const T dx = (ave - xt) * inv, dy = (ave - yt) * inv,
            dz = (ave - zt) * inv;
    const T e2 = dx * dy - dz * dz;
    const T e3 = dx * dy * dz;
    return (T(1) + (T(1.0 / 24.0) * e2 - T(0.1) - T(3.0 / 44.0) * e3) * e2 +
            T(1.0 / 14.0) * e3) *
           Sqrt(inv);
  }
}

// _RCPos.forward: RC for x >= tiny, y > 0
template <typename T, typename D = FixedDepth>
SIM5_NI T rc_pos(T x, T y) {
  T xt = x, yt = y;
  if constexpr (!D::kAdaptive) {
    for (int i = 0; i < Prec<T>::kRfDup; ++i) {
      const T lam = T(2) * Sqrt(xt) * Sqrt(yt) + yt;
      xt = T(0.25) * (xt + lam);
      yt = T(0.25) * (yt + lam);
    }
    D::note(kChainRC, Prec<T>::kRfDup);
    const T ave = (xt + yt + yt) / T(3);
    const T sv = (yt - ave) / ave;
    return (T(1) + sv * sv * (T(0.3) + sv * (T(1.0 / 7.0) +
                                              sv * (T(0.375) + sv * T(9.0 / 22.0))))) /
           Sqrt(ave);
  } else {
    T A = (xt + yt + yt) / T(3);
    T Q = stop_q_rf<T>() * Abs(A - xt);
    int m = 0;
    for (; m < Prec<T>::kRfDup && !(Q < Abs(A)); ++m) {
      const T lam = T(2) * Sqrt(xt) * Sqrt(yt) + yt;
      xt = T(0.25) * (xt + lam);
      yt = T(0.25) * (yt + lam);
      A = T(0.25) * (A + lam);
      Q = T(0.25) * Q;
    }
    D::note(kChainRC, m);
    const T ave = (xt + yt + yt) / T(3);
    const T inv = T(1) / ave;
    const T sv = (yt - ave) * inv;
    return (T(1) + sv * sv * (T(0.3) + sv * (T(1.0 / 7.0) +
                                              sv * (T(0.375) + sv * T(9.0 / 22.0))))) *
           Sqrt(inv);
  }
}

// rc: RC(x, y), the Cauchy principal value for y < 0
template <typename T, typename D = FixedDepth>
SIM5_HD T rc(T x, T y) {
  const T tiny = Prec<T>::rf_floor();
  if (y < T(0)) {
    const T xt0 = ClampMin(x - y, tiny);
    return Sqrt(x) / Sqrt(xt0) * rc_pos<T, D>(xt0, -y);
  }
  return T(1) * rc_pos<T, D>(ClampMin(x, tiny), y == T(0) ? tiny : y);
}

// RC(1, 1 + e) in closed form, ope = 1 + e computed without cancellation:
// atan(sqrt e) / sqrt e, atanh(sqrt -e) / sqrt -e (atanh t = log1p(2 t (1
// + t) / ope) / 2, since 1 - t = ope / (1 + t)), or for |e| < 2^-9 its
// series sum (-e)^k / (2k + 1) to e^5 (the next term below 2^-54 / 13)
template <typename T>
SIM5_HD T rc_one(T e, T ope) {
  if (Abs(e) < T(0.001953125))
    return T(1) + e * (T(-1.0 / 3.0) +
                       e * (T(0.2) + e * (T(-1.0 / 7.0) +
                                          e * (T(1.0 / 9.0) -
                                               e * T(1.0 / 11.0)))));
  if (e > T(0)) {
    const T t = Sqrt(e);
    return Atan(t) / t;
  }
  const T t = Sqrt(-e);
  return T(0.5) * Log1p(T(2) * t * (T(1) + t) / ope) / t;
}

// RJ's 5th-order series at the converged (x, y, z, p), before its factor
// ave^(-3/2): the bracket of _RJPos.forward's tail, with ave's deviations
template <typename T>
SIM5_HD T rj_series(T dx, T dy, T dz, T dp) {
  const double C1 = 3.0 / 14.0, C2 = 1.0 / 3.0, C3 = 3.0 / 22.0,
               C4 = 3.0 / 26.0;
  const double C5 = 0.75 * C3, C6 = 1.5 * C4, C7 = 0.5 * C2, C8 = C3 + C3;
  const T ea = dx * (dy + dz) + dy * dz;
  const T eb = dx * dy * dz;
  const T ec = dp * dp;
  const T ed = ea - T(3) * ec;
  const T ee = eb + T(2) * dp * (ea - ec);
  return T(1) + ed * (T(-C1) + T(C5) * ed - T(C6) * ee) +
         eb * (T(C7) + dp * (T(-C8) + dp * T(C4))) +
         dp * ea * (T(C2) - dp * T(C3)) - T(C2) * dp * ec;
}

// _RJPos.forward: RJ for x, y, z >= tiny, p > 0
template <typename T, typename D = FixedDepth>
SIM5_NI T rj_pos(T x, T y, T z, T p) {
  T xt = x, yt = y, zt = z, pt = p, s = T(0), fac = T(1);
  if constexpr (!D::kAdaptive) {
    for (int i = 0; i < Prec<T>::kRfDup; ++i) {
      const T sx = Sqrt(xt), sy = Sqrt(yt), sz = Sqrt(zt);
      const T lam = sx * (sy + sz) + sy * sz;
      const T al = pt * (sx + sy + sz) + sx * sy * sz;
      const T pl = pt + lam;
      s = s + fac * rc<T, D>(al * al, pt * (pl * pl));
      xt = T(0.25) * (xt + lam);
      yt = T(0.25) * (yt + lam);
      zt = T(0.25) * (zt + lam);
      pt = T(0.25) * (pt + lam);
      fac = T(0.25) * fac;
    }
    D::note(kChainRJ, Prec<T>::kRfDup);
    const T ave = T(0.2) * (xt + yt + zt + pt + pt);
    const T dx = (ave - xt) / ave, dy = (ave - yt) / ave, dz = (ave - zt) / ave;
    const T dp = (ave - pt) / ave;
    return T(3) * s + fac * rj_series(dx, dy, dz, dp) / (ave * Sqrt(ave));
  } else {
    // Carlson 1995: delta = (p - x)(p - y)(p - z), d_m = prod (sqrt p_m +
    // sqrt v_m), e_m = 4^(-3m) delta / d_m^2
    const T delta = (p - x) * (p - y) * (p - z);
    T A = T(0.2) * (x + y + z + p + p);
    T Q = stop_q_rd<T>() * Max(Max(Abs(A - x), Abs(A - y)),
                               Max(Abs(A - z), Abs(A - p)));
    T f64 = T(1);   // 4^(-3m)
    int m = 0;
    for (; m < Prec<T>::kRfDup && !(Q < Abs(A)); ++m) {
      const T sx = Sqrt(xt), sy = Sqrt(yt), sz = Sqrt(zt), sp = Sqrt(pt);
      const T lam = sx * (sy + sz) + sy * sz;
      const T dm = (sp + sx) * (sp + sy) * (sp + sz);
      const T e = f64 * delta / (dm * dm);
      const T ope = T(2) * sp * (pt + lam) / dm;
      s = s + fac * rc_one(e, ope) / dm;
      xt = T(0.25) * (xt + lam);
      yt = T(0.25) * (yt + lam);
      zt = T(0.25) * (zt + lam);
      pt = T(0.25) * (pt + lam);
      A = T(0.25) * (A + lam);
      Q = T(0.25) * Q;
      fac = T(0.25) * fac;
      f64 = T(0.015625) * f64;
    }
    D::note(kChainRJ, m);
    const T ave = T(0.2) * (xt + yt + zt + pt + pt);
    const T inv = T(1) / ave;
    const T dx = (ave - xt) * inv, dy = (ave - yt) * inv,
            dz = (ave - zt) * inv, dp = (ave - pt) * inv;
    return T(6) * s + fac * rj_series(dx, dy, dz, dp) * (inv * Sqrt(inv));
  }
}

// rj: RJ(x, y, z, p), the Cauchy principal value for p < 0
template <typename T, typename D = FixedDepth>
SIM5_NI T rj(T x, T y, T z, T p) {
  const T tiny = Prec<T>::rf_floor();
  if (p < T(0)) {
    const T xs = Min(Min(x, y), z);
    const T zs = Max(Max(x, y), z);
    const T ys = x + y + z - xs - zs;
    const T ys_safe = ys > T(0) ? ys : T(1);
    const T a_ = T(1) / (ys - p);
    const T b_ = a_ * (zs - ys) * (ys - xs);
    const T pt = ys + b_;
    const T rho = xs * zs / ys_safe;
    const T tau = p * pt / ys_safe;
    const T rcx = rc<T, D>(rho, tau);
    const T xt = ClampMin(xs, tiny), yt = ClampMin(ys, tiny),
            zt = ClampMin(zs, tiny);
    const T ans = rj_pos<T, D>(xt, yt, zt, pt);
    return a_ * (b_ * ans + T(3) * (rcx - rf_p<T, D>(xt, yt, zt)));
  }
  return rj_pos<T, D>(ClampMin(x, tiny), ClampMin(y, tiny), ClampMin(z, tiny),
                      p == T(0) ? tiny : p);
}

// analytic.cuh's rd_chain<T, 4> on (x, y, z) under policy D: RD's slot
// (z) carried; with rf_too, a lane stops where RF's rule holds as well
template <typename T, typename D>
SIM5_HD Chain<T> rd_chain_p(T x, T y, T z, bool rf_too) {
  if constexpr (!D::kAdaptive) {
    D::note(kChainRD, Prec<T>::kRfDup);
    return rd_chain<T, 4>(x, y, z);
  } else {
    Chain<T> c;
    c.v[0] = x;
    c.v[1] = y;
    c.v[2] = z;
    c.fac = T(1);
    for (int i = 0; i < 3; ++i) c.s[i] = T(0);
    T A = T(0.2) * (x + y + T(3) * z);
    T Q = stop_q_rd<T>() * Max(Max(Abs(A - x), Abs(A - y)), Abs(A - z));
    T Af = (x + y + z) / T(3);
    T Qf = rf_too ? stop_q_rf<T>() * Max(Max(Abs(Af - x), Abs(Af - y)),
                                          Abs(Af - z))
                  : T(0);
    int m = 0;
    for (; m < Prec<T>::kRfDup && !(Q < Abs(A) && Qf < Abs(Af)); ++m) {
      T sq[3];
      for (int i = 0; i < 3; ++i) sq[i] = Sqrt(c.v[i]);
      const T lam = sq[0] * (sq[1] + sq[2]) + sq[1] * sq[2];
      c.s[2] = c.s[2] + c.fac / (sq[2] * (c.v[2] + lam));
      for (int i = 0; i < 3; ++i) c.v[i] = T(0.25) * (c.v[i] + lam);
      c.fac = T(0.25) * c.fac;
      A = T(0.25) * (A + lam);
      Q = T(0.25) * Q;
      Af = T(0.25) * (Af + lam);
      Qf = T(0.25) * Qf;
    }
    D::note(kChainRD, m);
    return c;
  }
}

// RD with slot 2 in the -3/2 slot from a chain of rd_chain_p: Chain::rd(2),
// or under AdaptiveDepth its tail with one reciprocal
template <typename T, typename D>
SIM5_HD T rd_of(const Chain<T>& c) {
  if constexpr (!D::kAdaptive) {
    return c.rd(2);
  } else {
    const T xa = c.v[0], xb = c.v[1], xc = c.v[2];
    const T ave = T(0.2) * (xa + xb + T(3) * xc);
    const T inv = T(1) / ave;
    const T dx = (ave - xa) * inv, dy = (ave - xb) * inv,
            dz = (ave - xc) * inv;
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
    return T(3) * c.s[2] + c.fac * tail * (inv * Sqrt(inv));
  }
}

// rd: RD(x, y, z), the chain of analytic.cuh's rule
template <typename T, typename D = FixedDepth>
SIM5_NI T rd(T x, T y, T z) {
  const T fl = Prec<T>::rf_floor();
  return rd_of<T, D>(rd_chain_p<T, D>(ClampMin(x, fl), ClampMin(y, fl), z,
                                      false));
}

// rf(x, y, z) and rd(x, y, z) from one duplication chain: the bits of the
// two calls (their chains compute the same triples) under FixedDepth
template <typename T, typename D = FixedDepth>
SIM5_NI void rf_rd(T x, T y, T z, T& f, T& d) {
  const T fl = Prec<T>::rf_floor();
  const Chain<T> c =
      rd_chain_p<T, D>(ClampMin(x, fl), ClampMin(y, fl), z, true);
  f = rf_tail(c.v[0], c.v[1], c.v[2]);
  d = rd_of<T, D>(c);
}

// ---------------------------------------------------------------------------
// Legendre F, E and Pi in their cosine forms (special/legendre.py)
// ---------------------------------------------------------------------------

// _clamp_m
template <typename T>
SIM5_HD T clamp_m(T m) {
  return m >= T(1) ? T(0.99999999) : m;
}

// elliptic_f_cos: F(phi, m), phi by its cosine
template <typename T, typename D = FixedDepth>
SIM5_NI T elliptic_f_cos(T cos_phi, T m) {
  m = clamp_m(m);
  if (cos_phi == T(1)) return T(0);
  const bool neg = cos_phi < T(0);
  const T c = Abs(cos_phi);
  const T X = neg ? T(2) * rf_p<T, D>(T(0), T(1) - m, T(1)) : T(0);
  const T s2 = T(1) - c * c;
  const T base = Sqrt(ClampMin(s2, T(0))) *
                 rf_p<T, D>(T(1) - s2, T(1) - s2 * m, T(1));
  return X + (neg ? -base : base);
}

// elliptic_e_cos: E(phi, m), phi by its cosine (_e_complete, _e_base)
template <typename T, typename D = FixedDepth>
SIM5_NI T elliptic_e_cos(T cos_phi, T m) {
  m = clamp_m(m);
  if (cos_phi == T(1)) return T(0);
  const bool neg = cos_phi < T(0);
  const T c = Abs(cos_phi);
  T X = T(0), f, d;
  if (neg) {
    rf_rd<T, D>(T(0), T(1) - m, T(1), f, d);
    X = T(2) * (f - m * d / T(3));
  }
  const T c2 = c * c;
  const T s = Sqrt(ClampMin(T(1) - c2, T(0)));
  rf_rd<T, D>(c2, T(1) - m + c2 * m, T(1), f, d);
  const T base = s * (f - (s * s * m) * d / T(3));
  return X + (neg ? -base : base);
}

// elliptic_pi_complete: Pi(n, m)
template <typename T, typename D = FixedDepth>
SIM5_NI T elliptic_pi_complete(T n, T m) {
  m = clamp_m(m);
  n = n == T(1) ? T(0.99999999) : n;
  if (IsInf(n)) return T(0);
  const T q = T(1) - m;
  return rf_p<T, D>(T(0), q, T(1)) + n * rj<T, D>(T(0), q, T(1), T(1) - n) / T(3);
}

// elliptic_pi_cos: Pi(phi, n, m), phi by its cosine
template <typename T, typename D = FixedDepth>
SIM5_NI T elliptic_pi_cos(T cos_phi, T n, T m) {
  m = clamp_m(m);
  if (IsInf(n) || cos_phi == T(1)) return T(0);
  if (cos_phi == T(0)) return elliptic_pi_complete<T, D>(n, m);
  const bool negp = cos_phi < T(0);
  const T c = Abs(cos_phi);
  T X = T(0);
  if (negp)
    X = T(2) * (rf_p<T, D>(T(0), T(1) - m, T(1)) +
                n * rj<T, D>(T(0), T(1) - m, T(1), T(1) - n) / T(3));
  const T c2 = c * c;
  const T s2 = T(1) - c2;
  const T s = Sqrt(ClampMin(s2, T(0)));
  const T ns2 = -n * s2;
  const T q = T(1) - s2 * m;
  const T base = s * (rf_p<T, D>(c2, q, T(1)) -
                      ns2 * rj<T, D>(c2, q, T(1), T(1) + ns2) / T(3));
  return X + (negp ? -base : base);
}

// ---------------------------------------------------------------------------
// Jacobi functions and their inverses (special/jacobi.py)
// ---------------------------------------------------------------------------

// jacobi_sncndn(u, m): m clamped below 1, the complement by subtraction
template <typename T>
SIM5_HD void sncndn_m(T u, T m, T& sn, T& cn, T& dn) {
  m = m >= T(1) ? T(0.999999999) : m;
  sncndn(u, T(1) - m, sn, cn, dn);
}

// _elliptic_k_raw: K(m) by RF
template <typename T, typename D = FixedDepth>
SIM5_HD T k_raw(T m) {
  m = m >= T(1) ? T(1.0 - 1e-8) : m;
  return rf_p<T, D>(T(0), T(1) - m, T(1));
}

// _elliptic_f_sin_raw
template <typename T, typename D = FixedDepth>
SIM5_HD T f_sin_raw(T sin_phi, T m) {
  const T s2 = sin_phi * sin_phi;
  return sin_phi * rf_p<T, D>(T(1) - s2, T(1) - s2 * m, T(1));
}

// jacobi_isn: u with sn(u | m) = z
template <typename T, typename D = FixedDepth>
SIM5_NI T jacobi_isn(T z, T m) {
  if (Abs(m) < T(1e-8)) return Asin(Clamp(z, T(-1), T(1)));
  if (Abs(m - T(1)) < T(1e-8)) {
    const T zc = Clamp(z, T(-1.0 + 1e-15), T(1.0 - 1e-15));
    return Log(Sqrt((T(1) + zc) / (T(1) - zc)));
  }
  return z * rf_p<T, D>(T(1) - z * z, T(1) - m * z * z, T(1));
}

// jacobi_icn: u with cn(u | m) = z, its special branches included
template <typename T, typename D = FixedDepth>
SIM5_NI T jacobi_icn(T z, T m) {
  if (z > T(1) && z < T(1.0 + 1e-8)) z = T(1);
  if (z < T(-1) && z > T(-1.0 - 1e-8)) z = T(-1);
  if (m > T(1) && m < T(1.0 + 1e-8)) m = T(1);
  if (m < T(0) && m > T(-1e-8)) m = T(0);
  if (z == T(0)) return k_raw<T, D>(m);
  if (z == T(1)) return T(0);
  const T edge_hi = T(1.0 - 1e-15);
  const T az_c = ClampMax(Abs(z), T(1));
  const bool edge = az_c >= edge_hi || az_c == T(0);
  if (m == T(0)) {
    const T acos_arg = Abs(z) >= edge_hi ? T(0) : Clamp(z, T(-1), T(1));
    return z >= edge_hi ? T(0)
                        : (z <= T(-1.0 + 1e-15) ? T(kPi) : Acos(acos_arg));
  }
  const T az_g = edge ? T(0.5) : az_c;
  if (m == T(1))
    return az_c >= edge_hi ? T(0) : Log((T(1) + Sqrt(T(1) - az_g)) / az_g);
  T icn1;
  if (az_c >= edge_hi)
    icn1 = T(0);
  else if (az_c == T(0))
    icn1 = k_raw<T, D>(m);
  else
    icn1 = Sqrt(T(1) - az_g * az_g) *
           rf_p<T, D>(az_g * az_g, T(1) - m * (T(1) - az_g * az_g), T(1));
  if (z > T(0)) return icn1;
  // z < 0: 2 / sqrt(1 - m) F_sin(-z | m / (m - 1)) + icn(|z|)
  const T m_safe = m >= T(1) ? T(1.0 - 1e-12) : m;
  const T mp = m_safe / (m_safe - T(1) - (m_safe == T(1) ? T(1e-300) : T(0)));
  const T f = az_c >= edge_hi ? rf_p<T, D>(T(0), T(1) - mp, T(1))
                               : f_sin_raw<T, D>(az_g, mp);
  return T(2) / Sqrt(T(1) - m_safe) * f + icn1;
}

// icn_signed: jacobi_icn's generic branches, -1 < z < 1, 0 < m < 1
template <typename T, typename D = FixedDepth>
SIM5_NI T icn_signed(T z, T m) {
  const T feps = T(8.0 * static_cast<double>(Prec<T>::eps()));
  const T az = Clamp(Abs(z), feps, T(1) - feps);
  const T icn1 = Sqrt(T(1) - az * az) *
                 rf_p<T, D>(az * az, T(1) - m * (T(1) - az * az), T(1));
  if (z >= T(0)) return icn1;
  const T m_safe = Clamp(m, T(0), T(1) - feps);
  const T mp = m_safe / (m_safe - T(1));
  return T(2) / Sqrt(T(1) - m_safe) * f_sin_raw<T, D>(az, mp) + icn1;
}

// jacobi_itn: u with tn(u | m) = z (even in z, as the reference)
template <typename T, typename D = FixedDepth>
SIM5_NI T jacobi_itn(T z, T m) {
  if (m == T(0)) return Atan(z);
  if (m == T(1)) return Log(z + Sqrt(T(1) + z * z));
  return jacobi_isn<T, D>(Sqrt(z * z / (T(1) + z * z)), m);
}

// ---------------------------------------------------------------------------
// Byrd & Friedman integrals (special/integrals.py)
// ---------------------------------------------------------------------------

// integral_C0
template <typename T>
SIM5_HD T integral_C0(T u, T) {
  return u;
}

// integral_C1
template <typename T>
SIM5_NI T integral_C1(T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return Acos(Clamp(dn, T(-1), T(1))) / Sqrt(m);
}

// integral_C2
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_C2(T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return (elliptic_e_cos<T, D>(cn, m) - (T(1) - m) * u) / m;
}

// integral_C2_cos
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_C2_cos(T cn_u, T m) {
  return (elliptic_e_cos<T, D>(cn_u, m) -
          (T(1) - m) * elliptic_f_cos<T, D>(cn_u, m)) /
         m;
}

// integral_Z1
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_Z1(T a, T b, T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return ((a - b) * elliptic_pi_cos<T, D>(cn, a, m) + b * u) / a;
}

// integral_Z2
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_Z2(T a, T b, T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  const T V1 = elliptic_pi_cos<T, D>(cn, a, m);
  const T V2 = T(0.5) / ((a - T(1)) * (m - a)) *
               (a * elliptic_e_cos<T, D>(cn, m) + (m - a) * u +
                (T(2) * a * m + T(2) * a - a * a - T(3) * m) * V1 -
                (a * a * sn * cn * dn) / (T(1) - a * sn * sn));
  const T ab = a - b;
  return (b * b * u + T(2) * b * ab * V1 + ab * ab * V2) / (a * a);
}

// integral_Rm1 at (sn, cn, dn) = sncndn(u | m)
template <typename T>
SIM5_HD T rm1_at(T a, T u, T m, T dn) {
  return u + a / Sqrt(m) * Acos(Clamp(dn, T(-1), T(1)));
}

// integral_Rm2 at (sn, cn, dn) = sncndn(u | m)
template <typename T, typename D = FixedDepth>
SIM5_NI T rm2_at(T a, T u, T m, T cn, T dn) {
  const T a2 = a * a;
  const T acos_dn = Acos(Clamp(dn, T(-1), T(1)));
  return ((m - a2 * (T(1) - m)) * u + a2 * elliptic_e_cos<T, D>(cn, m) +
          T(2) * a * Sqrt(m) * acos_dn) /
         m;
}

// integral_R1 at (sn, cn, dn) = sncndn(u | m)
template <typename T, typename D = FixedDepth>
SIM5_NI T r1_at(T a, T m, T sn, T cn, T dn) {
  const T a2 = a * a;
  const T n = a2 / (a2 - T(1));
  const T mma = (m + (T(1) - m) * a2) / (T(1) - a2);
  const T t = sn / dn;
  // f1 = sqrt(1/mma) atan(sqrt(mma) t), decomposed over mma's sign
  T f1;
  if (Abs(mma) <= T(1e-5)) {
    f1 = t;
  } else if (mma > T(0)) {
    const T sp = Sqrt(mma);
    f1 = Atan(sp * t) / sp;
  } else {
    const T sn_ = Sqrt(-mma);
    const T y = sn_ * t;
    const T y_in = Abs(y) < T(1) ? y : T(1) / (y == T(0) ? T(1) : y);
    f1 = -Atanh(Clamp(y_in, T(-1.0 + 1e-300), T(1.0 - 1e-300))) / sn_;
  }
  return (elliptic_pi_cos<T, D>(cn, n, m) + a * f1) / (T(1) - a2);
}

// integral_R1
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R1(T a, T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return r1_at<T, D>(a, m, sn, cn, dn);
}

// integral_Rm1
template <typename T>
SIM5_NI T integral_Rm1(T a, T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return rm1_at(a, u, m, dn);
}

// integral_Rm2
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_Rm2(T a, T u, T m) {
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return rm2_at<T, D>(a, u, m, cn, dn);
}

// integral_R0
template <typename T>
SIM5_HD T integral_R0(T u, T) {
  return u;
}

// integral_R2: its R1, Rm1 and Rm2 at the one sncndn(u | m) they each
// evaluate
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R2(T a, T u, T m) {
  const T a2 = a * a;
  const T mma = m + (T(1) - m) * a2;
  T sn, cn, dn;
  sncndn_m(u, m, sn, cn, dn);
  return T(1) / (a2 - T(1)) / mma *
         ((a2 * (T(2) * m - T(1)) - T(2) * m) * r1_at<T, D>(a, m, sn, cn, dn) +
          T(2) * m * rm1_at(a, u, m, dn) - m * rm2_at<T, D>(a, u, m, cn, dn) +
          a * a2 * sn * dn / (T(1) + a * cn));
}

// the m and sn of the from-infinity RR forms (BF 258)
template <typename T>
SIM5_HD T re_m(T a, T b, T c, T d) {
  return ((b - c) * (a - d)) / ((a - c) * (b - d));
}
template <typename T>
SIM5_HD T re_sn(T a, T b, T d, T X) {
  return Sqrt(((b - d) * (X - a)) / ((a - d) * (X - b)));
}

// integral_R_r0_re
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r0_re(T a, T b, T c, T d, T X) {
  const T m4 = re_m(a, b, c, d);
  return T(2) / Sqrt((a - c) * (b - d)) * jacobi_isn<T, D>(re_sn(a, b, d, X), m4);
}

// integral_R_r0_re_inf
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r0_re_inf(T a, T b, T c, T d) {
  const T m4 = re_m(a, b, c, d);
  return T(2) / Sqrt((a - c) * (b - d)) *
         jacobi_isn<T, D>(Sqrt((b - d) / (a - d)), m4);
}

// the A, B and m of the RC forms (BF 260)
template <typename T>
struct CCForm {
  T A, B, m;
};
template <typename T>
SIM5_HD CCForm<T> cc_form(T a, T b, T u, T v) {
  CCForm<T> f;
  const T v2 = v * v;
  const T au = a - u, bu = b - u;
  f.A = Sqrt(au * au + v2);
  f.B = Sqrt(bu * bu + v2);
  const T ApB = f.A + f.B, ab = a - b;
  f.m = (ApB * ApB - ab * ab) / (T(4) * f.A * f.B);
  return f;
}
// cn of the RC map at X
template <typename T>
SIM5_HD T cc_cn(T a, T b, const CCForm<T>& f, T X) {
  return (X * (f.A - f.B) + a * f.B - b * f.A) /
         (X * (f.A + f.B) - a * f.B - b * f.A);
}

// integral_R_r0_cc
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r0_cc(T a, T b, T u, T v, T X) {
  const CCForm<T> f = cc_form(a, b, u, v);
  return jacobi_icn<T, D>(cc_cn(a, b, f, X), f.m) / Sqrt(f.A * f.B);
}

// integral_R_r0_cc_inf
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r0_cc_inf(T a, T b, T u, T v) {
  const CCForm<T> f = cc_form(a, b, u, v);
  return jacobi_icn<T, D>((f.A - f.B) / (f.A + f.B), f.m) / Sqrt(f.A * f.B);
}

// integral_R_r1_re
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r1_re(T a, T b, T c, T d, T X) {
  const T m2 = re_m(a, b, c, d);
  const T u = jacobi_isn<T, D>(re_sn(a, b, d, X), m2);
  const T a2 = (a - d) / (b - d);
  const T b2 = ((a - d) * b) / (a * (b - d));
  const T Z = integral_Z1<T, D>(a2, b2, u, m2) -
              integral_Z1<T, D>(a2, b2, T(0), m2);
  return a * T(2) / Sqrt((a - c) * (b - d)) * Z;
}

// integral_R_r2_re
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r2_re(T a, T b, T c, T d, T X) {
  const T m2 = re_m(a, b, c, d);
  const T u = jacobi_isn<T, D>(re_sn(a, b, d, X), m2);
  const T a2 = (a - d) / (b - d);
  const T b2 = ((a - d) * b) / (a * (b - d));
  const T Z = integral_Z2<T, D>(a2, b2, u, m2) -
              integral_Z2<T, D>(a2, b2, T(0), m2);
  return a * a * T(2) / Sqrt((a - c) * (b - d)) * Z;
}

// integral_R_r1_cc
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r1_cc(T a, T b, T u, T v, T X1, T X2) {
  const CCForm<T> f = cc_form(a, b, u, v);
  const T A = f.A, B = f.B, m = f.m;
  const T g = T(1) / Sqrt(A * B);
  const T alpha1 = (B * a + b * A) / (B * a - b * A);
  const T alpha2 = (B + A) / (B - A);
  const T u1 = elliptic_f_cos<T, D>(cc_cn(a, b, f, X1), m);
  const T u2 = elliptic_f_cos<T, D>(cc_cn(a, b, f, X2), m);
  const T t0 = alpha1 * (u2 - u1);
  const T t1 = (alpha2 - alpha1) *
               (integral_R1<T, D>(alpha2, u2, m) -
                integral_R1<T, D>(alpha2, u1, m));
  return (B * a - b * A) / (B + A) * g * (t0 + t1);
}

// integral_R_r2_cc
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_R_r2_cc(T a, T b, T u, T v, T X1, T X2) {
  const CCForm<T> f = cc_form(a, b, u, v);
  const T A = f.A, B = f.B, m = f.m;
  const T g = T(1) / Sqrt(A * B);
  const T alpha1 = (B * a + b * A) / (B * a - b * A);
  const T alpha2 = (B + A) / (B - A);
  const T u1 = elliptic_f_cos<T, D>(cc_cn(a, b, f, X1), m);
  const T u2 = elliptic_f_cos<T, D>(cc_cn(a, b, f, X2), m);
  const T d21 = alpha2 - alpha1;
  const T t0 = alpha1 * alpha1 * (u2 - u1);
  const T t1 = T(2) * alpha1 * d21 *
               (integral_R1<T, D>(alpha2, u2, m) -
                integral_R1<T, D>(alpha2, u1, m));
  const T t2 = d21 * d21 *
               (integral_R2<T, D>(alpha2, u2, m) -
                integral_R2<T, D>(alpha2, u1, m));
  const T w = (B * a - b * A) / (B + A);
  return w * w * g * (t0 + t1 + t2);
}

// integral_R_rp_re and integral_R_rp_re_inf: sn the map's value at X (or
// at infinity)
template <typename T, typename D = FixedDepth>
SIM5_NI T rp_re_at(T a, T b, T c, T d, T p, T sn) {
  const T m2 = re_m(a, b, c, d);
  const T u1 = jacobi_isn<T, D>(sn, m2);
  const T a2 = (a - d) / (b - d);
  const T c2 = ((p - b) * (a - d)) / ((p - a) * (b - d));
  const T Z = integral_Z1<T, D>(c2, a2, u1, m2) -
              integral_Z1<T, D>(c2, a2, T(0), m2);
  return T(-2) / Sqrt((a - c) * (b - d)) / (p - a) * Z;
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_rp_re(T a, T b, T c, T d, T p, T X) {
  return rp_re_at<T, D>(a, b, c, d, p, re_sn(a, b, d, X));
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_rp_re_inf(T a, T b, T c, T d, T p) {
  return rp_re_at<T, D>(a, b, c, d, p, Sqrt((b - d) / (a - d)));
}

// The RR (from infinity) integrals at one point of the map share its u =
// isn(sn | m), sncndn(u | m) and, for R1 and R2, Pi(cn, a2 | m); the
// functions below compute each shared value once and otherwise the
// operations of the single integrals, so that each result has their bits
// (the azimuth and the delay take them where D::kShare).
// Z1 and Z2 at (sn, cn, dn) = sncndn(u | m), V1 = Pi(cn, a | m) given
template <typename T, typename D>
SIM5_HD T z1_at(T a, T b, T u, T m, T cn) {
  return ((a - b) * elliptic_pi_cos<T, D>(cn, a, m) + b * u) / a;
}
template <typename T, typename D>
SIM5_HD T z2_at(T a, T b, T u, T m, T sn, T cn, T dn, T V1) {
  const T V2 = T(0.5) / ((a - T(1)) * (m - a)) *
               (a * elliptic_e_cos<T, D>(cn, m) + (m - a) * u +
                (T(2) * a * m + T(2) * a - a * a - T(3) * m) * V1 -
                (a * a * sn * cn * dn) / (T(1) - a * sn * sn));
  const T ab = a - b;
  return (b * b * u + T(2) * b * ab * V1 + ab * ab * V2) / (a * a);
}

// integral_R_rp_re at the map's value sn for the two poles p1 and p2 (or
// integral_R_rp_re_inf with sn its value at infinity): R[0], R[1]
template <typename T, typename D = FixedDepth>
SIM5_NI void rp_re_pair(T a, T b, T c, T d, T p1, T p2, T sn, T* R) {
  const T m2 = re_m(a, b, c, d);
  const T u1 = jacobi_isn<T, D>(sn, m2);
  const T a2 = (a - d) / (b - d);
  T s_u, c_u, d_u, s_0, c_0, d_0;
  sncndn_m(u1, m2, s_u, c_u, d_u);
  sncndn_m(T(0), m2, s_0, c_0, d_0);
  const T ps[2] = {p1, p2};
  for (int j = 0; j < 2; ++j) {
    const T p = ps[j];
    const T c2 = ((p - b) * (a - d)) / ((p - a) * (b - d));
    const T Z = z1_at<T, D>(c2, a2, u1, m2, c_u) -
                z1_at<T, D>(c2, a2, T(0), m2, c_0);
    R[j] = T(-2) / Sqrt((a - c) * (b - d)) / (p - a) * Z;
  }
}

// the terms of an RR ray's radial travel time at X: integral_R_r0_re,
// _r1_re, _r2_re and _rp_re at the poles p1 and p2, into R[0..5)
template <typename T, typename D = FixedDepth>
SIM5_NI void rr_time_terms(T a, T b, T c, T d, T p1, T p2, T X, T* R) {
  const T m2 = re_m(a, b, c, d);
  const T sn = re_sn(a, b, d, X);
  const T u = jacobi_isn<T, D>(sn, m2);
  R[0] = T(2) / Sqrt((a - c) * (b - d)) * u;
  const T a2 = (a - d) / (b - d);
  const T b2 = ((a - d) * b) / (a * (b - d));
  T s_u, c_u, d_u, s_0, c_0, d_0;
  sncndn_m(u, m2, s_u, c_u, d_u);
  sncndn_m(T(0), m2, s_0, c_0, d_0);
  const T V_u = elliptic_pi_cos<T, D>(c_u, a2, m2);
  const T V_0 = elliptic_pi_cos<T, D>(c_0, a2, m2);
  const T Z1 = ((a2 - b2) * V_u + b2 * u) / a2 -
               ((a2 - b2) * V_0 + b2 * T(0)) / a2;
  R[1] = a * T(2) / Sqrt((a - c) * (b - d)) * Z1;
  const T Z2 = z2_at<T, D>(a2, b2, u, m2, s_u, c_u, d_u, V_u) -
               z2_at<T, D>(a2, b2, T(0), m2, s_0, c_0, d_0, V_0);
  R[2] = a * a * T(2) / Sqrt((a - c) * (b - d)) * Z2;
  const T ps[2] = {p1, p2};
  for (int j = 0; j < 2; ++j) {
    const T p = ps[j];
    const T c2 = ((p - b) * (a - d)) / ((p - a) * (b - d));
    const T Z = z1_at<T, D>(c2, a2, u, m2, c_u) -
                z1_at<T, D>(c2, a2, T(0), m2, c_0);
    R[3 + j] = T(-2) / Sqrt((a - c) * (b - d)) / (p - a) * Z;
  }
}

// integral_R_rp_cc2 and integral_R_rp_cc2_inf: cn2 the map's value at X2
// (or at infinity)
template <typename T, typename D = FixedDepth>
SIM5_NI T rp_cc2_at(T a, T b, T u, T v, T p, T X1, const T* X2) {
  const CCForm<T> f = cc_form(a, b, u, v);
  const T A = f.A, B = f.B, m = f.m;
  const T g = T(1) / Sqrt(A * B);
  const T num = B * a + b * A - p * A - p * B;
  const T alpha1 = num / (B * a - b * A + p * A - p * B);
  const T alpha2 = (B + A) / (B - A);
  const T u1 = elliptic_f_cos<T, D>(cc_cn(a, b, f, X1), m);
  const T u2 = elliptic_f_cos<T, D>(
      X2 != nullptr ? cc_cn(a, b, f, *X2) : (A - B) / (A + B), m);
  const T t0 = alpha2 * (u2 - u1);
  const T t1 = (alpha1 - alpha2) *
               (integral_R1<T, D>(alpha1, u2, m) -
                integral_R1<T, D>(alpha1, u1, m));
  return (B - A) * g / num * (t0 + t1);
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_rp_cc2(T a, T b, T u, T v, T p, T X1, T X2) {
  return rp_cc2_at<T, D>(a, b, u, v, p, X1, &X2);
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_rp_cc2_inf(T a, T b, T u, T v, T p, T X1) {
  return rp_cc2_at<T, D>(a, b, u, v, p, X1, static_cast<const T*>(nullptr));
}

// _band_setup: the bound band's map, once for every integrand at Y
template <typename T>
struct Band {
  T r1, r2, r3, r4, mm4, c4, kappa, u;
};
template <typename T, typename D = FixedDepth>
SIM5_NI Band<T> band_setup(T r1, T r2, T r3, T r4, T Y) {
  Band<T> b;
  b.r1 = r1;
  b.r2 = r2;
  b.r3 = r3;
  b.r4 = r4;
  b.mm4 = ((r2 - r3) * (r1 - r4)) / ((r2 - r4) * (r1 - r3));
  b.c4 = T(2) / Sqrt((r1 - r3) * (r2 - r4));
  b.kappa = (r2 - r3) / (r1 - r3);
  const T sn = Sqrt(Clamp((r1 - r3) / (r2 - r3) * (r2 - Y) / (r1 - Y), T(0), T(1)));
  b.u = jacobi_isn<T, D>(sn, b.mm4);
  return b;
}
// integral_R_r0_bh, _r1_bh, _r2_bh and _rp_bh on the band's map
template <typename T>
SIM5_HD T band_r0(const Band<T>& b) {
  return b.c4 * b.u;
}
template <typename T, typename D = FixedDepth>
SIM5_HD T band_r1(const Band<T>& b) {
  return b.c4 * b.r2 *
         integral_Z1<T, D>(b.kappa, b.kappa * b.r1 / b.r2, b.u, b.mm4);
}
template <typename T, typename D = FixedDepth>
SIM5_HD T band_r2(const Band<T>& b) {
  return b.c4 * (b.r2 * b.r2) *
         integral_Z2<T, D>(b.kappa, b.kappa * b.r1 / b.r2, b.u, b.mm4);
}
template <typename T, typename D = FixedDepth>
SIM5_HD T band_rp(const Band<T>& b, T p) {
  const T n = b.kappa * (b.r1 - p) / (b.r2 - p);
  return b.c4 / (b.r2 - p) * integral_Z1<T, D>(n, b.kappa, b.u, b.mm4);
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_r0_bh(T r1, T r2, T r3, T r4, T Y) {
  return band_r0(band_setup<T, D>(r1, r2, r3, r4, Y));
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_r1_bh(T r1, T r2, T r3, T r4, T Y) {
  return band_r1<T, D>(band_setup<T, D>(r1, r2, r3, r4, Y));
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_r2_bh(T r1, T r2, T r3, T r4, T Y) {
  return band_r2<T, D>(band_setup<T, D>(r1, r2, r3, r4, Y));
}
template <typename T, typename D = FixedDepth>
SIM5_HD T integral_R_rp_bh(T r1, T r2, T r3, T r4, T p, T Y) {
  return band_rp<T, D>(band_setup<T, D>(r1, r2, r3, r4, Y), p);
}

// integral_T_m0
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_T_m0(T a2, T b2, T X) {
  const T m = b2 / (a2 + b2);
  return jacobi_icn<T, D>(X / Sqrt(b2), m) / Sqrt(a2 + b2);
}

// integral_T_m2
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_T_m2(T a2, T b2, T X) {
  const T m = b2 / (a2 + b2);
  const T cn = X / Sqrt(b2);
  return b2 / Sqrt(a2 + b2) *
         (integral_C2_cos<T, D>(cn, m) - integral_C2<T, D>(T(0), m));
}

// _dn_amplitude_cos: cos(am u) of the dn-band map at X, and its modulus
template <typename T>
SIM5_HD T dn_amplitude_cos(T c2, T b2, T X, T& mm) {
  mm = (b2 - c2) / b2;
  const T sn2 = Clamp((T(1) - X * X / b2) / mm, T(0), T(1));
  return Sqrt(T(1) - sn2);
}

// integral_T_m0_dn
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_T_m0_dn(T c2, T b2, T X) {
  T mm;
  const T cn = dn_amplitude_cos(c2, b2, X, mm);
  return elliptic_f_cos<T, D>(cn, mm) / Sqrt(b2);
}

// integral_T_m2_dn
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_T_m2_dn(T c2, T b2, T X) {
  T mm;
  const T cn = dn_amplitude_cos(c2, b2, X, mm);
  return Sqrt(b2) * elliptic_e_cos<T, D>(cn, mm);
}

// integral_T_mp_dn
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_T_mp_dn(T c2, T b2, T p, T X) {
  T mm;
  const T cn = dn_amplitude_cos(c2, b2, X, mm);
  const T n = -b2 * mm / (p - b2);
  return elliptic_pi_cos<T, D>(cn, n, mm) / (Sqrt(b2) * (p - b2));
}

// integral_T_mp; pi_c, if given, its elliptic_pi_complete(n, m)
template <typename T, typename D = FixedDepth>
SIM5_NI T integral_T_mp(T a2, T b2, T p, T X, const T* pi_c = nullptr) {
  const T m = b2 / (a2 + b2);
  const T n = b2 / (b2 - p);
  const T aX = Abs(X) / Sqrt(b2);
  const T pi_pos = elliptic_pi_cos<T, D>(aX, n, m);
  if (X >= T(0)) return pi_pos / Sqrt(a2 + b2) / (p - b2);
  const T pc = pi_c != nullptr ? *pi_c : elliptic_pi_complete<T, D>(n, m);
  return (T(2) * pc - pi_pos) / Sqrt(a2 + b2) / (p - b2);
}

// ---------------------------------------------------------------------------
// the geodesic's position, poloidal fold and momentum (geodesic/analytic.py)
// ---------------------------------------------------------------------------

SIM5_HD bool live(int gtype) {
  return gtype == kTypeRR || gtype == kTypeRC || gtype == kTypeCC ||
         gtype == kTypeRRBH;
}

// the scalar the azimuth and the time are computed in for a geodesic of
// scalar T: double for float and double (_as_f64); a host build's counting
// scalar specializes it
template <typename T>
struct Wide {
  using type = double;
};

// the geodesic of scalar T in scalar W (_as_f64)
template <typename W, typename T>
SIM5_HD Geod<W> widen_geod(const Geod<T>& g) {
  Geod<W> d;
  d.a = W(g.a);
  d.alpha = W(g.alpha);
  d.beta = W(g.beta);
  d.incl = W(g.incl);
  d.cos_i = W(g.cos_i);
  d.l = W(g.l);
  d.q = W(g.q);
  for (int i = 0; i < 4; ++i) {
    d.rr[i] = W(g.rr[i]);
    d.ri[i] = W(g.ri[i]);
    d.rr_lo[i] = W(g.rr_lo[i]);
  }
  d.nrr = g.nrr;
  d.gtype = g.gtype;
  d.status = g.status;
  d.m2p = W(g.m2p);
  d.m2m = W(g.m2m);
  d.mm = W(g.mm);
  d.mK = W(g.mK);
  d.rp = W(g.rp);
  d.Rpc = W(g.Rpc);
  d.Tpp = W(g.Tpp);
  d.Tip = W(g.Tip);
  return d;
}

// geodesic_P_int: the position integral from infinity to radius r; ppc is
// 1 past the (outer) turning point, else 0
template <typename T>
SIM5_NI T P_int(const Geod<T>& g, T r, int ppc) {
  const bool is_rr = g.gtype == kTypeRR, is_bh = g.gtype == kTypeRRBH;
  const bool is_rc = g.gtype == kTypeRC, is_cc = g.gtype == kTypeCC;
  const T one = T(1);
  T P = Nan<T>();
  if (is_rr || is_bh) {
    const T r1 = g.rr[0], r2 = g.rr[1];
    const T d13 = g.root_diff(0, 2), d14 = g.root_diff(0, 3);
    const T d23 = g.root_diff(1, 2), d24 = g.root_diff(1, 3);
    const T mm4 = (d23 * d14) / (d24 * d13);
    T arg;
    if (is_bh) {
      const T q = d13 / d23 * (r2 - r) / (r1 - r);
      arg = q > T(0) ? Sqrt(q) : T(0);
    } else {
      const T q = (d24 * (r - r1)) / (d14 * (r - r2));
      arg = q > T(0) ? Sqrt(q) : T(0);
    }
    const T arg4 = ClampMax(arg, one);
    const T c4 = T(2) / Sqrt(d13 * d24);
    const T rf1 = rf(one - arg4 * arg4, one - mm4 * arg4 * arg4, one);
    const T R = c4 * arg4 * rf1;
    P = g.Rpc + (ppc > 0 ? R : -R);
  } else if (is_rc) {
    const T t1 = g.rr[0], t2 = g.rr[1];
    T A, B, AmB, mm, mmc;
    rc_geometry(t1, t2, g.rr[2], Abs(g.ri[2]), A, B, AmB, mm, mmc);
    const T z = ((AmB * r + t1 * B - t2 * A) / ((A + B) * r - t1 * B - t2 * A));
    const T feps = T(8.0 * static_cast<double>(Prec<T>::eps()));
    const T az = Clamp(Abs(z), feps, one - feps);
    const T rf1 = rf(az * az, mmc + mm * az * az, one);
    const T icn1 = Sqrt(one - az * az) * rf1;
    const T R = (z >= T(0) ? icn1 : T(2) * elliptic_k_mc(mmc) - icn1) /
                Sqrt(A * B);
    P = g.Rpc - R;
  } else if (is_cc) {
    const CCMap<T> c = cc_map(g);
    const T z = (r - c.b1 + c.a1 * c.g1) / (c.a1 + c.b1 * c.g1 - c.g1 * r);
    const T w2 = z * z / (one + z * z);
    const T w2c = one / (one + z * z);
    const T rf1 = rf(w2c, c.mmc + c.mm * w2c, one);
    const T itn_abs = Sqrt(w2) * rf1;
    const T u = z >= T(0) ? itn_abs : T(2) * elliptic_k_mc(c.mmc) - itn_abs;
    P = g.Rpc - T(2) / (c.A + c.B) * u;
  }
  // the domain: from-infinity types at r >= rp, the bound band r3..r2
  if (is_bh ? (r > g.rp || r < g.rr[2]) : r < g.rp) P = Nan<T>();
  if (r == g.rp) P = g.Rpc;
  return P;
}

// _theta_inv: m(x) = sqrt(m2p) cn(x / mK | mm)
template <typename T>
SIM5_HD T theta_inv(const Geod<T>& g, T x) {
  T sn, cn, dn;
  sncndn_m(x / g.mK, g.mm, sn, cn, dn);
  return Sqrt(g.m2p) * cn;
}

// _theta_pol_vortical: m(P) and sign(dm/dP) of a vortical (q < 0) ray
template <typename T>
SIM5_HD void theta_pol_vortical(const Geod<T>& g, T P, T& m, T& dm_sign) {
  const T sign0 = g.beta >= T(0) ? T(1) : T(-1);
  const T hemi = g.cos_i >= T(0) ? T(1) : T(-1);
  T sn, cn, dn;
  sncndn_m((P - sign0 * g.Tip) / g.mK, g.mm, sn, cn, dn);
  m = hemi * Sqrt(g.m2p) * dn;
  dm_sign = -hemi * Sign(sn * cn);
}

// _fold_pol: sign(dm/dP) and P - T, T the last sign flip below P
template <typename T>
SIM5_HD void fold_pol(const Geod<T>& g, T P, T& sign_dm, T& dT) {
  const T sign0 = g.beta >= T(0) ? T(1) : T(-1);
  const T T0 = sign0 > T(0) ? -(g.Tpp - g.Tip) : -g.Tip;
  const T n = ClampMin(Ceil((P - T0) / g.Tpp) - T(1), T(0));
  const T Tn = T0 + n * g.Tpp;
  sign_dm = sign0 * (Rem2(n) == T(0) ? T(1) : T(-1));
  dT = P - Tn;
}

// geodesic_position_pol: m(P) = cos(theta)
template <typename T>
SIM5_NI T position_pol(const Geod<T>& g, T P) {
  if (!live(g.gtype) || !IsFinite(P)) return Nan<T>();
  if (g.q < T(0)) {
    T m, s;
    theta_pol_vortical(g, P, m, s);
    return m;
  }
  T sign_dm, dT;
  fold_pol(g, P, sign_dm, dT);
  return -sign_dm * theta_inv(g, dT);
}

// geodesic_dm_sign: sign(dm/dP) at P
template <typename T>
SIM5_HD T dm_sign(const Geod<T>& g, T P) {
  if (!live(g.gtype) || !IsFinite(P)) return Nan<T>();
  if (g.q < T(0)) {
    T m, s;
    theta_pol_vortical(g, P, m, s);
    return s;
  }
  T sign_dm, dT;
  fold_pol(g, P, sign_dm, dT);
  return sign_dm;
}

// photon_momentum: k^mu from (l, q) at (r, m), with _snap_tolerances
template <typename T>
SIM5_NI void photon_momentum(T a, T r, T m, T l, T q, T r_sign, T m_sign,
                             T k[4]) {
  const T a2 = a * a, l2 = l * l, r2 = r * r, m2 = m * m;
  const T S = r2 + a2 * m2;
  const T D = r2 - T(2) * r + a2;
  const T A = r2 + a2 - a * l;
  const T lma = l - a;
  T R = A * A - D * (lma * lma + q);
  T M = q - l2 * m2 / (T(1) - m2) + a2 * m2;
  T tol_R = T(1e-8), tol_M = T(1e-8);
  if (IsF32<T>::value) {
    // the f32 tolerances: 8 ulps of the largest term each sums
    const T e8 = T(8.0 * static_cast<double>(Prec<float>::eps()));
    tol_R = T(1e-8) + e8 * (A * A + Abs(D) * (lma * lma + Abs(q)));
    tol_M = T(1e-8) + e8 * (Abs(q) + l2 * m2 / (T(1) - m2) + a2 * m2);
  }
  R = (R < T(0) && R > -tol_R) ? T(0) : R;
  M = (M < T(0) && M > -tol_M) ? T(0) : M;
  const T nanv = (R < T(0) || M < T(0)) ? Nan<T>() : T(0);
  const T sqrtR = R > T(0) ? Sqrt(R) : T(0);
  const T sqrtM = M > T(0) ? Sqrt(M) : T(0);
  k[0] = (-a * (a * (T(1) - m2) - l) + (r2 + a2) / D * A) / S + nanv;
  k[1] = sqrtR / S * Sign(r_sign + T(0.5)) + nanv;
  k[2] = sqrtM / S * Sign(m_sign + T(0.5)) + nanv;
  k[3] = (-a + l / (T(1) - m2) + a / D * A) / S + nanv;
}

// geodesic_momentum: k at P (oriented along increasing P; k[2] signed by
// dm/dP)
template <typename T>
SIM5_HD void momentum(const Geod<T>& g, T P, T r, T m, T k[4]) {
  const T dm = dm_sign(g, P);
  const bool is_bh = g.gtype == kTypeRRBH;
  const T Pz = IsFinite(P) ? P : T(0);
  const T Pf = is_bh ? Pz - T(2) * g.Rpc * Floor(Pz / (T(2) * g.Rpc)) : Pz;
  const T rsign = (Pf < g.Rpc ? T(-1) : T(1)) * (is_bh ? T(-1) : T(1));
  photon_momentum(g.a, IsFinite(r) ? r : T(10), IsFinite(m) ? m : T(0), g.l,
                  g.q, rsign, IsFinite(dm) ? dm : T(1), k);
  if (!live(g.gtype) || !IsFinite(r) || !IsFinite(m))
    for (int i = 0; i < 4; ++i) k[i] = Nan<T>();
}

// ---------------------------------------------------------------------------
// the theta terms of the azimuth and the time (geodesic/analytic.py)
// ---------------------------------------------------------------------------

// _theta_fold: (n, dT) of the cumulative theta integrals
template <typename T>
SIM5_HD void theta_fold(const Geod<T>& g, T P, T& n, T& dT) {
  const T sign0 = g.beta >= T(0) ? T(1) : T(-1);
  const T T0 = sign0 > T(0) ? -(g.Tpp - g.Tip) : -g.Tip;
  n = ClampMin(Ceil((P - T0) / g.Tpp) - T(1), T(0));
  dT = P - T0 - n * g.Tpp;
}

// _vortical_fold of a q < 0 ray: (s, j, v, c2, b2, xv)
template <typename T>
struct VFold {
  T s, j, v, c2, b2, xv;
};
template <typename T>
SIM5_HD VFold<T> vortical_fold(const Geod<T>& g, T P) {
  VFold<T> f;
  f.c2 = -g.m2m;
  f.b2 = g.m2p;
  const T sign0 = g.beta >= T(0) ? T(1) : T(-1);
  const T Pu = P - sign0 * g.Tip;
  f.s = Sign(Pu);
  const T A = Abs(Pu);
  f.j = Floor(A / g.Tpp);
  f.v = A - f.j * g.Tpp;
  T sn, cn, dn;
  sncndn_m(f.v / g.mK, g.mm, sn, cn, dn);
  f.xv = Min(Max(Sqrt(f.b2) * dn, Sqrt(f.c2)), Sqrt(f.b2));
  return f;
}

// _theta_phi_cum(g, P2) - _theta_phi_cum(g, P1): the P-independent complete
// term once for both
template <typename T, typename D = FixedDepth>
SIM5_NI T theta_phi_diff(const Geod<T>& g, T P2, T P1) {
  const T one = T(1);
  const T la = g.l / g.a;
  if (g.q < T(0)) {
    const VFold<T> f2 = vortical_fold(g, P2), f1 = vortical_fold(g, P1);
    const T full = T(2) * integral_T_mp_dn<T, D>(f2.c2, f2.b2, one, Sqrt(f2.c2));
    T cum[2];
    const VFold<T>* fs[2] = {&f2, &f1};
    for (int i = 0; i < 2; ++i) {
      const VFold<T>& f = *fs[i];
      const T seg = integral_T_mp_dn<T, D>(f.c2, f.b2, one, f.xv);
      const T segv = f.v <= T(0.5) * g.Tpp ? seg : full - seg;
      cum[i] = la * f.s * (f.j * full + segv);
    }
    return cum[0] - cum[1];
  }
  const bool qpos = g.q > T(0);
  const T m2m = qpos ? g.m2m : one;
  const T m2p = qpos ? g.m2p : T(0.5);
  const T sq = Sqrt(m2p);
  // the complete Pi of the three integral_T_mp: once where D shares
  T pc = T(0);
  if (D::kShare)
    pc = elliptic_pi_complete<T, D>(m2p / (m2p - one), m2p / (m2m + m2p));
  const T* pi_c = D::kShare ? &pc : nullptr;
  const T full = integral_T_mp<T, D>(m2m, m2p, one, -sq, pi_c);
  const T Ps[2] = {P2, P1};
  T cum[2];
  for (int i = 0; i < 2; ++i) {
    T n, dT;
    theta_fold(g, Ps[i], n, dT);
    T sn, cn, dn;
    sncndn_m((qpos ? dT : T(0.5) * g.Tpp) / g.mK, g.mm, sn, cn, dn);
    const T x = Min(Max(sq * cn, -sq), sq);
    cum[i] = la * (n * full + integral_T_mp<T, D>(m2m, m2p, one, x, pi_c));
  }
  return cum[0] - cum[1];
}

// _theta_time_cum(g, P); full, if given, its P-independent integral (the
// vortical fold's full T_m2_dn period, or M20)
template <typename T, typename D = FixedDepth>
SIM5_NI T theta_time_cum(const Geod<T>& g, T P, const T* full = nullptr) {
  if (g.q < T(0)) {
    const VFold<T> f = vortical_fold(g, P);
    const T seg = integral_T_m2_dn<T, D>(f.c2, f.b2, f.xv);
    const T fl = full != nullptr
                     ? *full
                     : T(2) * integral_T_m2_dn<T, D>(f.c2, f.b2, Sqrt(f.c2));
    const T segv = f.v <= T(0.5) * g.Tpp ? seg : fl - seg;
    return g.a * f.s * (f.j * fl + segv);
  }
  const bool qpos = g.q > T(0);
  T n, dT;
  theta_fold(g, P, n, dT);
  const T m_abs = Abs(theta_inv(g, qpos ? dT : T(0.5) * g.Tpp));
  const T m2m = qpos ? g.m2m : T(1);
  const T m2p = qpos ? g.m2p : T(0.5);
  const T x = Min(m_abs, Sqrt(m2p));
  const T M2x = integral_T_m2<T, D>(m2m, m2p, x);
  const T M20 = full != nullptr ? *full : integral_T_m2<T, D>(m2m, m2p, T(0));
  const T seg = dT <= T(0.5) * g.Tpp ? M2x : T(2) * M20 - M2x;
  return g.a * (n * T(2) * M20 + seg);
}

// |_theta_time_cum(g, P2) - _theta_time_cum(g, P1)|, the P-independent
// integral once where D shares
template <typename T, typename D = FixedDepth>
SIM5_HD T theta_time_diff(const Geod<T>& g, T P2, T P1) {
  if (!D::kShare)
    return Abs(theta_time_cum<T, D>(g, P2) - theta_time_cum<T, D>(g, P1));
  T full;
  if (g.q < T(0)) {
    const T c2 = -g.m2m;
    full = T(2) * integral_T_m2_dn<T, D>(c2, g.m2p, Sqrt(c2));
  } else {
    const bool qpos = g.q > T(0);
    full = integral_T_m2<T, D>(qpos ? g.m2m : T(1), qpos ? g.m2p : T(0.5),
                               T(0));
  }
  return Abs(theta_time_cum<T, D>(g, P2, &full) -
             theta_time_cum<T, D>(g, P1, &full));
}

// ---------------------------------------------------------------------------
// CC (four complex roots) radial integrals by the end-refined Gauss rule
// ---------------------------------------------------------------------------

// The rule's 16 Gauss-Legendre nodes and weights on [-1, 1] and its 7 panel
// edges on [0, 1], computed on the host by the plain version's numpy
// (geodesic/analytic.py: _GL16_X, _GL16_W, _CC_PANELS) and passed to the
// kernels as an argument, so that both routes sum the same 96 nodes
struct GaussRule {
  double x[16], w[16], edges[7];
};

// _cc_setup: the CC map with the direct A - B (unlike cc_map)
template <typename T>
struct CCSetup {
  T b1, a1, b2, a2, A, B, g1, mm;
};
template <typename T>
SIM5_HD CCSetup<T> cc_setup(const Geod<T>& g) {
  CCSetup<T> c;
  c.b1 = g.rr[0];
  c.a1 = Abs(g.ri[0]);
  c.b2 = g.rr[2];
  c.a2 = Abs(g.ri[2]);
  const T db = c.b1 - c.b2, sp = c.a1 + c.a2, sm = c.a1 - c.a2;
  c.A = Sqrt(db * db + sp * sp);
  c.B = Sqrt(db * db + sm * sm);
  const T AmB = c.A - c.B, ApB = c.A + c.B;
  const T g1num = ClampMin(T(4) * c.a1 * c.a1 - AmB * AmB, T(1e-30));
  const T g1den = ClampMin(ApB * ApB - T(4) * c.a1 * c.a1, T(1e-30));
  c.g1 = Sqrt(g1num / g1den);
  c.mm = T(4) * c.A * c.B / (ApB * ApB);
  return c;
}

// _cc_r_of_u
template <typename T>
SIM5_HD T cc_r_of_u(const CCSetup<T>& c, T u) {
  T sn, cn, dn;
  sncndn_m(u, c.mm, sn, cn, dn);
  cn = Abs(cn) > T(1e-30) ? cn : (cn >= T(0) ? T(1e-30) : T(-1e-30));
  const T z = sn / cn;
  return (z * (c.a1 + c.b1 * c.g1) + (c.b1 - c.a1 * c.g1)) / (T(1) + c.g1 * z);
}

// _cc_u_of_P
template <typename T>
SIM5_HD T cc_u_of_P(const Geod<T>& g, const CCSetup<T>& c, T P) {
  return (g.Rpc - P) * T(0.5) * (c.A + c.B);
}

// _horizon_poles: a^2, the outer and inner horizons, sqrt(1 - a^2)
template <typename T>
struct Poles {
  T a2, rph, rmh, sq;
};
template <typename T>
SIM5_HD Poles<T> horizon_poles(T a) {
  Poles<T> h;
  h.a2 = a * a;
  h.sq = Sqrt(T(1) - h.a2);
  h.rph = T(1) + h.sq;
  h.rmh = T(1) - h.sq;
  return h;
}

// the rule's node k of 96 on [lo, hi] (_cc_quad): u and its weight
template <typename T>
SIM5_HD void cc_node(const GaussRule& q, T lo, T hi, int k, T& u, T& w) {
  const int p = k / 16, i = k % 16;
  const T L = hi - lo;
  const T ea = lo + L * T(q.edges[p]), eb = lo + L * T(q.edges[p + 1]);
  const T mid = T(0.5) * (ea + eb), half = T(0.5) * (eb - ea);
  u = mid + half * T(q.x[i]);
  w = half * T(q.w[i]) * T(1);
}

// _cc_phi_radial: the cumulative radial phi term from infinity to P
template <typename T>
SIM5_NI T cc_phi_radial(const Geod<T>& g, const CCSetup<T>& c, T P,
                        const GaussRule& q) {
  const Poles<T> h = horizon_poles(g.a);
  const T u_pt = cc_u_of_P(g, c, IsFinite(P) ? P : T(0.5) * g.Rpc);
  const T u_inf = cc_u_of_P(g, c, T(0));
  const T lo = Min(u_pt, u_inf);
  const T cp = (g.a * h.rph - g.l * h.a2 / T(2)) / h.sq;
  const T cm = (g.a * h.rmh - g.l * h.a2 / T(2)) / h.sq;
  T sum = T(0);
  for (int k = 0; k < 96; ++k) {
    T u, w;
    cc_node(q, lo, u_inf, k, u, w);
    const T r = cc_r_of_u(c, u);
    sum = sum + (cp / (r - h.rph) - cm / (r - h.rmh)) * w;
  }
  return (T(2) / (c.A + c.B)) * sum;
}

// _cc_time_radial: the radial travel time between P1 and P2, the far
// field's r + 2 ln r exact and the rule on the bounded rest
template <typename T>
SIM5_NI T cc_time_radial(const Geod<T>& g, const CCSetup<T>& c, T P1, T P2,
                         const GaussRule& q) {
  const Poles<T> h = horizon_poles(g.a);
  const T Ac = (-g.a * g.l + T(4)) * h.rph - T(2) * h.a2;
  const T Bc = (g.a * g.l - T(4)) * h.rmh + T(2) * h.a2;
  const T u1 = cc_u_of_P(g, c, P1), u2 = cc_u_of_P(g, c, P2);
  const T lo = Min(u1, u2), hi = Max(u1, u2);
  const T c1r = c.b1 * c.b1 + c.a1 * c.a1;
  const T c2r = c.b2 * c.b2 + c.a2 * c.a2;
  const T q1 = T(-2) * (c.b1 + c.b2);
  const T q2 = c1r + c2r + T(4) * c.b1 * c.b2;
  const T q3 = T(-2) * (c.b1 * c2r + c.b2 * c1r);
  const T q4 = c1r * c2r;
  T sum = T(0);
  for (int k = 0; k < 96; ++k) {
    T u, w;
    cc_node(q, lo, hi, k, u, w);
    const T r = cc_r_of_u(c, u);
    const T s = T(1) / r;
    const T Q1 = T(1) + s * (T(-2) * c.b1 + s * c1r);
    const T Q2 = T(1) + s * (T(-2) * c.b2 + s * c2r);
    const T S = Sqrt(ClampMin(Q1 * Q2, Prec<T>::tiny()));
    const T poly = q1 / s + q2 + s * (q3 + s * q4);
    const T W = T(4) + (Ac / (r - h.rph) + Bc / (r - h.rmh)) / h.sq -
                (T(1) + T(2) * s) * poly / (T(1) + S);
    sum = sum + W * w;
  }
  const T quad = (T(2) / (c.A + c.B)) * sum;
  const T r_lo = cc_r_of_u(c, hi), r_hi = cc_r_of_u(c, lo);
  const T r_a = ClampMin(Min(r_lo, r_hi), T(1e-6));
  const T r_b = Max(r_lo, r_hi);
  return Abs(quad) + ((r_b - r_a) + T(2) * Log(r_b / r_a));
}

// ---------------------------------------------------------------------------
// the azimuth and the travel time (geodesic/analytic.py), in double (T is
// double in the kernels)
// ---------------------------------------------------------------------------

// the radial term of geodesic_position_azm at a finite P: the azimuth
// change of the lane's trajectory type between (r, m) at P and the anchor
// (infinity; the apastron passage P = Rpc for bound RR_BH rays)
template <typename T, typename D = FixedDepth>
SIM5_NI T azm_radial(const Geod<T>& g, T r, T P, const GaussRule& q) {
  const bool is_rr = g.gtype == kTypeRR, is_rc = g.gtype == kTypeRC;
  const bool is_bh = g.gtype == kTypeRRBH, is_cc = g.gtype == kTypeCC;
  const Poles<T> h = horizon_poles(g.a);
  const bool ppc = g.nrr > 0 && P > g.Rpc;
  const T cp = (g.a * h.rph - g.l * h.a2 / T(2)) / h.sq;
  const T cm = (g.a * h.rmh - g.l * h.a2 / T(2)) / h.sq;
  T phi = Nan<T>();
  if (is_rr) {
    const T r1 = g.rr[0], r2 = g.rr[1], r3 = g.rr[2], r4 = g.rr[3];
    const T rs = r >= r1 ? r : T(10);
    const T sgn = ppc ? T(1) : T(-1);
    // integral_R_rp_re_inf and integral_R_rp_re at each horizon pole, their
    // shared values once where D shares
    T inf[2], at[2];
    if constexpr (D::kShare) {
      rp_re_pair<T, D>(r1, r2, r3, r4, h.rph, h.rmh,
                       Sqrt((r2 - r4) / (r1 - r4)), inf);
      rp_re_pair<T, D>(r1, r2, r3, r4, h.rph, h.rmh, re_sn(r1, r2, r4, rs),
                       at);
    } else {
      inf[0] = integral_R_rp_re_inf<T, D>(r1, r2, r3, r4, h.rph);
      at[0] = integral_R_rp_re<T, D>(r1, r2, r3, r4, h.rph, rs);
      inf[1] = integral_R_rp_re_inf<T, D>(r1, r2, r3, r4, h.rmh);
      at[1] = integral_R_rp_re<T, D>(r1, r2, r3, r4, h.rmh, rs);
    }
    const T A = inf[0] + sgn * at[0];
    const T B = inf[1] + sgn * at[1];
    phi = A * cp - B * cm;
  } else if (is_rc) {
    const T t1 = g.rr[0], t2 = g.rr[1], tu = g.rr[2], tv = Abs(g.ri[2]);
    const T rs = r >= t1 ? r : T(10);
    phi = integral_R_rp_cc2_inf<T, D>(t1, t2, tu, tv, h.rph, rs) * cp -
          integral_R_rp_cc2_inf<T, D>(t1, t2, tu, tv, h.rmh, rs) * cm;
  } else if (is_bh) {
    // cumulative from the apastron passage, folded over the 2 Rpc period
    const T b1 = g.rr[0], b2 = g.rr[1], b3 = g.rr[2], b4 = g.rr[3];
    const T k_cyc = Floor(P / (T(2) * g.Rpc));
    const T Pf = P - T(2) * g.Rpc * k_cyc;
    const T y = Min(Max(IsFinite(r) ? r : T(5), b3 + T(1e-14)), b2);
    const Band<T> by = band_setup<T, D>(b1, b2, b3, b4, y);
    const T J_y = band_rp<T, D>(by, h.rph) * cp - band_rp<T, D>(by, h.rmh) * cm;
    T Jc = T(0);
    if (k_cyc != T(0)) {
      const Band<T> bc = band_setup<T, D>(b1, b2, b3, b4, b3 + T(1e-14));
      Jc = band_rp<T, D>(bc, h.rph) * cp - band_rp<T, D>(bc, h.rmh) * cm;
    }
    phi = T(2) * k_cyc * Jc + (Pf <= g.Rpc ? -J_y : J_y);
  } else if (is_cc) {
    phi = cc_phi_radial(g, cc_setup(g), P, q);
  }
  return phi;
}

// the anchor of the theta term: P = 0, the apastron passage for RR_BH
template <typename T>
SIM5_HD T theta_anchor(const Geod<T>& g) {
  return g.gtype == kTypeRRBH ? g.Rpc : T(0);
}

// geodesic_position_azm: the radial term and the theta term
template <typename T, typename D = FixedDepth>
SIM5_HD T position_azm(const Geod<T>& g, T r, T P, const GaussRule& q) {
  if (!IsFinite(P)) return Nan<T>();
  const T phi = azm_radial<T, D>(g, r, P, q);
  return phi + theta_phi_diff<T, D>(g, P, theta_anchor(g));
}

// t_band_J: the bound band's time from y to r2, on the band's map at y
template <typename T, typename D = FixedDepth>
SIM5_NI T band_time(const Band<T>& b, const Poles<T>& h, T A, T B) {
  return T(4) * band_r0(b) + T(2) * band_r1<T, D>(b) + band_r2<T, D>(b) +
         (A * band_rp<T, D>(b, h.rph) + B * band_rp<T, D>(b, h.rmh)) / h.sq;
}

// t_band_cum: the band's cumulative time at (P, rc) from the apastron
// passage, folded over the 2 Rpc period
template <typename T, typename D = FixedDepth>
SIM5_NI T band_time_cum(const Geod<T>& g, const Poles<T>& h, T A, T B, T P,
                        T rc) {
  const T b1 = g.rr[0], b2 = g.rr[1], b3 = g.rr[2], b4 = g.rr[3];
  const T Pz = IsFinite(P) ? P : g.Rpc;
  const T k_cyc = Floor(Pz / (T(2) * g.Rpc));
  const T Pf = Pz - T(2) * g.Rpc * k_cyc;
  const T y = Min(Max(IsFinite(rc) ? rc : T(5), b3 + T(1e-14)), b2);
  const T Jy = band_time<T, D>(band_setup<T, D>(b1, b2, b3, b4, y), h, A, B);
  T Jc = T(0);
  if (k_cyc != T(0))
    Jc = band_time<T, D>(band_setup<T, D>(b1, b2, b3, b4, b3 + T(1e-14)), h,
                         A, B);
  return T(2) * k_cyc * Jc + (Pf <= g.Rpc ? -Jy : Jy);
}

// geodesic_timedelay: the radial travel time between P1 (at r1c) and P2
// (at r2c)
template <typename T, typename D = FixedDepth>
SIM5_NI T timedelay(const Geod<T>& g, T P1, T r1c, T P2, T r2c,
                    const GaussRule& q) {
  if (!IsFinite(P1) || !IsFinite(P2)) return Nan<T>();
  const bool swap = P1 > P2;
  const T P1s = swap ? P2 : P1, P2s = swap ? P1 : P2;
  const T x1 = swap ? r2c : r1c, x2 = swap ? r1c : r2c;
  const Poles<T> h = horizon_poles(g.a);
  const T A = (-g.a * g.l + T(4)) * h.rph - T(2) * h.a2;
  const T B = (g.a * g.l - T(4)) * h.rmh + T(2) * h.a2;
  if (g.gtype == kTypeRR) {
    const T ra = g.rr[0], rb = g.rr[1], rc_ = g.rr[2], rd_ = g.rr[3];
    const T x1s = x1 >= ra ? x1 : T(10), x2s = x2 >= ra ? x2 : T(12);
    const T s = ((P1s > g.Rpc && P2s < g.Rpc) || (P1s < g.Rpc && P2s > g.Rpc))
                    ? T(1)
                    : T(-1);
    // integral_R_r0_re, _r1_re, _r2_re and _rp_re at each pole, at x1s
    // and x2s, their shared values once where D shares
    T t1[5], t2[5];
    const T xs[2] = {x1s, x2s};
    T* ts[2] = {t1, t2};
    for (int j = 0; j < 2; ++j) {
      if constexpr (D::kShare) {
        rr_time_terms<T, D>(ra, rb, rc_, rd_, h.rph, h.rmh, xs[j], ts[j]);
      } else {
        ts[j][0] = integral_R_r0_re<T, D>(ra, rb, rc_, rd_, xs[j]);
        ts[j][1] = integral_R_r1_re<T, D>(ra, rb, rc_, rd_, xs[j]);
        ts[j][2] = integral_R_r2_re<T, D>(ra, rb, rc_, rd_, xs[j]);
        ts[j][3] = integral_R_rp_re<T, D>(ra, rb, rc_, rd_, h.rph, xs[j]);
        ts[j][4] = integral_R_rp_re<T, D>(ra, rb, rc_, rd_, h.rmh, xs[j]);
      }
    }
    const T R0 = t1[0] + s * t2[0];
    const T R1 = t1[1] + s * t2[1];
    const T R2 = t1[2] + s * t2[2];
    const T RA = t1[3] + s * t2[3];
    const T RB = t1[4] + s * t2[4];
    return T(4) * Abs(R0) + T(2) * Abs(R1) + Abs(R2) +
           (A * Abs(RA) + B * Abs(RB)) / h.sq;
  }
  if (g.gtype == kTypeRC) {
    const T ta = g.rr[0], tb = g.rr[1], tu = g.rr[2], tv = Abs(g.ri[2]);
    const T lo = Min(x1, x2), hi = Max(x1, x2);
    const T R0 = integral_R_r0_cc<T, D>(ta, tb, tu, tv, lo) -
                 integral_R_r0_cc<T, D>(ta, tb, tu, tv, hi);
    const T R1 = integral_R_r1_cc<T, D>(ta, tb, tu, tv, lo, hi);
    const T R2 = integral_R_r2_cc<T, D>(ta, tb, tu, tv, lo, hi);
    const T RA = integral_R_rp_cc2<T, D>(ta, tb, tu, tv, h.rph, lo, hi);
    const T RB = integral_R_rp_cc2<T, D>(ta, tb, tu, tv, h.rmh, lo, hi);
    return T(4) * Abs(R0) + T(2) * Abs(R1) + Abs(R2) +
           (A * Abs(RA) + B * Abs(RB)) / h.sq;
  }
  if (g.gtype == kTypeRRBH)
    return Abs(band_time_cum<T, D>(g, h, A, B, P2s, x2) -
               band_time_cum<T, D>(g, h, A, B, P1s, x1));
  if (g.gtype == kTypeCC) return cc_time_radial(g, cc_setup(g), P1s, P2s, q);
  return Nan<T>();
}

// geodesic_timedelay_full: the radial time and the poloidal term
template <typename T, typename D = FixedDepth>
SIM5_HD T timedelay_full(const Geod<T>& g, T P1, T r1c, T P2, T r2c,
                         const GaussRule& q) {
  const T t_rad = timedelay<T, D>(g, P1, r1c, P2, r2c, q);
  return t_rad + theta_time_diff<T, D>(g, P2, P1);
}

// ---------------------------------------------------------------------------
// the pixels (render/lightcurve.py)
// ---------------------------------------------------------------------------

// image_grid's impact parameter of pixel i of n, [0, 0] at the centre
template <typename T>
SIM5_HD T grid_coord(int i, int n, T rmax) {
  return ((T(i) + T(0.5)) / T(n) - T(0.5)) * T(2) * rmax;
}

// the far-field sphere the crossing map's delays are anchored at (R_FAR)
constexpr double kRFar = 1e4;

// The work lists' bins and the counted instances' stages.  A lane's bin is
// its trajectory type's (other types, which give no hit, with RR), the
// vortical (q < 0) lanes of a type in a bin of their own after it; CC,
// whose Gauss rule is the longest branch, last.  A list of several parts
// of each lane's work (the crossing map's delay, then its azimuth) holds
// kWorkBins bins a part, at most kMaxBins in all.
enum : int { kBinRR, kBinRRBH, kBinRC, kBinCC, kTypeBins };
constexpr int kWorkBins = 2 * kTypeBins;
constexpr int kMaxBins = 2 * kWorkBins;

SIM5_HD int type_bin(int gtype) {
  return gtype == kTypeRRBH ? kBinRRBH
         : gtype == kTypeRC ? kBinRC
         : gtype == kTypeCC ? kBinCC
                            : kBinRR;
}

template <typename T>
SIM5_HD int work_bin(const Geod<T>& g) {
  return 2 * type_bin(g.gtype) + (g.q < T(0) ? 1 : 0);
}

// the stages a counted instance times: the geometry (init_inf, the crossing
// or P_int, the inversions; the seed's momentum; the crossing map's
// gfactorK and ISCO test), the travel time's far end (P_int(R_FAR) and the
// inversion there), the azimuth's radial term by type bin, its theta term,
// and the delay (radial and poloidal) by type bin
enum Stage : int {
  kStageGeometry,
  kStageFar,
  kStageAzm,                            // + type bin
  kStageTheta = kStageAzm + kTypeBins,
  kStageTime,                           // + type bin
  kStages = kStageTime + kTypeBins
};

// a stage probe that counts nothing.  A counted instance's probe is called
// by every lane of the warp at each point: begin() before a stage, end(s,
// p) after it with whether the lane ran it.
struct NoStage {
  SIM5_HD void begin() {}
  SIM5_HD void end(int, bool) {}
};

// The geometry of pixel (ix, iy) of an n x n crossing map of image order
// `order` (render/lightcurve.py:_crossing_map_unanchored): its geodesic g,
// the crossing's P, its radius r_s (10 where there is none) and the
// Keplerian g-factor gf; returns the hit.
template <typename T>
SIM5_HD bool crossing_geometry(T a, T incl, T cos_i, T sin_i, T rmax, T rms,
                               int order, int ix, int iy, int n, Geod<T>& g,
                               T& P, T& r_s, T& gf) {
  NoProbe probe;
  const T alpha = grid_coord(ix, n, rmax);
  const T beta = grid_coord(iy, n, rmax);
  g = init_inf(incl, cos_i, sin_i, a, alpha, beta, probe);
  P = find_midplane_crossing(g, order);
  const T r = position_rad(g, P);
  bool hit = IsFinite(r) && g.status == kOk;
  r_s = hit ? r : T(10);
  gf = gfactorK(r_s, a, g.l);
  return hit && IsFinite(gf) && r_s > rms;
}

// the azimuth of a hit at (r, P) on g (position_azm), stage by stage: the
// radial term of each type bin at a call site of its own, then the theta
// term; NaN where P is not finite.  `live`: whether the lane computes (a
// lane that does not only calls the probes).
template <typename T, typename D, typename S>
SIM5_HD T azimuth_staged(bool live, const Geod<T>& g, T r, T P,
                         const GaussRule& q, S& st) {
  const bool fin = live && IsFinite(P);
  const int bin = type_bin(g.gtype);
  T phi = Nan<T>();
  for (int t = 0; t < kTypeBins; ++t) {
    st.begin();
    if (fin && bin == t) phi = azm_radial<T, D>(g, r, P, q);
    st.end(kStageAzm + t, fin && bin == t);
  }
  st.begin();
  if (fin) phi = phi + theta_phi_diff<T, D>(g, P, theta_anchor(g));
  st.end(kStageTheta, fin);
  return phi;
}

// The azimuth of a hit of the crossing map (its geometry g, P and r_s
// from crossing_geometry), as _crossing_map_unanchored computes it; 0
// where it is not finite.  A lane that is not `live` only calls the probes.
template <typename T, typename D = FixedDepth, typename S = NoStage>
SIM5_HD T crossing_azimuth(bool live, const Geod<T>& g, T P, T r_s,
                           const GaussRule& q, S& st) {
  const T phi = azimuth_staged<T, D>(live, g, r_s, P, q, st);
  return IsFinite(phi) ? phi : T(0);
}

// The delay of a hit of the crossing map (pixel (ix, iy), its geometry g,
// P and r_s) before its anchoring, as _crossing_map_unanchored computes it:
// the travel time to the crossing from the sphere R_FAR plus the plane
// wavefront's b^2 / (2 R_FAR); 0 where it is not finite.  A lane that is
// not `live` only calls the probes.
template <typename T, typename D = FixedDepth, typename S = NoStage>
SIM5_HD T crossing_delay(bool live, const Geod<T>& g, T P, T r_s, int ix,
                         int iy, int n, T rmax, const GaussRule& q, S& st) {
  T P_far = T(0), r_far = T(0);
  st.begin();
  if (live) {
    P_far = P_int(g, T(kRFar), 0);
    P_far = IsFinite(P_far) ? P_far : T(1e-4);
    r_far = position_rad(g, P_far);
  }
  st.end(kStageFar, live);
  const int bin = type_bin(g.gtype);
  T dt = Nan<T>();
  for (int t = 0; t < kTypeBins; ++t) {
    st.begin();
    if (live && bin == t)
      dt = timedelay_full<T, D>(g, P, r_s, P_far, r_far, q);
    st.end(kStageTime + t, live && bin == t);
  }
  const T alpha = grid_coord(ix, n, rmax);
  const T beta = grid_coord(iy, n, rmax);
  dt = dt + (alpha * alpha + beta * beta) / (T(2) * T(kRFar));
  return IsFinite(dt) ? dt : T(0);
}

// both of a hit: crossing_azimuth and crossing_delay
template <typename T, typename D = FixedDepth, typename S = NoStage>
SIM5_HD void crossing_hit(bool live, const Geod<T>& g, T P, T r_s, int ix,
                          int iy, int n, T rmax, const GaussRule& q,
                          T& phi_out, T& dt_out, S& st) {
  phi_out = crossing_azimuth<T, D>(live, g, P, r_s, q, st);
  dt_out = crossing_delay<T, D>(live, g, P, r_s, ix, iy, n, rmax, q, st);
}

// One pixel (ix, iy) of an n x n crossing map of image order `order`
// (render/lightcurve.py:_crossing_map_unanchored), T double in the kernel:
// the crossing's radius r, azimuth phi, Keplerian g-factor g, the delay
// before its anchoring and the hit; crossing_geometry, then crossing_hit on
// a hit.  a is the spin as given, rms the ISCO r_ms(a).  A pixel that is
// no hit gets phi = 0, g = 1 and delay = 0 (r = 10 where there is no
// crossing) and computes no azimuth or delay.
template <typename T, typename D = FixedDepth, typename S = NoStage>
SIM5_HD void crossing_pixel(T a, T incl, T cos_i, T sin_i, T rmax, T rms,
                            int order, int ix, int iy, int n,
                            const GaussRule& q, T& r_out, T& phi_out,
                            T& g_out, T& dt_out, bool& hit_out, S& st) {
  Geod<T> g;
  T P, r_s, gf;
  st.begin();
  const bool hit = crossing_geometry(a, incl, cos_i, sin_i, rmax, rms, order,
                                     ix, iy, n, g, P, r_s, gf);
  st.end(kStageGeometry, true);
  T phi = T(0), dt = T(0);
  crossing_hit<T, D>(hit, g, P, r_s, ix, iy, n, rmax, q, phi, dt, st);
  r_out = r_s;
  phi_out = hit ? phi : T(0);
  g_out = hit ? gf : T(1);
  dt_out = hit ? dt : T(0);
  hit_out = hit;
}
template <typename T, typename D = FixedDepth>
SIM5_HD void crossing_pixel(T a, T incl, T cos_i, T sin_i, T rmax, T rms,
                            int order, int ix, int iy, int n,
                            const GaussRule& q, T& r_out, T& phi_out,
                            T& g_out, T& dt_out, bool& hit_out) {
  NoStage st;
  crossing_pixel<T, D>(a, incl, cos_i, sin_i, rmax, rms, order, ix, iy, n, q,
                       r_out, phi_out, g_out, dt_out, hit_out, st);
}

// the dummy ray of an invalid seed pixel: (t0, r_start, 0, 0), k = (1, -1,
// 0, 0)
template <typename T>
SIM5_HD void seed_dummy(T r_start, T t0, T* x0, T* k) {
  x0[0] = t0;
  x0[1] = r_start;
  x0[2] = T(0);
  x0[3] = T(0);
  k[0] = T(1);
  k[1] = T(-1);
  k[2] = T(0);
  k[3] = T(0);
}

// The geometry of pixel (ix, iy) of an n x n volume seed on the sphere r =
// r_start (_volume_seed_reference), in T: its geodesic g, P0 and (x0, k)
// with phi0 = 0; returns whether the pixel is valid but for its azimuth
// (an invalid pixel gets the dummy ray).
template <typename T>
SIM5_HD bool seed_geometry(T a, T incl, T cos_i, T sin_i, T rmax, T r_start,
                           T t0, int ix, int iy, int n, Geod<T>& g, T& P0s,
                           T* x0, T* k) {
  NoProbe probe;
  const T alpha = grid_coord(ix, n, rmax);
  const T beta = grid_coord(iy, n, rmax);
  g = init_inf(incl, cos_i, sin_i, a, alpha, beta, probe);
  const T P0 = P_int(g, r_start, 0);
  bool ok = g.status == kOk && IsFinite(P0);
  P0s = ok ? P0 : T(1e-3);
  const T r0 = position_rad(g, P0s);
  const T m0 = position_pol(g, P0s);
  ok = ok && IsFinite(r0) && IsFinite(m0);
  if (!ok) {
    seed_dummy(r_start, t0, x0, k);
    return false;
  }
  momentum(g, P0s, r0, m0, k);
  k[2] = -k[2];   // k^theta of the march is -dm/dP's sign
  x0[0] = t0;
  x0[1] = r0;
  x0[2] = m0;
  x0[3] = T(0);
  return true;
}

// The azimuth phi0 of a valid seed pixel (seed_geometry's g, P0s and r0 =
// x0[1]): position_azm in double (_as_f64), rounded to T once, stage by
// stage; where it is not finite the pixel becomes invalid and gets the
// dummy ray.  Returns the pixel's validity.  A lane that is not `live`
// only calls the probes.
template <typename T, typename D = FixedDepth, typename S = NoStage>
SIM5_HD bool seed_azimuth(bool live, const Geod<T>& g, T P0s, T r_start,
                          const GaussRule& q, T* x0, T* k, S& st) {
  using W = typename Wide<T>::type;
  const Geod<W> gw = widen_geod<W>(g);
  const T phi0 = T(azimuth_staged<W, D>(live, gw, W(x0[1]), W(P0s), q, st));
  if (!live) return false;
  if (!IsFinite(phi0)) {
    seed_dummy(r_start, x0[0], x0, k);
    return false;
  }
  x0[3] = phi0;
  return true;
}

// One pixel (ix, iy) of an n x n volume seed on the sphere r = r_start
// (_volume_seed_reference), geometry in T: x0 = (t0, r0, m0, phi0), the
// march's k (k^theta signed as the integrator takes it) and ok;
// seed_geometry, then with kAzm seed_azimuth (phi0 the azimuth in double
// rounded to T once); without, phi0 = 0 (the axisymmetric seed).  An
// invalid pixel gets the dummy ray (r_start, 0, 0) with k = (1, -1, 0, 0).
template <typename T, bool kAzm, typename D = FixedDepth,
          typename S = NoStage>
SIM5_HD void seed_pixel(T a, T incl, T cos_i, T sin_i, T rmax, T r_start, T t0,
                        int ix, int iy, int n, const GaussRule& q, T* x0, T* k,
                        bool& ok_out, S& st) {
  Geod<T> g;
  T P0s;
  st.begin();
  bool ok = seed_geometry(a, incl, cos_i, sin_i, rmax, r_start, t0, ix, iy, n,
                          g, P0s, x0, k);
  st.end(kStageGeometry, true);
  if (kAzm) ok = seed_azimuth<T, D>(ok, g, P0s, r_start, q, x0, k, st);
  ok_out = ok;
}
template <typename T, bool kAzm, typename D = FixedDepth>
SIM5_HD void seed_pixel(T a, T incl, T cos_i, T sin_i, T rmax, T r_start, T t0,
                        int ix, int iy, int n, const GaussRule& q, T* x0, T* k,
                        bool& ok_out) {
  NoStage st;
  seed_pixel<T, kAzm, D>(a, incl, cos_i, sin_i, rmax, r_start, t0, ix, iy, n,
                         q, x0, k, ok_out, st);
}

}  // namespace sim5
