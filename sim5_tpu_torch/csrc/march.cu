// Stepwise Kerr / Minkowski ray march, one thread per ray, run in segments
// with the live rays compacted between them.
//
// Replaces the Pallas TPU kernel sim5_tpu/march/pallas_march.py
// (_make_kernel / _march_pallas) in all its variants: GR or flat, with or
// without polarization transport, and with no radiative transfer, with
// emission (I += j dl) or with emission and absorption
// (I += j e^{-tau} s_eff, tau += alpha dl), all on accepted steps.  The
// Pallas kernel calls the user's jnp emissivity and absorption; a CUDA
// kernel cannot call Python, so j and alpha come from one compiled-in
// family (sim5_tpu_torch/march/emission.py:GaussianSource) whose
// parameters are kernel arguments.
//
// What bounds it: FP32 ALU work, issue slots lost to idle lanes, and
// register pressure.  A trial step is four connection evaluations (<= 20
// Christoffel components each, contracted inline) and one metric
// evaluation; a ray's whole state and all RK4 stages stay in registers.
// The transfer variants add two register floats (I, tau) and, on each
// accepted step, one model evaluation (j) or two (j, alpha).
//
// Schedule.  A warp issues every instruction until its last live ray
// stops, and rays stop after very different trip counts.  So the march is
// ceil(max_steps / kSegTrips) launches of one kernel: launch k marches each
// ray of a dense list for at most kSegTrips trips, writes the rays that
// stopped (inactive, or steps == max_steps) to their original index, and
// appends each live ray's full state and index to the next list (a ballot
// and one atomicAdd per warp; the lanes take consecutive slots).  Every
// ray still live after launch k has made exactly (k + 1) kSegTrips trips,
// so the last launch writes out every ray.  Each launch reads its live
// count from device memory and whole warps past it return at once: the
// host never waits between segments.  Rays inactive on entry are written
// by the first launch and never enter a list.  The kernel allocates
// nothing; the caller gives it the two ping-pong lists and the counters.
//
// The one-launch schedule of the first version (every ray to its end in
// one launch) is the same kernel with seg = -1 and no trip limit.  It is
// kept only to time the two schedules against each other.  Both run the
// one trial step function below, so a ray's arithmetic does not depend on
// the schedule or on where the ray sits in a list: the results are
// bitwise those of the one-launch schedule, whatever the append order.
//
// Counters, summed over the march (stats[0], stats[1]): lane-trips, the
// live lanes of a warp on each of its trips, and warp-trips, the trips a
// warp issues.  Lane use is lane-trips / (32 warp-trips); lane-trips
// equals the sum of the rays' steps.  stats[2 + k] counts the rays that
// launch k appended (0 after the last).
//
// Semantics follow the Pallas body step for step: each ray loops while it
// is active and steps < max_steps, which is the per-ray meaning of the
// Pallas `cond` (inactive lanes never change there), and steps counts the
// trials made while active.  Layout: structure of arrays, component c of
// ray i at [c * n + i], so loads and stores are coalesced.  x[2] is theta.
//
// Built without fast math: cosf, sqrtf, expf and division are the
// IEEE-accurate forms (no __expf: fast-math intrinsics cost the image
// gate before).  A trial carries m = cos(theta) over from the error check
// of the last accepted trial (exact: it is cosf of the same float), and
// it shares reciprocals (1/S^3 as (1/S)^3, 1/a, the error metric's 1/S,
// dl / 6 and the floor's 1e-3 / eps0 as products), which changes the
// rounding, not the algorithm.  nvcc contracts a*b+c into FMAs, so single
// adaptive-step decisions can flip against the plain torch version; the
// tests allow for that.

#include <cuda_runtime.h>

namespace {

// Compile-time choices, measured on the two main paths (PERF.md §6).
constexpr int kThreads = 128;
constexpr int kSegTrips = 128;
constexpr float kTiny = 1e-30f;

// Blocks of kThreads that each instance asks to keep resident on an SM
// (__launch_bounds__' second argument; 1 leaves the registers free).  The
// GR instances without polarization, on the main paths, ask for 8: 64
// registers and ~100 bytes of spills, but 8 blocks an SM instead of 5.
// The others keep 1.
template <bool GR, bool POL, int RT>
constexpr int min_blocks() {
  return GR && !POL ? 8 : 1;
}

// A ray's state in a list: kListFloats floats at [c * n + slot] (x 0-3,
// k 4-7, f 8-11, kt, err, eps, I, tau), then steps and the ray's index in
// the int part at [0 * n + slot] and [1 * n + slot].
constexpr int kListFloats = 17;
constexpr int kX = 0, kK = 4, kF = 8, kKt = 12, kErr = 13, kEps = 14,
              kI = 15, kTau = 16;

// NaN-propagating min / max, as jnp.minimum / torch.minimum (fminf and
// fmaxf would drop the NaN and hide a bad trial).
__device__ __forceinline__ float nan_min(float x, float y) {
  return (x < y || x != x) ? x : y;
}
__device__ __forceinline__ float nan_max(float x, float y) {
  return (x > y || x != x) ? x : y;
}

// One model of the GaussianSource family (emission.py), by value:
// j = amp exp(-[((rho - center) inv_w)^2 + (r m inv_h)^2
//               + ((t - t_c) inv_d)^2] / 2),  rho = r or r sqrt(1 - m^2).
struct Gauss {
  float amp, center, inv_w, inv_h, t_c, inv_d;
  int cyl;
};

// The march's scalars; inv_a and floor_scale (1e-3 / eps0) are the shared
// reciprocals, computed once by the launcher.
struct Params {
  float a, inv_a, eps0, floor_scale, r_min, r_max, error_stop, error_gate,
      max_step_dl;
  int max_steps;
  Gauss jm, am;
};

// The march's inputs and outputs, (4, n) or (n,) structure of arrays.
struct Buffers {
  const float *x, *k, *f, *kt;
  const unsigned char* act;
  float *xo, *ko, *fo, *kto, *erro;
  int* stepso;
  unsigned char* acto;
  float* Io;
};

// A ray's carried state: what the Pallas body carries, and m = cos(x[2]).
struct Ray {
  float x[4], k[4], f[4];
  float m, kt, err, eps, I, tau;
  int steps;
  bool active;
};

// Nonzero Christoffel components Gamma^i_jk (j <= k), named gijk.
struct Conn {
  float g001, g002, g013, g023;
  float g100, g103, g111, g112, g122, g133;
  float g200, g203, g211, g212, g222, g233;
  float g301, g302, g313, g323;
};

// Kerr connection, the expressions of _kerr_conn_entries in its order
// (sim5kerr.c:233-316).  g203 divides by a: 0/0 (or 0 * inf) at a = 0,
// as in the reference.
__device__ __forceinline__ Conn kerr_conn(const Params& p, float r, float m) {
  const float a = p.a;
  const float rS = 2.0f * r;
  const float s = sqrtf(1.0f - m * m);
  const float cs = s * m;
  const float c2 = m * m;
  const float s2 = s * s;
  const float cc = c2 - s2;
  const float CC = 8.0f * c2 * c2 - 8.0f * c2 + 1.0f;
  const float a2 = a * a;
  const float a4 = a2 * a2;
  const float a2cc = a2 * cc;
  const float a2c2 = a2 * c2;
  const float a2cs = a2 * cs;
  const float a4CC = a4 * CC;
  const float r2 = r * r;
  const float r3 = r2 * r;
  const float r4 = r2 * r2;
  const float a2r2 = a2 * r2;
  const float a2_r2 = a2 + r2;
  const float Rb = a2 + 2.0f * r2 + a2cc;
  const float R = Rb * Rb;
  const float D = r2 - 2.0f * r + a2;
  const float S = r2 + a2c2;
  const float S_1 = 1.0f / S;
  const float S_3 = S_1 * S_1 * S_1;
  const float D_1 = 1.0f / D;
  const float R_1 = 1.0f / R;
  const float m_s = m / s;
  const float DR_1 = D_1 * R_1;
  const float DS_1 = D_1 * S_1;
  const float dbl_r2 = 2.0f * r2;

  const float G100 = D * (r2 - a2c2) * S_3;
  const float G200 = -2.0f * r * a2cs * S_3;
  const float G002 = -4.0f * a2cs * rS * R_1;

  Conn g;
  g.g001 = 4.0f * a2_r2 * (r2 - a2c2) * DR_1;
  g.g002 = G002;
  g.g013 = 2.0f * a * s2 * (a4 - 3.0f * a2r2 - 6.0f * r4 + a2cc * (a2 - r2)) * DR_1;
  g.g023 = -G002 * s2 * a;
  g.g100 = G100;
  g.g103 = -G100 * a * s2;
  g.g111 = (r * (a2 - r) + a2 * (1.0f - r) * c2) * DS_1;
  g.g112 = -a2cs * S_1;
  g.g122 = -r * D * S_1;
  g.g133 = -D * s2 * (2.0f * a2c2 * r3 + r2 * r3 + a2 * a2c2 * s2
                      + a2c2 * a2c2 * r - a2r2 * s2) * S_3;
  g.g200 = G200;
  g.g203 = -G200 * a2_r2 * p.inv_a;
  g.g211 = a2cs * DS_1;
  g.g212 = r * S_1;
  g.g222 = -a2cs * S_1;
  g.g233 = -cs * (a2_r2 * S * S + a2 * s2 * rS * (a2_r2 + S)) * S_3;
  g.g301 = a * (r2 - a2c2) * DS_1 * S_1;
  g.g302 = -4.0f * a * rS * m_s * R_1;
  g.g313 = 0.5f * (a4 + 3.0f * a4 * r - 12.0f * a2r2 + 8.0f * a2 * r3
                   - 16.0f * r4 + 8.0f * r2 * r3
                   + 4.0f * r * (dbl_r2 - r + a2) * a2cc
                   - a4CC * (1.0f - r)) * DR_1;
  g.g323 = 0.5f * ((3.0f * a4 + 8.0f * a2 * r + 8.0f * a2r2 + 8.0f * r4
                    + 4.0f * (dbl_r2 - 2.0f * r + a2) * a2cc + a4CC) * m_s) * R_1;
  return g;
}

// Minkowski connection in spherical coordinates (sim5kerr.c:199-228);
// only g122, g133, g212, g233, g313, g323 are read.
__device__ __forceinline__ Conn flat_conn(float r, float m) {
  const float s = sqrtf(1.0f - m * m);
  Conn g;
  g.g122 = -r;
  g.g133 = -r * s * s;
  g.g212 = 1.0f / r;
  g.g233 = -m * s;
  g.g313 = 1.0f / r;
  g.g323 = m / s;
  return g;
}

__device__ __forceinline__ float gauss(const Gauss& g, float t, float r,
                                       float m) {
  const float rho = g.cyl ? r * sqrtf(fmaxf(1.0f - m * m, 0.0f)) : r;
  const float d = (rho - g.center) * g.inv_w;
  const float z = r * m * g.inv_h;
  const float w = (t - g.t_c) * g.inv_d;
  return g.amp * expf(-0.5f * (d * d + z * z + w * w));
}

template <bool GR>
__device__ __forceinline__ Conn connection(const Params& p, float r,
                                           float m) {
  if constexpr (GR) {
    return kerr_conn(p, r, m);
  } else {
    return flat_conn(r, m);
  }
}

// out^i = -Gamma^i_jk U^j V^k, summed in the order of the entry dict.
template <bool GR>
__device__ __forceinline__ void contract(const Conn& g, const float U[4],
                                         const float V[4], float out[4]) {
  const float p01 = U[0] * V[1] + U[1] * V[0];
  const float p02 = U[0] * V[2] + U[2] * V[0];
  const float p03 = U[0] * V[3] + U[3] * V[0];
  const float p12 = U[1] * V[2] + U[2] * V[1];
  const float p13 = U[1] * V[3] + U[3] * V[1];
  const float p23 = U[2] * V[3] + U[3] * V[2];
  const float p00 = U[0] * V[0];
  const float p11 = U[1] * V[1];
  const float p22 = U[2] * V[2];
  const float p33 = U[3] * V[3];
  if constexpr (GR) {
    out[0] = -(g.g001 * p01 + g.g002 * p02 + g.g013 * p13 + g.g023 * p23);
    out[1] = -(g.g100 * p00 + g.g103 * p03 + g.g111 * p11 + g.g112 * p12
               + g.g122 * p22 + g.g133 * p33);
    out[2] = -(g.g200 * p00 + g.g203 * p03 + g.g211 * p11 + g.g212 * p12
               + g.g222 * p22 + g.g233 * p33);
    out[3] = -(g.g301 * p01 + g.g302 * p02 + g.g313 * p13 + g.g323 * p23);
  } else {
    out[0] = 0.0f;
    out[1] = -(g.g122 * p22 + g.g133 * p33);
    out[2] = -(g.g212 * p12 + g.g233 * p33);
    out[3] = -(g.g313 * p13 + g.g323 * p23);
  }
}

// One trial step of a live ray (the Pallas body's loop body): adaptive
// RK4 trial, error check, accept or revert-and-retry, transfer on an
// accepted step, steps += 1 and the termination test.  Every schedule
// runs this one function.
template <bool GR, bool POL, int RT>
__device__ __forceinline__ void trial_step(Ray& s, const Params& p) {
  // adaptive step: dl = eps / sum_i |dk_i|/|k_i|  (sim5raytrace.c:164)
  const Conn g1 = connection<GR>(p, s.x[1], s.m);
  float dk1[4], df1[4];
  contract<GR>(g1, s.k, s.k, dk1);
  float curv = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    curv = curv + fabsf(dk1[c]) / (fabsf(s.k[c]) + kTiny);
  curv = curv + kTiny;
  float dl = nan_min(p.max_step_dl, s.eps / curv);
  // progress floor, scaled with the retry shrink
  dl = nan_max(dl, s.eps * p.floor_scale);

  // RK4 in (t, r, theta, phi); stage 1 reuses the curvature evaluation
  if (POL) contract<GR>(g1, s.k, s.f, df1);
  const float h = 0.5f * dl;
  float xs[4], k2[4], f2[4], dk2[4], df2[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xs[c] = s.x[c] + s.k[c] * h;
    k2[c] = s.k[c] + dk1[c] * h;
    if (POL) f2[c] = s.f[c] + df1[c] * h;
  }
  {
    const Conn g = connection<GR>(p, xs[1], cosf(xs[2]));
    contract<GR>(g, k2, k2, dk2);
    if (POL) contract<GR>(g, k2, f2, df2);
  }
  float k3[4], f3[4], dk3[4], df3[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xs[c] = s.x[c] + k2[c] * h;
    k3[c] = s.k[c] + dk2[c] * h;
    if (POL) f3[c] = s.f[c] + df2[c] * h;
  }
  {
    const Conn g = connection<GR>(p, xs[1], cosf(xs[2]));
    contract<GR>(g, k3, k3, dk3);
    if (POL) contract<GR>(g, k3, f3, df3);
  }
  float k4[4], f4[4], dk4[4], df4[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xs[c] = s.x[c] + k3[c] * dl;
    k4[c] = s.k[c] + dk3[c] * dl;
    if (POL) f4[c] = s.f[c] + df3[c] * dl;
  }
  {
    const Conn g = connection<GR>(p, xs[1], cosf(xs[2]));
    contract<GR>(g, k4, k4, dk4);
    if (POL) contract<GR>(g, k4, f4, df4);
  }

  const float d6 = dl * (1.0f / 6.0f);
  float xn[4], kn[4], fn[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    xn[c] = s.x[c] + d6 * (s.k[c] + 2.0f * (k2[c] + k3[c]) + k4[c]);
    kn[c] = s.k[c] + d6 * (dk1[c] + 2.0f * (dk2[c] + dk3[c]) + dk4[c]);
    if (POL)
      fn[c] = s.f[c] + d6 * (df1[c] + 2.0f * (df2[c] + df3[c]) + df4[c]);
  }

  // error: k_t drift + |k.k|  (sim5raytrace.c:217-219)
  float g00, g11, g22, g33, g03;
  const float mn = cosf(xn[2]);   // the next trial's m if accepted
  {
    const float r = xn[1];
    const float m = mn;
    if (GR) {
      const float a = p.a;
      const float r2 = r * r;
      const float a2 = a * a;
      const float m2 = m * m;
      const float s2 = 1.0f - m2;
      const float S = r2 + a2 * m2;
      const float D = r2 - 2.0f * r + a2;
      const float A = (r2 + a2) * (r2 + a2) - a2 * D * s2;
      const float S_1 = 1.0f / S;
      g00 = -(1.0f - 2.0f * r * S_1);
      g11 = S / D;
      g22 = S;
      g33 = A * S_1 * s2;
      g03 = -2.0f * a * r * s2 * S_1;
    } else {
      const float s2 = 1.0f - m * m;
      g00 = -1.0f;
      g11 = 1.0f;
      g22 = r * r;
      g33 = r * r * s2;
      g03 = 0.0f;
    }
  }
  const float kt_new = kn[0] * g00 + kn[3] * g03;
  const float kk = fabsf(g00 * kn[0] * kn[0] + g11 * kn[1] * kn[1]
                         + g22 * kn[2] * kn[2] + g33 * kn[3] * kn[3]
                         + 2.0f * g03 * kn[0] * kn[3]);
  const float e_new =
      nan_max(fabsf(kt_new - s.kt) / (fabsf(s.kt) + kTiny), kk);

  // masked revert-and-retry (sim5raytrace.c:217-227): reject non-finite
  // or over-gate trials while shrink budget remains; a non-finite trial
  // at the shrink floor freezes the ray with err = 1e30
  const bool bad = !(isfinite(e_new) && isfinite(xn[1]));
  const bool reject = (bad || e_new > p.error_gate) && s.eps > p.eps0 / 64.0f;
  const bool fail_floor = bad && !reject;
  const bool acc = !reject && !bad;
  if (reject) {
    s.eps = fmaxf(0.5f * s.eps, p.eps0 / 128.0f);
  } else if (acc) {
    s.eps = fminf(p.eps0, 1.3f * s.eps);
  }
  if (acc) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.x[c] = xn[c];
      s.k[c] = kn[c];
      if (POL) s.f[c] = fn[c];
    }
    s.m = mn;
    s.kt = kt_new;
    s.err = e_new;
    // radiative transfer on accepted steps, at the accepted position
    // (x = xn, m = mn), with the trial's dl; the march is backward
    // (observer -> source), so tau is the optical depth to the observer.
    // Thick branch: the Pallas body's 1e-6 threshold, 1 - exp (not expm1)
    // and 1e-30 floor.
    if constexpr (RT > 0) {
      const float j = gauss(p.jm, s.x[0], s.x[1], mn);
      if constexpr (RT == 2) {
        const float al = gauss(p.am, s.x[0], s.x[1], mn);
        const float dtau = al * dl;
        const float seff =
            dtau > 1e-6f ? (1.0f - expf(-dtau)) / nan_max(al, kTiny) : dl;
        s.I = s.I + j * expf(-s.tau) * seff;
        s.tau = s.tau + dtau;
      } else {
        s.I = s.I + j * dl;
      }
    }
  } else if (fail_floor) {
    s.err = 1e30f;
  }
  s.steps += 1;

  const float rr = s.x[1];
  s.active = rr > p.r_min && rr < p.r_max && s.err < p.error_stop &&
             isfinite(rr);
}

// One launch of the march (see the header): segment seg >= 0 of the
// segmented schedule, or seg = -1, the whole march in one launch.
// Segment 0 and seg = -1 read the rays from the inputs; segment k >= 1
// reads the stats[1 + k] rays of lv_in / li_in.  RT: 0 geometry only,
// 1 emission, 2 emission + absorption; Io is written for RT > 0 only.
template <bool GR, bool POL, int RT>
__global__ void __launch_bounds__(kThreads, min_blocks<GR, POL, RT>())
march_f32(Buffers io, const float* __restrict__ lv_in,
          const int* __restrict__ li_in, float* __restrict__ lv_out,
          int* __restrict__ li_out, unsigned long long* __restrict__ stats,
          int seg, long long n, Params p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long count = seg <= 0 ? n : (long long)stats[1 + seg];
  if (i - lane >= count) return;   // the whole warp is past the list
  const bool in_range = i < count;

  Ray s;
  long long idx = i;
  s.active = false;
  s.steps = 0;
  if (in_range && seg <= 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.x[c] = io.x[c * n + i];
      s.k[c] = io.k[c * n + i];
      if (POL) s.f[c] = io.f[c * n + i];
    }
    s.kt = io.kt[i];
    s.err = 0.0f;
    s.eps = p.eps0;
    s.I = 0.0f;
    s.tau = 0.0f;
    s.active = isfinite(s.kt) && io.act[i] != 0;
  } else if (in_range) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.x[c] = lv_in[(kX + c) * n + i];
      s.k[c] = lv_in[(kK + c) * n + i];
      if (POL) s.f[c] = lv_in[(kF + c) * n + i];
    }
    s.kt = lv_in[kKt * n + i];
    s.err = lv_in[kErr * n + i];
    s.eps = lv_in[kEps * n + i];
    if (RT > 0) s.I = lv_in[kI * n + i];
    if (RT == 2) s.tau = lv_in[kTau * n + i];
    s.steps = li_in[i];
    idx = li_in[n + i];
    s.active = true;
  }
  // m as the error check of the ray's last accepted trial computed it
  if (in_range) s.m = cosf(s.x[2]);

  // a warp makes trips while any lane is live; the ballot keeps the
  // counters exact whatever the compiler does with divergence
  const int trips = seg < 0 ? p.max_steps : kSegTrips;
  unsigned long long lane_trips = 0, warp_trips = 0;
  for (int t = 0; t < trips; ++t) {
    const bool live = in_range && s.active && s.steps < p.max_steps;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (mask == 0) break;
    lane_trips += __popc(mask);
    warp_trips += 1;
    if (live) trial_step<GR, POL, RT>(s, p);
  }

  const bool keep = in_range && s.active && s.steps < p.max_steps;
  if (in_range && !keep) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      io.xo[c * n + idx] = s.x[c];
      io.ko[c * n + idx] = s.k[c];
      io.fo[c * n + idx] = POL ? s.f[c] : io.f[c * n + idx];
    }
    io.kto[idx] = s.kt;
    io.erro[idx] = s.err;
    io.stepso[idx] = s.steps;
    io.acto[idx] = s.active ? 1 : 0;
    if (RT > 0) io.Io[idx] = s.I;
  }
  // append the live rays: one atomicAdd per warp, consecutive slots
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (kept != 0) {
    long long base = 0;
    if (lane == 0)
      base = (long long)atomicAdd(&stats[2 + (seg < 0 ? 0 : seg)],
                                  (unsigned long long)__popc(kept));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep) {
      const long long j = base + __popc(kept & ((1u << lane) - 1u));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lv_out[(kX + c) * n + j] = s.x[c];
        lv_out[(kK + c) * n + j] = s.k[c];
        if (POL) lv_out[(kF + c) * n + j] = s.f[c];
      }
      lv_out[kKt * n + j] = s.kt;
      lv_out[kErr * n + j] = s.err;
      lv_out[kEps * n + j] = s.eps;
      if (RT > 0) lv_out[kI * n + j] = s.I;
      if (RT == 2) lv_out[kTau * n + j] = s.tau;
      li_out[j] = s.steps;
      li_out[n + j] = (int)idx;
    }
  }
  if (lane == 0 && warp_trips != 0) {
    atomicAdd(&stats[0], lane_trips);
    atomicAdd(&stats[1], warp_trips);
  }
}

using Kernel = void (*)(Buffers, const float*, const int*, float*, int*,
                        unsigned long long*, int, long long, Params);

// march_f32<gr, pol, rt>, or nullptr for an rt outside 0..2
Kernel kernel(int gr, int pol, int rt) {
  static const Kernel table[2][2][3] = {
      {{march_f32<false, false, 0>, march_f32<false, false, 1>,
        march_f32<false, false, 2>},
       {march_f32<false, true, 0>, march_f32<false, true, 1>,
        march_f32<false, true, 2>}},
      {{march_f32<true, false, 0>, march_f32<true, false, 1>,
        march_f32<true, false, 2>},
       {march_f32<true, true, 0>, march_f32<true, true, 1>,
        march_f32<true, true, 2>}}};
  if (rt < 0 || rt > 2) return nullptr;
  return table[gr ? 1 : 0][pol ? 1 : 0][rt];
}

}  // namespace

// Launch one segment (seg >= 0) of march_f32<gr, pol, rt>, or the whole
// march in one launch (seg = -1), over n rays on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue (1) for an
// rt outside 0..2.  The caller allocates every output, the two lists
// (kListFloats x n floats and 2 x n ints each; unused for seg = -1) and
// stats (2 + segments zeroed 64-bit counters).  Io (n floats) is written
// only for rt > 0.  The emissivity (j_*) and absorption (al_*) parameters
// are those of GaussianSource.params(); the absorption is read only for
// rt == 2.
extern "C" int sim5_march_f32(
    int gr, int pol, int rt, int seg, const float* x, const float* k,
    const float* f, const float* kt, const unsigned char* act0, float* xo,
    float* ko, float* fo, float* kto, float* erro, int* stepso,
    unsigned char* acto, float* Io, const float* lv_in, const int* li_in,
    float* lv_out, int* li_out, unsigned long long* stats, long long n,
    float a, float eps0, float r_min, float r_max, float error_stop,
    float error_gate, int max_steps, float max_step_dl, float j_amp,
    float j_center, float j_inv_w, float j_inv_h, float j_t_c,
    float j_inv_d, int j_cyl, float al_amp, float al_center, float al_inv_w,
    float al_inv_h, float al_t_c, float al_inv_d, int al_cyl, void* stream) {
  const Kernel fn = kernel(gr, pol, rt);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Buffers io{x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso, acto, Io};
  const Params p{a, 1.0f / a, eps0, 1e-3f / eps0, r_min, r_max, error_stop,
                 error_gate, max_step_dl, max_steps,
                 Gauss{j_amp, j_center, j_inv_w, j_inv_h, j_t_c, j_inv_d,
                       j_cyl},
                 Gauss{al_amp, al_center, al_inv_w, al_inv_h, al_t_c,
                       al_inv_d, al_cyl}};
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      io, lv_in, li_in, lv_out, li_out, stats, seg, n, p);
  return static_cast<int>(cudaGetLastError());
}

// The compile-time choices into out[0..2]: threads a block, trips a
// segment and floats a list entry.
extern "C" void sim5_march_config(int* out) {
  out[0] = kThreads;
  out[1] = kSegTrips;
  out[2] = kListFloats;
}

// Registers a thread, local memory a thread (bytes) and resident blocks
// an SM of march_f32<gr, pol, rt> into out[0..2]; returns the CUDA error.
extern "C" int sim5_march_attributes(int gr, int pol, int rt, int* out) {
  const Kernel fn = kernel(gr, pol, rt);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return static_cast<int>(e);
}
