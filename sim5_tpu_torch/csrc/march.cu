// Stepwise Kerr / Minkowski ray march: every ray marched to termination in
// one launch, one thread per ray.
//
// Replaces the Pallas TPU kernel sim5_tpu/march/pallas_march.py
// (_make_kernel / _march_pallas), the variants without fused radiative
// transfer: GR or flat, with or without polarization transport.
//
// What bounds it: FP32 ALU work and register pressure.  A step is four
// connection evaluations (<= 20 Christoffel components each, contracted
// inline) and one metric evaluation; a ray's whole state and all RK4 stages
// stay in registers, so the march moves almost no bytes (14 floats in and
// out per ray).  Rays in a warp finish after different step counts, so a
// warp runs until its slowest ray is done (tail divergence); this first
// version does no compaction and no persistent blocks.
//
// Semantics follow the Pallas body step for step: each ray loops while it
// is active and it < max_steps, which is the per-ray meaning of the Pallas
// `cond` (inactive lanes never change there), and steps counts the trials
// made while active.  Layout: structure of arrays, component c of ray i at
// [c * n + i], so loads and stores are coalesced.  x[2] is theta.
//
// Built without fast math: cosf, sqrtf and division are the IEEE-accurate
// forms.  nvcc contracts a*b+c into FMAs, so single adaptive-step decisions
// can flip against the plain torch version; the tests allow for that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;

// NaN-propagating min / max, as jnp.minimum / torch.minimum (fminf and
// fmaxf would drop the NaN and hide a bad trial).
__device__ __forceinline__ float nan_min(float x, float y) {
  return (x < y || x != x) ? x : y;
}
__device__ __forceinline__ float nan_max(float x, float y) {
  return (x > y || x != x) ? x : y;
}

// Nonzero Christoffel components Gamma^i_jk (j <= k), named gijk.
struct Conn {
  float g001, g002, g013, g023;
  float g100, g103, g111, g112, g122, g133;
  float g200, g203, g211, g212, g222, g233;
  float g301, g302, g313, g323;
};

// Kerr connection, the expressions of _kerr_conn_entries in its order
// (sim5kerr.c:233-316).  g203 divides by a: 0/0 at a = 0, as in the
// reference.
__device__ __forceinline__ Conn kerr_conn(float a, float r, float m) {
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
  const float S_3 = 1.0f / (S * S * S);
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
  g.g203 = -G200 * a2_r2 / a;
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

template <bool GR>
__device__ __forceinline__ Conn connection(float a, float r, float m) {
  if constexpr (GR) {
    return kerr_conn(a, r, m);
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

template <bool GR, bool POL>
__global__ void __launch_bounds__(kThreads)
march_f32(const float* __restrict__ x_in, const float* __restrict__ k_in,
          const float* __restrict__ f_in, const float* __restrict__ kt_in,
          const unsigned char* __restrict__ act_in,
          float* __restrict__ x_out, float* __restrict__ k_out,
          float* __restrict__ f_out, float* __restrict__ kt_out,
          float* __restrict__ err_out, int* __restrict__ steps_out,
          unsigned char* __restrict__ act_out, long long n, float a,
          float eps0, float r_min, float r_max, float error_stop,
          float error_gate, int max_steps, float max_step_dl) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;

  float x[4], k[4], f[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = x_in[c * n + i];
    k[c] = k_in[c * n + i];
    f[c] = f_in[c * n + i];
  }
  float kt = kt_in[i];
  float err = 0.0f;
  int steps = 0;
  bool active = isfinite(kt) && act_in[i] != 0;
  float eps = eps0;

  for (int it = 0; active && it < max_steps; ++it) {
    // adaptive step: dl = eps / sum_i |dk_i|/|k_i|  (sim5raytrace.c:164)
    const Conn g1 = connection<GR>(a, x[1], cosf(x[2]));
    float dk1[4], df1[4];
    contract<GR>(g1, k, k, dk1);
    float curv = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) curv = curv + fabsf(dk1[c]) / (fabsf(k[c]) + kTiny);
    curv = curv + kTiny;
    float dl = nan_min(max_step_dl, eps / curv);
    // progress floor, scaled with the retry shrink
    dl = nan_max(dl, 1e-3f * eps / eps0);

    // RK4 in (t, r, theta, phi); stage 1 reuses the curvature evaluation
    if (POL) contract<GR>(g1, k, f, df1);
    const float h = 0.5f * dl;
    float xs[4], k2[4], f2[4], dk2[4], df2[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xs[c] = x[c] + k[c] * h;
      k2[c] = k[c] + dk1[c] * h;
      if (POL) f2[c] = f[c] + df1[c] * h;
    }
    {
      const Conn g = connection<GR>(a, xs[1], cosf(xs[2]));
      contract<GR>(g, k2, k2, dk2);
      if (POL) contract<GR>(g, k2, f2, df2);
    }
    float k3[4], f3[4], dk3[4], df3[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xs[c] = x[c] + k2[c] * h;
      k3[c] = k[c] + dk2[c] * h;
      if (POL) f3[c] = f[c] + df2[c] * h;
    }
    {
      const Conn g = connection<GR>(a, xs[1], cosf(xs[2]));
      contract<GR>(g, k3, k3, dk3);
      if (POL) contract<GR>(g, k3, f3, df3);
    }
    float k4[4], f4[4], dk4[4], df4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xs[c] = x[c] + k3[c] * dl;
      k4[c] = k[c] + dk3[c] * dl;
      if (POL) f4[c] = f[c] + df3[c] * dl;
    }
    {
      const Conn g = connection<GR>(a, xs[1], cosf(xs[2]));
      contract<GR>(g, k4, k4, dk4);
      if (POL) contract<GR>(g, k4, f4, df4);
    }

    const float d6 = dl / 6.0f;
    float xn[4], kn[4], fn[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xn[c] = x[c] + d6 * (k[c] + 2.0f * (k2[c] + k3[c]) + k4[c]);
      kn[c] = k[c] + d6 * (dk1[c] + 2.0f * (dk2[c] + dk3[c]) + dk4[c]);
      if (POL) fn[c] = f[c] + d6 * (df1[c] + 2.0f * (df2[c] + df3[c]) + df4[c]);
    }

    // error: k_t drift + |k.k|  (sim5raytrace.c:217-219)
    float g00, g11, g22, g33, g03;
    {
      const float r = xn[1];
      const float m = cosf(xn[2]);
      if (GR) {
        const float r2 = r * r;
        const float a2 = a * a;
        const float m2 = m * m;
        const float s2 = 1.0f - m2;
        const float S = r2 + a2 * m2;
        const float D = r2 - 2.0f * r + a2;
        const float A = (r2 + a2) * (r2 + a2) - a2 * D * s2;
        g00 = -(1.0f - 2.0f * r / S);
        g11 = S / D;
        g22 = S;
        g33 = A / S * s2;
        g03 = -2.0f * a * r * s2 / S;
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
    const float e_new = nan_max(fabsf(kt_new - kt) / (fabsf(kt) + kTiny), kk);

    // masked revert-and-retry (sim5raytrace.c:217-227): reject non-finite
    // or over-gate trials while shrink budget remains; a non-finite trial
    // at the shrink floor freezes the ray with err = 1e30
    const bool bad = !(isfinite(e_new) && isfinite(xn[1]));
    const bool reject = (bad || e_new > error_gate) && eps > eps0 / 64.0f;
    const bool fail_floor = bad && !reject;
    const bool acc = !reject && !bad;
    if (reject) {
      eps = fmaxf(0.5f * eps, eps0 / 128.0f);
    } else if (acc) {
      eps = fminf(eps0, 1.3f * eps);
    }
    if (acc) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[c] = xn[c];
        k[c] = kn[c];
        if (POL) f[c] = fn[c];
      }
      kt = kt_new;
      err = e_new;
    } else if (fail_floor) {
      err = 1e30f;
    }
    steps += 1;

    const float rr = x[1];
    active = rr > r_min && rr < r_max && err < error_stop && isfinite(rr);
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x_out[c * n + i] = x[c];
    k_out[c * n + i] = k[c];
    f_out[c * n + i] = f[c];
  }
  kt_out[i] = kt;
  err_out[i] = err;
  steps_out[i] = steps;
  act_out[i] = active ? 1 : 0;
}

template <bool GR, bool POL>
void launch(const float* x, const float* k, const float* f, const float* kt,
            const unsigned char* act0, float* xo, float* ko, float* fo,
            float* kto, float* erro, int* stepso, unsigned char* acto,
            long long n, float a, float eps0, float r_min, float r_max,
            float error_stop, float error_gate, int max_steps,
            float max_step_dl, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  march_f32<GR, POL><<<blocks, kThreads, 0, stream>>>(
      x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso, acto, n, a, eps0,
      r_min, r_max, error_stop, error_gate, max_steps, max_step_dl);
}

}  // namespace

// Launch march_f32<gr, pol> over n rays on `stream`; returns
// cudaGetLastError() (0 on success).  The caller allocates every output.
extern "C" int sim5_march_f32(int gr, int pol, const float* x, const float* k,
                              const float* f, const float* kt,
                              const unsigned char* act0, float* xo, float* ko,
                              float* fo, float* kto, float* erro, int* stepso,
                              unsigned char* acto, long long n, float a,
                              float eps0, float r_min, float r_max,
                              float error_stop, float error_gate,
                              int max_steps, float max_step_dl,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gr && pol) {
    launch<true, true>(x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso, acto,
                       n, a, eps0, r_min, r_max, error_stop, error_gate,
                       max_steps, max_step_dl, s);
  } else if (gr) {
    launch<true, false>(x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso,
                        acto, n, a, eps0, r_min, r_max, error_stop,
                        error_gate, max_steps, max_step_dl, s);
  } else if (pol) {
    launch<false, true>(x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso,
                        acto, n, a, eps0, r_min, r_max, error_stop,
                        error_gate, max_steps, max_step_dl, s);
  } else {
    launch<false, false>(x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso,
                         acto, n, a, eps0, r_min, r_max, error_stop,
                         error_gate, max_steps, max_step_dl, s);
  }
  return static_cast<int>(cudaGetLastError());
}
