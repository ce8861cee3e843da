// The march kernel's compiled-in emission and absorption models: the
// GaussianSource family (sim5_tpu_torch/march/emission.py), whose
// parameters are kernel arguments, and the library's entry points.  The
// kernel itself is march.cuh's march_f32<GR, POL, RT, J, A>, instantiated
// here with J = A = Gauss: 12 instances (GR or flat, with or without
// polarization, RT 0, 1 or 2).  Any other callable is traced into a
// generated translation unit of its own (march_model.cuh).

#include "march.cuh"

namespace {

constexpr float kPi = 3.14159265358979f;

// One model of the GaussianSource family (emission.py), by value:
// j = amp exp(-[((rho - center) inv_w)^2 + (r m inv_h)^2
//               + ((t - t_c) inv_d)^2 + (rho dphi inv_arc)^2] / 2),
// rho = r or r sqrt(1 - m^2), dphi = phi - phi_c - omega t wrapped into
// [-pi, pi): a spot orbiting at the angular velocity omega.
struct Gauss {
  float amp, center, inv_w, inv_h, t_c, inv_d, phi_c, omega, inv_arc;
  int cyl;
  __device__ __forceinline__ float operator()(float t, float r, float m,
                                              float phi) const;
};

// The arc term is a branch on a kernel parameter, uniform across the
// launch: a source that does not orbit (inv_arc == 0) runs the arithmetic
// of the family without it, bit for bit.
__device__ __forceinline__ float gauss(const Gauss& g, float t, float r,
                                       float m, float phi) {
  const float rho = g.cyl ? r * sqrtf(fmaxf(1.0f - m * m, 0.0f)) : r;
  const float d = (rho - g.center) * g.inv_w;
  const float z = r * m * g.inv_h;
  const float w = (t - g.t_c) * g.inv_d;
  float s = d * d + z * z + w * w;
  if (g.inv_arc != 0.0f) {
    // floored modulo, exact: fmodf, then into [0, 2 pi)
    float dp = fmodf(phi - g.phi_c - g.omega * t + kPi, 2.0f * kPi);
    if (dp < 0.0f) dp += 2.0f * kPi;
    const float e = rho * (dp - kPi) * g.inv_arc;
    s = s + e * e;
  }
  return g.amp * expf(-0.5f * s);
}

__device__ __forceinline__ float Gauss::operator()(float t, float r, float m,
                                                   float phi) const {
  return gauss(*this, t, r, m, phi);
}

// march_f32<gr, pol, rt, Gauss, Gauss>, or nullptr for an rt outside 0..2
Kernel<Gauss, Gauss> kernel(int gr, int pol, int rt) {
  switch (rt) {
    case 0: return kernel_of<0, Gauss, Gauss>(gr, pol);
    case 1: return kernel_of<1, Gauss, Gauss>(gr, pol);
    case 2: return kernel_of<2, Gauss, Gauss>(gr, pol);
    default: return nullptr;
  }
}

}  // namespace

// Launch segment seg >= 0 of march_f32<gr, pol, rt> over n rays on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue (1) for an rt outside 0..2 or a negative seg.  The
// caller allocates every output, the two lists (kListFloats x n floats
// and 2 x n ints each) and stats (2 + segments zeroed 64-bit counters).
// Io (n floats) is written only for rt > 0.  The emissivity (j_*) and
// absorption (al_*) parameters are those of GaussianSource.params(); the
// absorption is read only for rt == 2.
extern "C" int sim5_march_f32(
    int gr, int pol, int rt, int seg, const float* x, const float* k,
    const float* f, const float* kt, const unsigned char* act0, float* xo,
    float* ko, float* fo, float* kto, float* erro, int* stepso,
    unsigned char* acto, float* Io, const float* lv_in, const int* li_in,
    float* lv_out, int* li_out, unsigned long long* stats, long long n,
    float a, float eps0, float r_min, float r_max, float error_stop,
    float error_gate, int max_steps, float max_step_dl, float j_amp,
    float j_center, float j_inv_w, float j_inv_h, float j_t_c,
    float j_inv_d, float j_phi_c, float j_omega, float j_inv_arc, int j_cyl,
    float al_amp, float al_center, float al_inv_w, float al_inv_h,
    float al_t_c, float al_inv_d, float al_phi_c, float al_omega,
    float al_inv_arc, int al_cyl, void* stream) {
  const Buffers io{x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso, acto, Io};
  const Params<Gauss, Gauss> p = make_params(
      a, eps0, r_min, r_max, error_stop, error_gate, max_steps, max_step_dl,
      Gauss{j_amp, j_center, j_inv_w, j_inv_h, j_t_c, j_inv_d, j_phi_c,
            j_omega, j_inv_arc, j_cyl},
      Gauss{al_amp, al_center, al_inv_w, al_inv_h, al_t_c, al_inv_d,
            al_phi_c, al_omega, al_inv_arc, al_cyl});
  return launch(kernel(gr, pol, rt), seg, io, lv_in, li_in, lv_out, li_out,
                stats, n, p, stream);
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
  return attributes(kernel(gr, pol, rt), out);
}
