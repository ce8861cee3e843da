// The entry points of a march library generated for traced models
// (sim5_tpu_torch/march/model_trace.py: march_source).  The generated
// translation unit includes march.cuh, defines the emitted functors and,
// in the anonymous namespace,
//   constexpr int kModelRT;     // 1 emission, 2 emission + absorption
//   using ModelJ = sim5::Traced<Model_...>;   // the emissivity
//   using ModelA = sim5::Traced<Model_...>;   // the absorption (ModelJ
//                                             // again for kModelRT 1)
// and then includes this header: march_f32<GR, POL, kModelRT, ModelJ,
// ModelA> for the four (GR, POL).

#pragma once

#include "march.cuh"

// Launch segment seg >= 0 of march_f32<gr, pol, kModelRT, ModelJ, ModelA>
// over n rays on `stream`: the buffers, lists, counters and scalars of
// march.cu's sim5_march_f32, then the emissivity's and the absorption's
// constants (sim5::kModelConsts floats each, copied into the launch's
// parameters; ac is read only for kModelRT 2).  Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue (1) for a negative seg.
extern "C" int sim5_march_model_f32(
    int gr, int pol, int seg, const float* x, const float* k, const float* f,
    const float* kt, const unsigned char* act0, float* xo, float* ko,
    float* fo, float* kto, float* erro, int* stepso, unsigned char* acto,
    float* Io, const float* lv_in, const int* li_in, float* lv_out,
    int* li_out, unsigned long long* stats, long long n, float a, float eps0,
    float r_min, float r_max, float error_stop, float error_gate,
    int max_steps, float max_step_dl, const float* jc, const float* ac,
    void* stream) {
  ModelJ jm;
  ModelA am;
  for (int i = 0; i < sim5::kModelConsts; ++i) {
    jm.c[i] = jc[i];
    am.c[i] = ac[i];
  }
  const Buffers io{x, k, f, kt, act0, xo, ko, fo, kto, erro, stepso, acto, Io};
  return launch(kernel_of<kModelRT, ModelJ, ModelA>(gr, pol), seg, io, lv_in,
                li_in, lv_out, li_out, stats, n,
                make_params(a, eps0, r_min, r_max, error_stop, error_gate,
                            max_steps, max_step_dl, jm, am),
                stream);
}

// Registers a thread, local memory a thread (bytes) and resident blocks
// an SM of march_f32<gr, pol, kModelRT, ModelJ, ModelA> into out[0..2];
// returns the CUDA error.
extern "C" int sim5_march_model_attributes(int gr, int pol, int* out) {
  return attributes(kernel_of<kModelRT, ModelJ, ModelA>(gr, pol), out);
}

// The compile-time choices into out[0..4]: threads a block, trips a
// segment, floats a list entry (as sim5_march_config), this library's
// transfer variant and the constants a model takes.
extern "C" void sim5_march_model_config(int* out) {
  out[0] = kThreads;
  out[1] = kSegTrips;
  out[2] = kListFloats;
  out[3] = kModelRT;
  out[4] = sim5::kModelConsts;
}
