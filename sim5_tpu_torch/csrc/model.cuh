// What the march kernel's emission and absorption models share with the
// functors that sim5_tpu_torch/march/model_trace.py emits from a traced
// torch callable: the qualifier SIM5_HD, torch's NaN-propagating min / max
// and floored remainder, and the wrapper that binds a traced model to its
// constants.
//
// The header is plain C++ outside nvcc (SIM5_HD is inline there), so an
// emitted functor compiles with g++ too: that is how the CPU tests hold the
// emitted code against the torch callable it came from.

#pragma once

#include <cmath>

#if defined(__CUDACC__)
#define SIM5_HD __host__ __device__ __forceinline__
#else
#define SIM5_HD inline
#endif

namespace sim5 {

// The constants a traced model may lift (model_trace.MAX_CONSTS).
constexpr int kModelConsts = 32;

// NaN-propagating min / max, as torch.minimum / torch.maximum and clamp
// (fminf and fmaxf would drop the NaN and hide a bad trial).
SIM5_HD float nan_min(float x, float y) {
  return (x < y || x != x) ? x : y;
}
SIM5_HD float nan_max(float x, float y) {
  return (x > y || x != x) ? x : y;
}

// torch.remainder on floats: fmodf, then the divisor added where the
// remainder is nonzero and its sign differs from the divisor's.
SIM5_HD float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((y < 0.0f) != (r < 0.0f))) r += y;
  return r;
}

// A traced model M (an emitted functor taking its constants first) with
// its constants, by value: the march kernel calls it as j(t, r, m, phi).
template <class M>
struct Traced {
  float c[kModelConsts];
  SIM5_HD float operator()(float t, float r, float m, float phi) const {
    return M()(c, t, r, m, phi);
  }
};

}  // namespace sim5
