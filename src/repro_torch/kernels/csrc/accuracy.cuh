// The accuracy surface f(r, p, v, tier | z) as one device function, shared
// by every kernel that tests feasibility (ccg_solve.cu, ccg_encode.cu,
// c6_tail.cu).  It is repro/core/cost_model.py:_accuracy_formula with the
// same float32 operations in the same order; compiled with -fmad=false and
// IEEE expf it gives the bits of the plain PyTorch versions' formula
// (repro_torch/core/cost_model.py:_accuracy_formula) on the same card, and
// every feasibility bit of the router is an `f >= thr` test on it.
#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ float accuracy(float z, float r, float p,
                                                 float k, float tier) {
  const float a_max = 0.60f + 0.045f * k + 0.04f * tier;
  const float sat = 1.0f - expf(-(2.5f + 0.3f * k) * r);
  float f = a_max * sat;
  f = f - 0.10f * z * (1.0f - p) - 0.06f * z * (1.0f - r);
  return fminf(fmaxf(f, 0.0f), 1.0f);
}
