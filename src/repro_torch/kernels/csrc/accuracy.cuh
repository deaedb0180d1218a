// The accuracy surface f(r, p, v, tier | z) as one device function, shared
// by every kernel that tests feasibility (ccg_solve.cu, ccg_encode.cu,
// c6_tail.cu).  It is repro/core/cost_model.py:_accuracy_formula with the
// same float32 operations in the same order; compiled with -fmad=false and
// IEEE expf it gives the bits of the plain PyTorch versions' formula
// (repro_torch/core/cost_model.py:_accuracy_formula) on the same card, and
// every feasibility bit of the router is an `f >= thr` test on it.
#pragma once

#include <cuda_runtime.h>

// a_max·sat: the part of f that depends on the option and version alone
// (a solver may build it once as a table)
static __device__ __forceinline__ float accuracy_base(float r, float k,
                                                      float tier) {
  const float a_max = 0.60f + 0.045f * k + 0.04f * tier;
  const float sat = 1.0f - expf(-(2.5f + 0.3f * k) * r);
  return a_max * sat;
}

// f from its base and the difficulty terms zp = 0.10·z·(1 − p) and
// zr = 0.06·z·(1 − r)
static __device__ __forceinline__ float accuracy_clamp(float base, float zp,
                                                       float zr) {
  const float f = base - zp - zr;
  return fminf(fmaxf(f, 0.0f), 1.0f);
}

static __device__ __forceinline__ float accuracy(float z, float r, float p,
                                                 float k, float tier) {
  return accuracy_clamp(accuracy_base(r, k, tier), 0.10f * z * (1.0f - p),
                        0.06f * z * (1.0f - r));
}
