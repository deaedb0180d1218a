// Special-function-unit helpers shared by the kernels that exponentiate in
// their inner loops (flash_attention.cu, mamba_scan.cu).
#pragma once

#include <cuda_runtime.h>

// 2^x by one ex2.approx.ftz on the SFU: relative error ~2^-22, results
// below 2^-126 flushed to 0
static __device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
