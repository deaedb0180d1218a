// (value, index) reductions across one warp, shared by the per-task solver
// kernels (ccg_solve.cu, ccg_encode.cu, ccg_master.cu).  The lower index wins
// ties, which is the reference's first-index-achieving-the-extremum rule
// (jnp.argmin / jnp.argmax); every lane ends with the warp's result.
#pragma once

#include <cuda_runtime.h>

static constexpr unsigned kFullMask = 0xffffffffu;

static __device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

static __device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}
