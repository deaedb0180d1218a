// (value, index) reductions across one warp, shared by the per-task solver
// kernels (ccg_solve.cu, ccg_encode.cu, ccg_master.cu).  The lower index wins
// ties, which is the reference's first-index-achieving-the-extremum rule
// (jnp.argmin / jnp.argmax): by a vote, one warp reduction (redux.sync) of
// keys in the floats' order and one of the indices that hold the extremum,
// or by five butterfly rounds on the pair, where every lane ends with the
// warp's result (ccg_encode.cu's generic path, and the first designs that
// tools/kernel_variants.py times beside the votes).
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

// An unsigned key in the order of the float's value (-0 taken as +0, so
// that equal values have equal keys; NaN is not ordered).
static __device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

// The first index achieving the min (kMax: max) of the lanes' (v, i) pairs
// within each group of kG consecutive lanes, each lane's pair the first
// extremum of its own share of the indices; every lane gets its group's.
// One reduction of the keys and one of the indices a group.
template <bool kMax, int kG = 32>
static __device__ __forceinline__ int vote_first(float v, int i) {
  const unsigned key = order_key(v);
  const int own = (int)(threadIdx.x & 31) / kG;
  int first = 0;
#pragma unroll
  for (int g = 0; g < 32 / kG; ++g) {
    const bool in = own == g;   // lanes of other groups give neutral values
    const unsigned k = kMax ? __reduce_max_sync(kFullMask, in ? key : 0u)
                            : __reduce_min_sync(kFullMask, in ? key : ~0u);
    const unsigned at = __reduce_min_sync(
        kFullMask, in && key == k ? (unsigned)i : ~0u);
    if (in) first = (int)at;
  }
  return first;
}
