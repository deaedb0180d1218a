// Fused per-task CCG encoding (the inputs of the unrolled Alg. 2 solver) —
// one warp per task.
//
// Replaces: src/repro/kernels/ccg_encode/kernel.py:ccg_encode (Pallas body
// _encode_kernel), the TPU kernel that streams (128,)-task tiles with the
// (K, P, F) pole-scaled cost slab resident in VMEM and folds the (M, P, F)
// recourse slab in place.
//
// What bounds it on the H100: bytes, for the function.  It must write the
// (M, P, F) recourse slab, the (M, F) bitmask and the (M,) argmax: at
// M = 4096, P = 16, F = 50 that is 13.1 MB + 0.82 MB, about 4.2 us at
// 3.35 TB/s, against some 20 operations per (task, option, version) of the
// accuracy formula once its task-independent part is tabulated (~0.1 us at
// the float32 peak).  The inputs are a few kilobytes.  This kernel does not
// reach that bound: its time goes to the fold, P·K dependent shared-memory
// loads and mins per option with one warp per task (about 31 warps per SM at
// M = 4096), while the slab's stores hide behind it.
//
// Design: one warp per task, lanes striding over the F options; each lane
// computes its options' accuracy for every version (accuracy.cuh, the
// formula of ccg_solve.cu and c6_tail.cu), sets the feasible-version bits,
// writes the code, then writes the option's recourse at every pole as the
// masked min of the pole-scaled costs over the feasible versions.  For a
// fixed pole the lanes write neighbouring options, so every store of the
// slab is coalesced.  The (K, P, F) cost slab sits in shared memory, loaded
// once per block of eight tasks.  The flat accuracy argmax (index y·K + k)
// is a lane-local strict `>` over the lane's (option, version) pairs in
// increasing index, then a warp argmax in which the lower index wins ties:
// the reference's first maximum over the flat (F·K) space.  The min-fold
// equals the plain version's gather of the (P, F, 2^K) subset lookup bit
// for bit, since a float min is exact and its order does not matter.
// Compiled with -fmad=false.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "accuracy.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kWarps = 8;          // tasks per block, one warp each
constexpr int kMaxSlab = 12288;    // K·P·F floats in 48 KB of shared memory
constexpr int kMaxK = 31;          // the bitmask is an int32
constexpr float kBig = 1e9f;

__global__ void ccg_encode_kernel(
    const float* __restrict__ z, const float* __restrict__ aq,
    const float* __restrict__ rn, const float* __restrict__ pn,
    const float* __restrict__ tier, const float* __restrict__ y_ok,
    const float* __restrict__ b2s, int* __restrict__ code_out,
    float* __restrict__ rec_out, int* __restrict__ best_out, int M, int F,
    int K, int P, float margin) {
  extern __shared__ float s_b2s[];   // (K, P, F)
  const int slab = K * P * F;
  for (int i = threadIdx.x; i < slab; i += blockDim.x) s_b2s[i] = b2s[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= M) return;   // warp-uniform

  const float zt = z[task];
  const float thr = aq[task] + margin;
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int f = lane; f < F; f += 32) {
    const bool ok = y_ok[f] > 0.0f;
    const float r = rn[f], p = pn[f], t = tier[f];
    int code = 0;
    for (int k = 0; k < K; ++k) {
      float acc = accuracy(zt, r, p, (float)k, t);
      if (!ok) acc = -kBig;
      if (acc >= thr) code |= 1 << k;
      if (acc > bv) { bv = acc; bi = f * K + k; }
    }
    code_out[(size_t)task * F + f] = code;
    float* rec = rec_out + (size_t)task * P * F + f;
    for (int pole = 0; pole < P; ++pole) {
      float v = kBig;
      for (int k = 0; k < K; ++k) {
        if ((code >> k) & 1) v = fminf(v, s_b2s[(k * P + pole) * F + f]);
      }
      rec[(size_t)pole * F] = v;
    }
  }
  warp_argmax(bv, bi);
  if (lane == 0) best_out[task] = bi;
}

}  // namespace

extern "C" int ccg_encode_launch(
    const void* z, const void* aq, const void* rn, const void* pn,
    const void* tier, const void* y_ok, const void* b2s, void* code,
    void* rec_all, void* best, int M, int F, int K, int P, float margin,
    void* stream) {
  if (M < 0 || F < 1 || K < 1 || K > kMaxK || P < 1 ||
      (long long)K * P * F > kMaxSlab) {
    return (int)cudaErrorInvalidValue;
  }
  if (M > 0) {
    const int grid = (M + kWarps - 1) / kWarps;
    const size_t smem = sizeof(float) * (size_t)K * P * F;
    ccg_encode_kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
        (const float*)z, (const float*)aq, (const float*)rn,
        (const float*)pn, (const float*)tier, (const float*)y_ok,
        (const float*)b2s, (int*)code, (float*)rec_all, (int*)best, M, F, K,
        P, margin);
  }
  return (int)cudaGetLastError();
}
