// CCG master step (paper Alg. 2, MP1) for a task batch — one warp per task.
//
// Replaces: src/repro/kernels/ccg_master/kernel.py:ccg_master (Pallas body
// _master_kernel), the TPU kernel that keeps a (128, P, F) tile of the
// recourse slab in VMEM and streams the argmin over F tiles with a strict-<
// hand-off.
//
// What bounds it on the H100: bytes.  The function needs, per task, the
// recourse of every generated pole at every feasible option (at most the
// whole (M, P, F) slab, 13.1 MB at M = 4096, P = 16, F = 50: 3.9 us at
// 3.35 TB/s; early in a solve a task has one or two poles), the (M, P)
// scenario mask and the (M, F) feasibility mask; it does about three
// operations per value read.
//
// Design: a task's scenario mask becomes a 64-bit pole set by two warp
// ballots; lanes stride over the F options, and for a feasible option read
// the recourse of the generated poles only (a warp-uniform loop over the set
// bits, each read coalesced across the lanes' neighbouring options), so the
// kernel moves the bytes the data needs and no more.  η = max over those
// poles (-BIG where a pole is absent, as in the reference), 0 for a task
// with no scenario; obj = c1 + η, BIG where the option is infeasible.  The
// argmin is a lane-local strict `<` over the lane's options in increasing
// order, then a warp argmin in which the lower index wins ties: the first
// minimum over F, for any F.  A task whose options are all infeasible gets
// y* = 0 and BIG, as jnp.argmin does.  Compiled with -fmad=false.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "warp_reduce.cuh"

namespace {

constexpr int kWarps = 8;    // tasks per block
constexpr int kMaxP = 64;    // the pole set is a 64-bit mask
constexpr float kBig = 1e9f;

__global__ void ccg_master_kernel(
    const float* __restrict__ rec, const float* __restrict__ scen_mask,
    const unsigned char* __restrict__ fs_ok, const float* __restrict__ c1,
    int* __restrict__ y_out, float* __restrict__ od_out, int M, int P,
    int F) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= M) return;   // warp-uniform

  const float* mask = scen_mask + (size_t)task * P;
  const unsigned lo = __ballot_sync(kFullMask, lane < P && mask[lane] > 0.0f);
  const unsigned hi =
      __ballot_sync(kFullMask, lane + 32 < P && mask[lane + 32] > 0.0f);
  const unsigned long long poles = ((unsigned long long)hi << 32) | lo;

  const float* rec_t = rec + (size_t)task * P * F;
  const unsigned char* ok_t = fs_ok + (size_t)task * F;
  float best = CUDART_INF_F;
  int arg = INT_MAX;
  for (int f = lane; f < F; f += 32) {
    float obj = kBig;
    if (ok_t[f]) {
      float eta = 0.0f;
      if (poles) {
        eta = -kBig;
        for (unsigned long long b = poles; b; b &= b - 1) {
          const int pole = __ffsll((long long)b) - 1;
          eta = fmaxf(eta, rec_t[(size_t)pole * F + f]);
        }
      }
      obj = c1[f] + eta;
    }
    if (obj < best) { best = obj; arg = f; }
  }
  warp_argmin(best, arg);
  if (lane == 0) {
    y_out[task] = arg;
    od_out[task] = best;
  }
}

}  // namespace

extern "C" int ccg_master_launch(const void* rec_all, const void* scen_mask,
                                 const void* fs_ok, const void* c1,
                                 void* y_star, void* o_down, int M, int P,
                                 int F, void* stream) {
  if (M < 0 || P < 1 || P > kMaxP || F < 1) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    ccg_master_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, 0,
                        (cudaStream_t)stream>>>(
        (const float*)rec_all, (const float*)scen_mask,
        (const unsigned char*)fs_ok, (const float*)c1, (int*)y_star,
        (float*)o_down, M, P, F);
  }
  return (int)cudaGetLastError();
}
