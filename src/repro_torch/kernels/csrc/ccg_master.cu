// CCG master step (paper Alg. 2, MP1) for a task batch — a group of kLanes
// lanes per task.
//
// Replaces: src/repro/kernels/ccg_master/kernel.py:ccg_master (Pallas body
// _master_kernel), the TPU kernel that keeps a (128, P, F) tile of the
// recourse slab in VMEM and streams the argmin over F tiles with a strict-<
// hand-off.
//
// What bounds it on the H100: latency.  The function needs, per task, the
// recourse of every generated pole at every feasible option (at most the
// whole (M, P, F) slab, 13.1 MB at M = 4096, P = 16, F = 50; early in a solve
// a task has one to three poles, under 2 MB in all: 0.3-0.6 us at
// 3.35 TB/s), the (M, P) scenario mask and the (M, F) feasibility mask, and
// does about three operations per value read.  Every task fits on the card
// at once (one wave), so the time is the launch and one task's chain of
// dependent steps: the mask's load, the pole set, the recourse loads, the
// argmin, with the warps' instructions sharing each SM's issue slots.
//
// Design: the chain is one batch of loads, one ballot, one batch of loads
// and one vote.  First every load that does not depend on the scenario set
// is issued together: a lane's entries of the task's (P,) mask, and for its
// options (f = lane + 32·j within each 64-option chunk) the feasibility
// byte and c1.  The mask becomes the pole set by ballots (32 bits where
// P <= 32, else 64); then the recourse of kPoleBatch generated poles at
// both of the lane's options is loaded at once and folded into η (max over
// the generated poles, -BIG where a pole is absent, as in the reference; 0
// for a task with no scenario); a batch short of poles repeats its first,
// since max is idempotent.  Every load is unconditional at an index clamped
// into its row (no branch or predicate set-up; what an option past F or an
// infeasible one reads is masked after).  obj = c1 + η, BIG where the
// option is infeasible, +inf past F.  The argmin is a lane-local strict `<`
// over the lane's options in increasing order, then a vote: one warp
// reduction of the objective's order-preserving keys and one of the indices
// that hold the minimum, so the first minimum over F wins, for any F; the
// lane holding it stores.  A task whose options are all infeasible gets
// y* = 0 and BIG, as jnp.argmin does.  Blocks of 16 warps (256 for
// M = 4096) launch faster than 512 of 8.  Every operation is exact (max,
// one add, compares), so the bits are the plain version's.  Compiled with
// -fmad=false.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <type_traits>

#include "warp_reduce.cuh"

namespace {

constexpr int kWarps = 16;        // warps per block
constexpr int kLanes = 32;        // lanes per task (16: two tasks a warp)
constexpr int kPoleBatch = 2;     // poles whose recourse loads issue together
constexpr int kChunk = 64;        // options a group holds at once
constexpr int kSlots = kChunk / kLanes;   // a lane's options in a chunk
constexpr int kMaxP = 64;         // the pole set is a 64-bit mask
constexpr float kBig = 1e9f;

// the lowest pole of a non-empty pole set
__device__ __forceinline__ int first_pole(unsigned b) { return __ffs(b) - 1; }
__device__ __forceinline__ int first_pole(unsigned long long b) {
  return __ffsll((long long)b) - 1;
}

// A lane's options of one chunk, f = f0 + gl + j·kLanes: feasible (false
// past F), and c1, each load at an index clamped into the row.
struct Options {
  bool ok[kSlots];
  float c1[kSlots];
};

__device__ __forceinline__ Options load_options(
    const unsigned char* __restrict__ ok_t, const float* __restrict__ c1,
    int f0, int gl, int F) {
  Options o;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int f = f0 + gl + j * kLanes;
    const int at = min(f, F - 1);
    o.ok[j] = (f < F) & (ok_t[at] != 0);
    o.c1[j] = c1[at];
  }
  return o;
}

// kWide: P > 32, a 64-bit pole set; else 32 bits.
template <bool kWide>
__global__ void __launch_bounds__(32 * kWarps) ccg_master_kernel(
    const float* __restrict__ rec, const float* __restrict__ scen_mask,
    const unsigned char* __restrict__ fs_ok, const float* __restrict__ c1,
    int* __restrict__ y_out, float* __restrict__ od_out, int M, int P,
    int F) {
  using Set = typename std::conditional<kWide, unsigned long long,
                                        unsigned>::type;
  constexpr int kMaskSlots = (kWide ? 64 : 32) / kLanes;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kLanes, group = lane / kLanes;
  const int task =
      (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / kLanes) + group;
  if (__all_sync(kFullMask, task >= M)) return;   // warp-uniform
  const bool live = task < M;
  const int t = live ? task : M - 1;   // a group past M loads a real task

  // ---- the loads that need no pole set, issued together ----
  const float* mask = scen_mask + (size_t)t * P;
  float mk[kMaskSlots];
#pragma unroll
  for (int j = 0; j < kMaskSlots; ++j) {
    mk[j] = mask[min(gl + j * kLanes, P - 1)];
  }
  const float* rec_t = rec + (size_t)t * P * F;
  const unsigned char* ok_t = fs_ok + (size_t)t * F;
  Options next = load_options(ok_t, c1, 0, gl, F);

  // ---- the pole set: bit p of a group's ballots is its pole p ----
  Set poles = 0;
#pragma unroll
  for (int j = 0; j < kMaskSlots; ++j) {
    const unsigned b = __ballot_sync(
        kFullMask, (gl + j * kLanes < P) & (mk[j] > 0.0f));
    const Set mine =
        (b >> (group * kLanes)) & (unsigned)((1ull << kLanes) - 1);
    poles |= mine << (j * kLanes);
  }

  float best = CUDART_INF_F;
  int arg = INT_MAX;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const Options o = next;
    if (f0 + kChunk < F) next = load_options(ok_t, c1, f0 + kChunk, gl, F);
    int col[kSlots];
    float eta[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      col[j] = min(f0 + gl + j * kLanes, F - 1);
      eta[j] = poles ? -kBig : 0.0f;
    }
    // ---- the recourse of kPoleBatch poles at every slot, loads together;
    // a batch short of poles repeats its first (max is idempotent) ----
    for (Set b = poles; b;) {
      int q[kPoleBatch];
      q[0] = first_pole(b);
      b &= b - 1;
#pragma unroll
      for (int u = 1; u < kPoleBatch; ++u) {
        q[u] = b ? first_pole(b) : q[0];
        b &= b - 1;
      }
      float r[kPoleBatch][kSlots];
#pragma unroll
      for (int u = 0; u < kPoleBatch; ++u) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) r[u][j] = rec_t[q[u] * F + col[j]];
      }
#pragma unroll
      for (int u = 0; u < kPoleBatch; ++u) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) eta[j] = fmaxf(eta[j], r[u][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int f = f0 + gl + j * kLanes;
      const float obj =
          f >= F ? CUDART_INF_F : (o.ok[j] ? o.c1[j] + eta[j] : kBig);
      if (obj < best) { best = obj; arg = f; }
    }
  }
  const int y = vote_first<false, kLanes>(best, arg);
  if (live && arg == y) {
    y_out[task] = y;
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
    constexpr int per_block = kWarps * (32 / kLanes);   // tasks
    const int grid = (M + per_block - 1) / per_block;
    auto kernel = P > 32 ? ccg_master_kernel<true> : ccg_master_kernel<false>;
    kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const float*)rec_all, (const float*)scen_mask,
        (const unsigned char*)fs_ok, (const float*)c1, (int*)y_star,
        (float*)o_down, M, P, F);
  }
  return (int)cudaGetLastError();
}
