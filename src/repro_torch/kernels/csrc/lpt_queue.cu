// Longest-processing-time packing of one round's tasks onto the edge and
// cloud server pools — one block per round, one thread for the serial walk.
//
// Not a TPU kernel: it replaces the lax.scan over the sorted tasks in
// src/repro/serving/simulator.py:_lpt_queue (a realization helper).  A plain
// PyTorch loop over that scan issues a handful of tiny launches per task,
// about 37k per round at M = 4096.
//
// What bounds it on the H100: the serial dependence.  Task i's server is the
// least-loaded one after tasks 0..i-1 are placed, so the walk is one chain of
// M steps; the data (5 B per task in, 4 B out) and the arithmetic (one add
// and <= 8 compares per task) are negligible.
//
// Design: the block gathers the round's tasks into shared memory in
// longest-first order (coalesced reads of the stable argsort the wrapper
// computes), one thread walks them with the <= 8 server loads in registers
// (every loop over servers unrolled to constant indices), and the block
// scatters each task's start time back to its original position.  The argmin
// keeps the first server of the tier with the least load and the update is
// loads[j] += t, the reference's order of float32 operations: exact.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxServers = 8;

__global__ void lpt_queue_kernel(const float* __restrict__ t_comp,
                                 const int* __restrict__ route,
                                 const long long* __restrict__ order,
                                 float* __restrict__ start, int M, int n_edge,
                                 int n_cloud) {
  extern __shared__ float smem[];
  float* s_t = smem;                                  // (M,) sorted times
  signed char* s_tier = (signed char*)(smem + M);     // (M,) sorted tiers
  const size_t base = (size_t)blockIdx.x * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const long long src = order[base + i];
    s_t[i] = t_comp[base + src];
    s_tier[i] = (signed char)route[base + src];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int n_srv = n_edge + n_cloud;
    float loads[kMaxServers];
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j) loads[j] = 0.0f;
    for (int i = 0; i < M; ++i) {
      const float t = s_t[i];
      const int lo = s_tier[i] == 0 ? 0 : n_edge;
      const int hi = s_tier[i] == 0 ? n_edge : n_srv;
      float best = CUDART_INF_F;
      int pick = lo;
#pragma unroll
      for (int j = 0; j < kMaxServers; ++j) {
        if (j >= lo && j < hi && loads[j] < best) { best = loads[j]; pick = j; }
      }
#pragma unroll
      for (int j = 0; j < kMaxServers; ++j) {
        if (j == pick) loads[j] = loads[j] + t;
      }
      s_t[i] = best;      // the task's start: its server's load before it
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    start[base + order[base + i]] = s_t[i];
  }
}

}  // namespace

extern "C" int lpt_queue_launch(const void* t_comp, const void* route,
                                const void* order, void* start, int R, int M,
                                int n_edge, int n_cloud, void* stream) {
  if (n_edge < 1 || n_cloud < 1 || n_edge + n_cloud > kMaxServers) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)M * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lpt_queue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (R > 0 && M > 0) {
    lpt_queue_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)t_comp, (const int*)route, (const long long*)order,
        (float*)start, M, n_edge, n_cloud);
  }
  return (int)cudaGetLastError();
}
