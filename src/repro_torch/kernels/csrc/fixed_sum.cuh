// A sum over the leading dimension of a float32 partials buffer, in a fixed
// order: the second pass of the scans' backward kernels
// (mamba_scan_bwd.cu, rglru_scan_bwd.cu), which sum across blocks or batch
// rows without float atomics, so that two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// (an unnamed namespace around it: each source that includes it keeps its
// own copy)
namespace {
namespace fixed_sum {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// out[j] = Σ_{k < K} part[k·J + j], k ascending, for j < J.  Entry j is
// column c = j % inner of row j / inner; columns c < split go to lo (rows of
// split), the rest to hi (rows of inner − split): so one pass can write two
// contiguous outputs (dB and dC, or dA and dD) out of one partials row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_leading_kernel(const float* __restrict__ part, int K, long long J,
                       int inner, int split, T* __restrict__ lo,
                       T* __restrict__ hi) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= J) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc += part[(long long)k * J + j];
  const long long r = j / inner;
  const int c = (int)(j % inner);
  if (c < split)
    store(lo + r * split + c, acc);
  else
    store(hi + r * (inner - split) + (c - split), acc);
}

template <typename T>
void sum_leading(const float* part, int K, long long J, int inner, int split,
                 T* lo, T* hi, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((J + kThreads - 1) / kThreads);
  sum_leading_kernel<T><<<blocks, kThreads, 0, stream>>>(part, K, J, inner,
                                                         split, lo, hi);
}

}  // namespace fixed_sum
}  // namespace
