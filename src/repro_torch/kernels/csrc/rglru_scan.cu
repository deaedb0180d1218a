// RG-LRU scan (RecurrentGemma's recurrent mixer): a_t = exp(la ⊙ r_t),
// h_t = a_t ⊙ h_{t-1} + sqrt(max(1 − a_t², 1e-12)) ⊙ (i_t ⊙ x_t), y_t = h_t,
// from a given or zero h0, returning the final h — one thread per (batch
// row, channel), a block per 128 channels of a row.
//
// Replaces: src/repro/kernels/rglru/kernel.py:rglru_scan (Pallas body
// _rglru_kernel), whose grid walks (B, channel blocks, time tiles) with the
// time tiles innermost and in order on one TPU core and keeps the (BW,)
// state in VMEM scratch across them.  The reference model runs the jnp scan
// (src/repro/models/rglru.py:rglru_scan_ref), whose order of float32
// operations this kernel keeps.
//
// What bounds it on the H100: bytes.  Per (row, step, channel) it reads x,
// r and i and writes y (14 bytes with bf16 x) for 9 operations, an
// exponential and a square root; the state is read and written once.
// RecurrentGemma-9B's decode step (B = 16, S = 1, W = 4096) moves ~1.2 MB
// (~0.4 µs at 3.35 TB/s), its 8 × 80 prefill ~37 MB (~11 µs).
//
// Design: the recurrence is sequential in time and independent per
// channel, so a thread owns one channel of one row, keeps h in a register
// and loops over the steps; neighbouring threads take neighbouring
// channels, so every access of a warp is coalesced.  x is read in its own
// dtype (bf16 or float32), so the model passes its bf16 branch without a
// cast.  Each thread reads its h0 before it writes its h_final, so h0 may
// alias h_out (a decode step updates the cache slab in place).  Built with
// the repository's -fmad=false, every operation rounds as the plain
// version's separate multiplies and adds; expf and the IEEE sqrtf are the
// functions torch calls, so the kernel can equal the plain version bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels of a block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ x, const float* __restrict__ r,
                      const float* __restrict__ ig,
                      const float* __restrict__ la, const float* h0,
                      float* h_out, float* __restrict__ y, int S, int W) {
  const int row = blockIdx.x;
  const int w = blockIdx.y * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long st = (long long)row * W + w;
  const float l = la[w];
  float h = h0 != nullptr ? h0[st] : 0.0f;
  long long o = (long long)row * S * W + w;
  for (int t = 0; t < S; ++t, o += W) {
    const float a = expf(l * r[o]);
    h = a * h + sqrtf(fmaxf(1.0f - a * a, 1e-12f)) * (ig[o] * to_f(x[o]));
    y[o] = h;
  }
  h_out[st] = h;
}

template <typename T>
int launch(const void* x, const void* r, const void* ig, const void* la,
           const void* h0, void* h_out, void* y, int B, int S, int W,
           cudaStream_t stream) {
  const dim3 grid(B, (W + kThreads - 1) / kThreads);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const float*)r, (const float*)ig, (const float*)la,
      (const float*)h0, (float*)h_out, (float*)y, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x): 0 float32, 1 bfloat16.  x, r, i and y (B, S, W), la (W,),
// h0 and h_out (B, W), all contiguous, all but x float32; h0 null for
// zeros and allowed to alias h_out.
extern "C" int rglru_scan_launch(const void* x, const void* r, const void* ig,
                                 const void* la, const void* h0, void* h_out,
                                 void* y, int B, int S, int W, int dtype,
                                 void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, r, ig, la, h0, h_out, y, B, S, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, ig, la, h0, h_out, y, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
