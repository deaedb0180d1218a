// Fused temporal-gating cell (paper Eq. 5-6) for a batch of streams.
//
// Replaces: src/repro/kernels/temporal_gate/kernel.py:gate_cell (Pallas body
// _gate_kernel), the TPU kernel that rides the packed (d, 3m) and (m, 2m)
// GEMMs on the MXU for a (256, d) stream tile.
//
// What bounds it on the H100: memory.  Per stream it reads dx (d floats),
// h (m floats) and vol, and writes h' (m floats), tau and mean(g): about
// 0.43 KB for d = 35, m = 32, against ~2·(3dm + 2m² + m² + m) ≈ 13 kFLOP of
// float32 FMA-free arithmetic, so at M = 4096 the bytes (1.8 MB, 0.5 us at
// 3.35 TB/s) and the flops (55 MFLOP, 0.8 us at 67 TFLOP/s) are both well
// under a launch; in practice the kernel is bound by launch latency and by the
// serial d + 2m dot-product chain of each lane.
//
// Design: one warp per stream, lane j = hidden unit j (m = 32).  The block
// copies every weight (W_x, U_gr, U_h, w_o, biases: 26.5 KB at d = 35) into
// shared memory once and serves 8 streams from it; lane j reads column j of
// each matrix, so a warp's 32 reads of one row hit 32 banks.  The dx row and
// h are held one element per lane and broadcast with __shfl_sync; tau and
// mean(g) are warp reductions.  The tensor cores are not used: a 32-wide
// hidden state gives each stream 13 kFLOP, and float32 FMA-free sums keep the
// result within 1e-5 of torch's GEMM.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // streams per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void gate_cell_kernel(const float* __restrict__ dx,
                                 const float* __restrict__ h,
                                 const float* __restrict__ vol,
                                 const float* __restrict__ w_x,
                                 const float* __restrict__ u_gr,
                                 const float* __restrict__ b_g,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ b_r,
                                 const float* __restrict__ u_h,
                                 const float* __restrict__ b_h,
                                 const float* __restrict__ w_o,
                                 const float* __restrict__ b_o,
                                 float* __restrict__ h_out,
                                 float* __restrict__ tau_out,
                                 float* __restrict__ gmean_out,
                                 int B, int d) {
  constexpr int m = 32;
  extern __shared__ float smem[];
  float* s_wx = smem;                 // (d, 3m)
  float* s_ugr = s_wx + d * 3 * m;    // (m, 2m)
  float* s_uh = s_ugr + m * 2 * m;    // (m, m)
  float* s_vec = s_uh + m * m;        // w_o | b_g | b_r | b_h  (4m)

  for (int i = threadIdx.x; i < d * 3 * m; i += blockDim.x) s_wx[i] = w_x[i];
  for (int i = threadIdx.x; i < m * 2 * m; i += blockDim.x) s_ugr[i] = u_gr[i];
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) s_uh[i] = u_h[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_vec[i] = w_o[i];
    s_vec[m + i] = b_g[i];
    s_vec[2 * m + i] = b_r[i];
    s_vec[3 * m + i] = b_h[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;   // warp-uniform

  const float* dxb = dx + (size_t)b * d;
  const float xa = lane < d ? dxb[lane] : 0.0f;
  const float xb = lane + 32 < d ? dxb[lane + 32] : 0.0f;
  const float hj = h[(size_t)b * m + lane];

  // packed dx·W_x: columns j (g), m + j (r), 2m + j (candidate)
  float xg = 0.0f, xr = 0.0f, xh = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float xk = __shfl_sync(kFull, k < 32 ? xa : xb, k & 31);
    const float* row = s_wx + k * 3 * m;
    xg = xg + xk * row[lane];
    xr = xr + xk * row[m + lane];
    xh = xh + xk * row[2 * m + lane];
  }
  // packed h·U_gr: columns j (g), m + j (r)
  float hg = 0.0f, hr = 0.0f;
  for (int k = 0; k < m; ++k) {
    const float hk = __shfl_sync(kFull, hj, k);
    const float* row = s_ugr + k * 2 * m;
    hg = hg + hk * row[lane];
    hr = hr + hk * row[m + lane];
  }
  const float g = sigmoidf_(xg + hg + s_vec[m + lane] + alpha[0] * vol[b]);
  const float r = sigmoidf_(xr + hr + s_vec[2 * m + lane]);
  const float rh = r * hj;
  float c = 0.0f;
  for (int k = 0; k < m; ++k) {
    c = c + __shfl_sync(kFull, rh, k) * s_uh[k * m + lane];
  }
  const float cand = tanhf(xh + c + s_vec[3 * m + lane]);
  const float hn = (1.0f - g) * hj + g * cand;
  h_out[(size_t)b * m + lane] = hn;

  const float t = warp_sum(hn * s_vec[lane]);
  const float gs = warp_sum(g);
  if (lane == 0) {
    tau_out[b] = sigmoidf_(t + b_o[0]);
    gmean_out[b] = gs / (float)m;
  }
}

}  // namespace

extern "C" int gate_cell_launch(const void* dx, const void* h, const void* vol,
                                const void* w_x, const void* u_gr,
                                const void* b_g, const void* alpha,
                                const void* b_r, const void* u_h,
                                const void* b_h, const void* w_o,
                                const void* b_o, void* h_out, void* tau,
                                void* g_mean, int B, int d, int m,
                                void* stream) {
  if (m != 32 || d < 1 || d > 64 || B % kWarps != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)(d * 3 * m + m * 2 * m + m * m + 4 * m);
  const dim3 grid(B / kWarps), block(32 * kWarps);
  if (B > 0) {
    gate_cell_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        (const float*)dx, (const float*)h, (const float*)vol,
        (const float*)w_x, (const float*)u_gr, (const float*)b_g,
        (const float*)alpha, (const float*)b_r, (const float*)u_h,
        (const float*)b_h, (const float*)w_o, (const float*)b_o,
        (float*)h_out, (float*)tau, (float*)g_mean, B, d);
  }
  return (int)cudaGetLastError();
}
