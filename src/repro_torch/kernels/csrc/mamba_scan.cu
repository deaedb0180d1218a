// Selective scan (Mamba-1 mixer): h_t = exp(dt_t·A) ⊙ h_{t-1} + dt_t·B_t·x_t,
// y_t = C_t·h_t + D ⊙ x_t, from a given or zero h0, returning the final h —
// one thread per (batch row, channel), a block per 128 channels of a row.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py:selective_scan (Pallas
// body _mamba_kernel), whose grid walks (b, channel blocks, time tiles) with
// the time tiles innermost and in order on one TPU core and keeps the
// (BD, N) state in VMEM scratch across them, so that x, dt, B and C are read
// once and y written once.  The reference model runs the jnp scan
// (src/repro/models/ssm.py:selective_scan_ref), whose order of float32
// operations this kernel keeps: dA = exp(dt·A), dBx = (dt·B)·x,
// h = dA·h + dBx, y = Σ_n h·C (n in order) + D·x.
//
// What bounds it on the H100: bytes.  Per (row, step, channel) it reads x
// and dt and writes y (10 bytes with bf16 x) for ~5·N operations plus N
// exponentials; the state h0 / h_final (b·Di·N float32) is read and written
// once.  Falcon-Mamba-7B's decode step (b = 16, S = 1, Di = 8192, N = 16)
// moves ~18 MB, most of it the state (~5.5 µs at 3.35 TB/s); its 8 × 80
// prefill ~57 MB (~17 µs).
//
// Design: the recurrence is sequential in time and independent per
// channel, so a thread owns one channel of one row with its N <= 16 state
// values and A's row in registers and loops over the steps; neighbouring
// threads take neighbouring channels, so the x, dt and y accesses of a
// warp are coalesced.  B_t and C_t, shared by every channel of a row, are
// staged in shared memory for a tile of 32 steps.  x, B and C are read in
// their own dtype (bf16 or float32) and dt in float32, all by their
// strides, so the model's column slices of x_proj are not copied.  Each
// thread reads its h0 before it writes its h_final, so h0 may alias h_out
// (a decode step updates the cache slab in place).  Built with the
// repository's -fmad=false: the state update rounds as the plain version's
// separate multiplies and adds; the y sum is held to a stated tolerance,
// since torch sums it in another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels of a block
constexpr int kMaxN = 16;       // state values per channel
constexpr int kTileT = 32;      // steps whose B_t, C_t are staged

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      const float* h0, float* h_out, float* __restrict__ y,
                      long long x_sb, long long x_ss, long long dt_sb,
                      long long dt_ss, long long b_sb, long long b_ss,
                      long long c_sb, long long c_ss, int S, int Di, int N) {
  __shared__ float b_s[kTileT][kMaxN];
  __shared__ float c_s[kTileT][kMaxN];

  const int row = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  const bool live = d < Di;
  const long long st = ((long long)row * Di + d) * N;   // state offset

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = live && n < N ? A[(long long)d * N + n] : 0.0f;
    h[n] = live && n < N && h0 != nullptr ? h0[st + n] : 0.0f;
  }
  const float dd = live ? D[d] : 0.0f;
  const T* xr = x + row * x_sb + d;
  const float* dtr = dt + row * dt_sb + d;
  float* yr = y + (long long)row * S * Di + d;

  for (int t0 = 0; t0 < S; t0 += kTileT) {
    const int nt = min(kTileT, S - t0);
    __syncthreads();   // the previous tile's B and C are consumed
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      b_s[tt][n] = to_f(bm[row * b_sb + (t0 + tt) * b_ss + n]);
      c_s[tt][n] = to_f(cm[row * c_sb + (t0 + tt) * c_ss + n]);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const long long t = t0 + tt;
      const float xv = to_f(xr[t * x_ss]);
      const float dv = dtr[t * dt_ss];
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float da = expf(dv * a[n]);
          const float dbx = dv * b_s[tt][n] * xv;
          h[n] = da * h[n] + dbx;
          const float hc = h[n] * c_s[tt][n];
          acc = n == 0 ? hc : acc + hc;
        }
      }
      yr[t * Di] = acc + dd * xv;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_out[st + n] = h[n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, const void* h0, void* h_out, void* y,
           const long long* st, int B, int S, int Di, int N,
           cudaStream_t stream) {
  const dim3 grid(B, (Di + kThreads - 1) / kThreads);
  mamba_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const float*)dt, (const T*)bm, (const T*)cm,
      (const float*)A, (const float*)D, (const float*)h0, (float*)h_out,
      (float*)y, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], S,
      Di, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 float32, 1 bfloat16.  Strides in elements (batch,
// step) of x, dt, B and C, whose last dimension is contiguous; A (Di, N),
// D (Di,), h0 and h_out (B, Di, N) contiguous float32, h0 null for zeros
// and allowed to alias h_out; y (B, S, Di) contiguous float32.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* bm,
                                 const void* cm, const void* A, const void* D,
                                 const void* h0, void* h_out, void* y,
                                 long long x_sb, long long x_ss,
                                 long long dt_sb, long long dt_ss,
                                 long long b_sb, long long b_ss,
                                 long long c_sb, long long c_ss, int B, int S,
                                 int Di, int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, bm, cm, A, D, h0, h_out, y, st, B, S, Di, N,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, A, D, h0, h_out, y, st, B, S,
                                 Di, N, s);
  return (int)cudaErrorInvalidValue;
}
