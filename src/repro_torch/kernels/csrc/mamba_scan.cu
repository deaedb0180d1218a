// Selective scan (Mamba-1 mixer): h_t = exp(dt_t·A) ⊙ h_{t-1} + dt_t·B_t·x_t,
// y_t = C_t·h_t + D ⊙ x_t, from a given or zero h0, returning the final h —
// a quad of lanes per (batch row, channel), a block per 64 channels of a
// row.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py:selective_scan (Pallas
// body _mamba_kernel), whose grid walks (b, channel blocks, time tiles) with
// the time tiles innermost and in order on one TPU core and keeps the
// (BD, N) state in VMEM scratch across them, so that x, dt, B and C are read
// once and y written once.  The reference model runs the jnp scan
// (src/repro/models/ssm.py:selective_scan_ref), whose order of float32
// operations this kernel keeps in the state update: dA = exp(dt·A),
// dBx = (dt·B)·x, h = dA·h + dBx (the exponential taken in base 2, below);
// y = Σ_n h·C + D·x sums in another order.
//
// What bounds it on the H100: bytes at a decode step, exponentials at a
// prefill.  Per (row, step, channel) it reads x and dt and writes y (10
// bytes with bf16 x) for ~7·N float32 operations and N exponentials; the
// state h0 / h_final (b·Di·N float32) is read and written once.
// Falcon-Mamba-7B's decode step (b = 16, S = 1, Di = 8192, N = 16) moves
// ~18.6 MB, most of it the state (~5.6 µs at 3.35 TB/s); its 8 × 80
// prefill moves ~57 MB (~17 µs) but needs 83.9 M exponentials, ~20 µs at
// the SFU's 16 a clock per SM, and ~8 instructions of each lane's step
// around each of them.
//
// Design: the recurrence is sequential in time and independent per
// (row, channel) and per state value.  A quad of 4 lanes owns one channel of
// one row, each lane 4 of its N <= 16 state values and the matching 4 of A's
// row, so a warp covers 8 neighbouring channels and a block of 256 threads
// 64.  With N = 16 the state h0 / h_final (b, Di, N) and A (Di, N) are read
// and written as one float4 a lane: a warp instruction moves 512
// contiguous bytes (a thread per channel would read them with a 64-byte
// stride between lanes, 32 sectors for 128 useful bytes).  N < 16,
// or a state or A not 16-byte aligned, takes the generic instantiation:
// scalar accesses, lanes past N masked.  For a tile of 32 steps, B_t and
// C_t (shared by every channel of a row) and the block's x_t and dt_t are
// staged in shared memory by coalesced loads, all in flight at once,
// before the steps run.  Each lane sums its 4 terms of y = Σ_n h·C, the quad
// adds its partial sums with two shuffles, and lane 0 of the quad adds D·x
// and stores y.  x, B and C are read in their own dtype (bf16 or float32)
// and dt in float32, all by their strides, so the model's column slices of
// x_proj are not copied.  Each lane reads its h0 before it writes its
// h_final, so h0 may alias h_out (a decode step updates the cache slab in
// place).  The step loop is unrolled by 4, so that one step's exponentials
// run while the previous step's y is reduced.  dA is 2^(dt·(A·log2 e)),
// A scaled once per lane, by one ex2.approx.ftz on the SFU (relative error
// ~2^-22; results below 2^-126, an update that keeps under 1e-38 of h, are
// flushed to 0): IEEE expf costs ~8 more instructions around each
// exponential, exp2f ~3 (tools/kernel_variants.py times the forms).  Built
// with the repository's -fmad=false: the state update keeps the plain
// version's separate multiplies and adds, in its order; it and the y sum,
// which torch takes in another order, are held to a stated tolerance.
//
// One entry point, two launches: with h_tiles null it serves (the pools'
// prefills and decode steps, kernels/mamba_scan/ops.py selective_scan);
// with h_tiles it trains (SelectiveScanFn's forward, once a step and again
// under remat): it also stores the state entering each 32-step tile, which
// mamba_scan_bwd.cu recomputes from, and gives the serving launch's y and
// h bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sfu.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                       // lanes of a channel
constexpr int kPerLane = 4;                     // state values of a lane
constexpr int kChannels = kThreads / kLanes;    // channels of a block
constexpr int kMaxN = kLanes * kPerLane;        // state values per channel
constexpr int kTileT = 32;                      // steps staged at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kVec: N == 16 with A, h0 and h_out 16-byte aligned (float4 accesses)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      const float* h0, float* h_out, float* __restrict__ y,
                      float* __restrict__ h_tiles,
                      long long x_sb, long long x_ss, long long dt_sb,
                      long long dt_ss, long long b_sb, long long b_ss,
                      long long c_sb, long long c_ss, int S, int Di, int N) {
  __shared__ __align__(16) float b_s[kTileT][kMaxN];
  __shared__ __align__(16) float c_s[kTileT][kMaxN];
  __shared__ float x_s[kTileT][kChannels];
  __shared__ float dt_s[kTileT][kChannels];

  const int row = blockIdx.x;
  const int c0 = blockIdx.y * kChannels;
  const int ch = threadIdx.x / kLanes, lane_q = threadIdx.x % kLanes;
  const int d = c0 + ch;
  const bool live = d < Di;
  const int n0 = lane_q * kPerLane;             // this lane's first state
  const long long st = ((long long)row * Di + d) * N + n0;

  float a[kPerLane], h[kPerLane];
  if (kVec) {
    const float4 z4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a4 =
        live ? *reinterpret_cast<const float4*>(A + (long long)d * N + n0) : z4;
    const float4 h4 = live && h0 != nullptr
                          ? *reinterpret_cast<const float4*>(h0 + st)
                          : z4;
    a[0] = a4.x, a[1] = a4.y, a[2] = a4.z, a[3] = a4.w;
    h[0] = h4.x, h[1] = h4.y, h[2] = h4.z, h[3] = h4.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const bool in = live && n0 + i < N;
      a[i] = in ? A[(long long)d * N + n0 + i] : 0.0f;
      h[i] = in && h0 != nullptr ? h0[st + i] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) a[i] *= 1.4426950408889634f;   // log2(e)
  const float dd = live ? D[d] : 0.0f;
  float* yr = y + (long long)row * S * Di + d;

  for (int t0 = 0; t0 < S; t0 += kTileT) {
    const int nt = min(kTileT, S - t0);
    if (h_tiles != nullptr && live) {   // the training launch: h entering
      float* ht = h_tiles +             // the tile, for the backward
                  (((long long)row * ((S + kTileT - 1) / kTileT) +
                    t0 / kTileT) * Di + d) * N + n0;
      if (kVec) {
        *reinterpret_cast<float4*>(ht) = make_float4(h[0], h[1], h[2], h[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          if (n0 + i < N) ht[i] = h[i];
      }
    }
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      b_s[tt][n] = to_f(bm[row * b_sb + (t0 + tt) * b_ss + n]);
      c_s[tt][n] = to_f(cm[row * c_sb + (t0 + tt) * c_ss + n]);
    }
    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      const long long t = t0 + tt;
      const bool in = c0 + cc < Di;
      x_s[tt][cc] = in ? to_f(x[row * x_sb + t * x_ss + c0 + cc]) : 0.0f;
      dt_s[tt][cc] = in ? dt[row * dt_sb + t * dt_ss + c0 + cc] : 0.0f;
    }
    __syncthreads();
    // every lane runs the steps (dead channels on zeros): the quad's
    // shuffles need the whole warp
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const float xv = x_s[tt][ch];
      const float dv = dt_s[tt][ch];
      float bv[kPerLane], cv[kPerLane];
      if (kVec) {
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[tt][n0]);
        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[tt][n0]);
        bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
        cv[0] = c4.x, cv[1] = c4.y, cv[2] = c4.z, cv[3] = c4.w;
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          bv[i] = n0 + i < N ? b_s[tt][n0 + i] : 0.0f;
          cv[i] = n0 + i < N ? c_s[tt][n0 + i] : 0.0f;
        }
      }
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (kVec || n0 + i < N) {
          const float da = ex2_approx(dv * a[i]);
          const float dbx = dv * bv[i] * xv;
          h[i] = da * h[i] + dbx;
          acc += h[i] * cv[i];
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (live && lane_q == 0) yr[(long long)(t0 + tt) * Di] = acc + dd * xv;
    }
  }
  if (!live) return;
  if (kVec) {
    *reinterpret_cast<float4*>(h_out + st) = make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (n0 + i < N) h_out[st + i] = h[i];
  }
}

template <typename T, bool kVec>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, const void* h0, void* h_out, void* y,
           void* h_tiles, const long long* st, int B, int S, int Di, int N,
           cudaStream_t stream) {
  const dim3 grid(B, (Di + kChannels - 1) / kChannels);
  mamba_scan_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const float*)dt, (const T*)bm, (const T*)cm,
      (const float*)A, (const float*)D, (const float*)h0, (float*)h_out,
      (float*)y, (float*)h_tiles, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], S,
      Di, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* bm, const void* cm,
             const void* A, const void* D, const void* h0, void* h_out,
             void* y, void* h_tiles, const long long* st, int B, int S,
             int Di, int N, cudaStream_t stream) {
  const uintptr_t base = (uintptr_t)A | (uintptr_t)h0 | (uintptr_t)h_out |
                         (uintptr_t)h_tiles;
  if (N == kMaxN && base % 16 == 0)
    return launch<T, true>(x, dt, bm, cm, A, D, h0, h_out, y, h_tiles, st, B,
                           S, Di, N, stream);
  return launch<T, false>(x, dt, bm, cm, A, D, h0, h_out, y, h_tiles, st, B,
                          S, Di, N, stream);
}

int launch_dtype(const void* x, const void* dt, const void* bm,
                 const void* cm, const void* A, const void* D, const void* h0,
                 void* h_out, void* y, void* h_tiles, const long long* st,
                 int B, int S, int Di, int N, int dtype, cudaStream_t s) {
  if (B < 1 || S < 1 || Di < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_n<float>(x, dt, bm, cm, A, D, h0, h_out, y, h_tiles, st, B,
                           S, Di, N, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, bm, cm, A, D, h0, h_out, y,
                                   h_tiles, st, B, S, Di, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B and C): 0 float32, 1 bfloat16.  Strides in elements (batch,
// step) of x, dt, B and C, whose last dimension is contiguous; A (Di, N),
// D (Di,), h0 and h_out (B, Di, N) contiguous float32, h0 null for zeros
// and allowed to alias h_out; y (B, S, Di) contiguous float32; h_tiles null
// (serving) or (B, ⌈S/32⌉, Di, N) contiguous float32 (training), which
// receives the state entering each tile of kTileT = 32 steps (h0 or zeros
// first) and leaves y and h_out the serving launch's bits.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* bm,
                                 const void* cm, const void* A, const void* D,
                                 const void* h0, void* h_out, void* y,
                                 void* h_tiles, long long x_sb, long long x_ss,
                                 long long dt_sb, long long dt_ss,
                                 long long b_sb, long long b_ss,
                                 long long c_sb, long long c_ss, int B, int S,
                                 int Di, int N, int dtype, void* stream) {
  const long long st[8] = {x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  return launch_dtype(x, dt, bm, cm, A, D, h0, h_out, y, h_tiles, st, B, S,
                      Di, N, dtype, (cudaStream_t)stream);
}
