// Backward of the selective scan (Mamba-1 mixer): the vector-Jacobian
// product of mamba_scan.cu's h_t = exp(dt_t·A) ⊙ h_{t-1} + dt_t·B_t·x_t,
// y_t = C_t·h_t + D ⊙ x_t.
//
// Replaces: no TPU kernel.  src/repro/kernels/mamba_scan/kernel.py:
// selective_scan has no backward; the reference trains its jnp scan
// (src/repro/models/ssm.py:selective_scan_ref) by JAX autodiff.  The port
// runs no plain version on the card, so SelectiveScanFn
// (kernels/mamba_scan/ops.py) takes its gradient here.  The plain version
// is kernels/mamba_scan/ref.py:selective_scan_vjp_ref.
//
// Inputs: x (B, S, Di), B, C (B, S, N) in float32 or bf16 and dt (B, S, Di)
// float32, read by their strides as the forward reads them; A (Di, N),
// D (Di,); h_tiles (B, ⌈S/32⌉, Di, N), the state entering each 32-step
// tile, which mamba_scan.cu's training launch stores; dy (B, S, Di) and dh
// (B, Di, N) or null, the cotangents of y and of the final state.
// Outputs: dx (B, S, Di) in x's dtype, ddt (B, S, Di), dB, dC (B, S, N)
// contiguous in B's dtype, dA (Di, N), dD (Di,) and dh0 (B, Di, N), float32.
//
// The cotangent of h_t walks backward, g_t = dy_t·C_t + dA_{t+1}·g_{t+1}
// (from dh), with dA_t = exp(dt_t·A); with z = (g·h_{t-1})·dA_t and
// gx = g·x: dC_t = Σ_d dy·h_t, dB_t = Σ_d gx·dt, ddt = Σ_n (z·A + gx·B),
// dx = dt·Σ_n g·B + D·dy, dA = Σ_{b,t} z·dt, dD = Σ_{b,t} dy·x and
// dh0 = dA_0·g_0.
//
// What bounds it on the H100: bytes and operations, close together.
// Falcon-Mamba-7B's training shape (B = 8, S = 512, Di = 8192, N = 16) moves
// ~0.61 GB (x, dt, dy and the stored states in; dx and ddt out: ~0.18 ms at
// 3.35 TB/s) for ~12 GFLOP (0.18 ms at 67 TFLOP/s) and 537 M exponentials
// (~0.13 ms at the SFU's 16 a clock per SM).  This kernel takes each
// exponential twice (below), its dB/dC partials add ~0.13 GB, and it
// issues ~150 instructions a step and lane: what held it back was the
// issue of a few warps an SM, not the memory.
//
// Design.  Storing every h_t is out of the question ((8, 512, 8192, 16)
// float32 is 2.1 GB a layer), so the forward's training launch keeps the
// state at each 32-step boundary (67 MB a layer) and this kernel recomputes
// each tile from it, in the forward's layout and arithmetic: a quad of
// lanes per (row, channel), each lane 4 of its N <= 16 state values, a
// block of 256 threads per 64 channels of a row, the tile's B, C, x, dt and
// dy staged in shared memory by coalesced loads, and dA = 2^(dt·(A·log2 e))
// by the same ex2.approx.ftz with -fmad=false, so that the recomputed h
// equals the forward's bit for bit.  The tiles are walked from the last to
// the first.  A tile is recomputed once to find the state entering each of
// its eight 4-step sub-tiles (registers); then, from the last sub-tile to
// the first, its 4 steps are recomputed with h_{t-1} and dA_t kept in
// registers, and walked in reverse.  Short sub-tiles and a cap of 128
// registers a thread give two blocks an SM with no spill; the backward's
// own arithmetic contracts its multiply-adds (__fmaf_rn), which the
// recompute of h must not (the first design, with 8-step sub-tiles, one
// block an SM and no contraction, took 2.90 ms at the training shape in
// chip_smoke.py on an H100 80GB HBM3 at 700 W).  A
// step's dx and ddt are sums over the channel's N values: 4 in a lane,
// then two shuffles over the quad;
// the results replace dy and dt in shared memory and are stored coalesced
// at the tile's end.  dB_t and dC_t are sums over all Di channels: a warp
// sums its 8 channels' 8 values of a lane by a reduce-scatter butterfly (7
// shuffles: each lane ends with one of the warp's 32 sums), a sub-tile's
// sums wait in shared memory, and the block sums its 8 warps in order into
// its row of a (Di/64, B, S, 2N) partials buffer.  dA and dD are summed
// per lane over the steps in registers into a (B, Di·N + Di) buffer.  A
// second kernel (fixed_sum.cuh) sums the partials over the blocks, and
// another over the rows, in order: no float atomics, so two launches give
// the same bits.  The sums take another order than torch's, and are held
// to a stated tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"
#include "sfu.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                       // lanes of a channel
constexpr int kPerLane = 4;                     // state values of a lane
constexpr int kChannels = kThreads / kLanes;    // channels of a block
constexpr int kMaxN = kLanes * kPerLane;        // state values per channel
constexpr int kTileT = 32;      // mamba_scan.cu's tile: h_tiles' spacing
constexpr int kSub = 4;         // steps kept in registers at once
constexpr int kSubs = kTileT / kSub;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum each of v[0..7] over the 8 quads of the warp (the lanes that share
// lane % 4), one sum kept a lane: lane l ends with the sum of index
// 4·bit2(l) + 2·bit3(l) + bit4(l).
__device__ __forceinline__ float quads_reduce_scatter(const float (&v)[8],
                                                      int lane) {
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  float w4[4], w2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = b2 ? v[k] : v[k + 4];
    w4[k] = (b2 ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = b3 ? w4[k] : w4[k + 2];
    w2[k] = (b3 ? w4[k + 2] : w4[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b4 ? w2[0] : w2[1];
  return (b4 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, send, 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mamba_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          const float* __restrict__ A,
                          const float* __restrict__ D,
                          const float* __restrict__ h_tiles,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh, T* __restrict__ dx,
                          float* __restrict__ ddt, float* __restrict__ part_bc,
                          float* __restrict__ part_ad,
                          float* __restrict__ dh0, float* __restrict__ h_last,
                          long long x_sb, long long x_ss, long long dt_sb,
                          long long dt_ss, long long b_sb, long long b_ss,
                          long long c_sb, long long c_ss, int S, int Di,
                          int N) {
  __shared__ float b_s[kTileT][kMaxN];
  __shared__ float c_s[kTileT][kMaxN];
  __shared__ float x_s[kTileT][kChannels];
  __shared__ float dt_s[kTileT][kChannels];   // dt_t, then ddt_t
  __shared__ float dy_s[kTileT][kChannels];   // dy_t, then dx_t
  __shared__ float red[kWarps][kSub][32];     // a sub-tile's warp sums

  const int row = blockIdx.x, blk = blockIdx.y, rows = gridDim.x;
  const int c0 = blk * kChannels;
  const int ch = threadIdx.x / kLanes, lane_q = threadIdx.x % kLanes;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = c0 + ch;
  const bool live = d < Di;
  const int n0 = lane_q * kPerLane;             // this lane's first state
  const int n_tiles = (S + kTileT - 1) / kTileT;
  const long long st = ((long long)row * Di + d) * N + n0;
  const long long ad_row = (long long)row * (Di * N + Di);

  bool on[kPerLane];
  float a[kPerLane], a2[kPerLane], carry[kPerLane], da_sum[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    on[i] = live && n0 + i < N;
    a[i] = on[i] ? A[(long long)d * N + n0 + i] : 0.0f;
    a2[i] = a[i] * 1.4426950408889634f;         // log2(e), as the forward
    carry[i] = on[i] && dh != nullptr ? dh[st + i] : 0.0f;
    da_sum[i] = 0.0f;
  }
  const float dd = live ? D[d] : 0.0f;
  float dd_sum = 0.0f;

  for (int n = n_tiles - 1; n >= 0; --n) {
    const int t0 = n * kTileT, nt = min(kTileT, S - t0);
    __syncthreads();   // the previous tile's dx and ddt are stored
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      const int tt = i / N, nn = i % N;
      b_s[tt][nn] = to_f(bm[row * b_sb + (t0 + tt) * b_ss + nn]);
      c_s[tt][nn] = to_f(cm[row * c_sb + (t0 + tt) * c_ss + nn]);
    }
    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      const long long t = t0 + tt;
      const bool in = c0 + cc < Di;
      x_s[tt][cc] = in ? to_f(x[row * x_sb + t * x_ss + c0 + cc]) : 0.0f;
      dt_s[tt][cc] = in ? dt[row * dt_sb + t * dt_ss + c0 + cc] : 0.0f;
      dy_s[tt][cc] = in ? dy[((long long)row * S + t) * Di + c0 + cc] : 0.0f;
    }
    __syncthreads();

    // the state entering each sub-tile, recomputed from the tile's
    float h[kPerLane], hs[kSubs][kPerLane];
    const float* ht =
        h_tiles + (((long long)row * n_tiles + n) * Di + d) * N + n0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) h[i] = on[i] ? ht[i] : 0.0f;
#pragma unroll
    for (int k = 0; k < kSubs; ++k) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) hs[k][i] = h[i];
      if (k + 1 == kSubs) break;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = k * kSub + j;
        if (tt < nt) {
          const float xv = x_s[tt][ch], dv = dt_s[tt][ch];
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            if (on[i]) {
              const float da = ex2_approx(dv * a2[i]);
              const float dbx = dv * b_s[tt][n0 + i] * xv;
              h[i] = da * h[i] + dbx;
            }
          }
        }
      }
    }

#pragma unroll
    for (int k = kSubs - 1; k >= 0; --k) {
      if (k * kSub >= nt) continue;             // the same for the block
      // the sub-tile's steps: h_{t-1} and dA_t into registers
      float hp[kSub][kPerLane], ea[kSub][kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) h[i] = hs[k][i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = k * kSub + j;
        if (tt < nt) {
          const float xv = x_s[tt][ch], dv = dt_s[tt][ch];
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            hp[j][i] = h[i];
            ea[j][i] = 0.0f;
            if (on[i]) {
              ea[j][i] = ex2_approx(dv * a2[i]);
              const float dbx = dv * b_s[tt][n0 + i] * xv;
              h[i] = ea[j][i] * h[i] + dbx;
            }
          }
        }
      }
      // ... walked in reverse; h is h_t
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int tt = k * kSub + j;
        if (tt >= nt) continue;
        const float xv = x_s[tt][ch], dv = dt_s[tt][ch], gy = dy_s[tt][ch];
        if (h_last != nullptr && t0 + tt == S - 1) {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            if (on[i]) h_last[st + i] = h[i];
        }
        float v[2 * kPerLane];    // dB terms, then dC terms
        float sgb = 0.0f, sdt = 0.0f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const float bv = on[i] ? b_s[tt][n0 + i] : 0.0f;
          const float cv = on[i] ? c_s[tt][n0 + i] : 0.0f;
          const float g = __fmaf_rn(gy, cv, carry[i]);
          v[kPerLane + i] = gy * h[i];
          const float z = g * hp[j][i] * ea[j][i];
          const float gx = g * xv;
          v[i] = gx * dv;
          sdt = __fmaf_rn(z, a[i], __fmaf_rn(gx, bv, sdt));
          sgb = __fmaf_rn(g, bv, sgb);
          da_sum[i] = __fmaf_rn(z, dv, da_sum[i]);
          carry[i] = ea[j][i] * g;
          h[i] = hp[j][i];
        }
        dd_sum = __fmaf_rn(gy, xv, dd_sum);
        sgb += __shfl_xor_sync(0xffffffffu, sgb, 1);
        sgb += __shfl_xor_sync(0xffffffffu, sgb, 2);
        sdt += __shfl_xor_sync(0xffffffffu, sdt, 1);
        sdt += __shfl_xor_sync(0xffffffffu, sdt, 2);
        red[warp][j][lane] = quads_reduce_scatter(v, lane);
        // every lane of the quad read dy and dt before the shuffles
        if (lane_q == 0) {
          dy_s[tt][ch] = __fmaf_rn(dv, sgb, dd * gy);
          dt_s[tt][ch] = sdt;
        }
      }
      __syncthreads();
      // the sub-tile's dB and dC partials: a (step, value) a thread
      for (int e = threadIdx.x; e < kSub * 32; e += kThreads) {
        const int j = e / 32, l = e % 32;
        const int tt = k * kSub + j;
        const int idx = ((l >> 2) & 1) * 4 + ((l >> 3) & 1) * 2 + ((l >> 4) & 1);
        const int nn = (l & 3) * kPerLane + (idx & 3);
        if (tt < nt && nn < N) {
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += red[w][j][l];
          part_bc[(((long long)blk * rows + row) * S + t0 + tt) * (2 * N) +
                  (idx >= 4 ? N : 0) + nn] = sum;
        }
      }
      __syncthreads();   // red is free for the next sub-tile
    }
    // the tile's dx and ddt, coalesced
    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int tt = i / kChannels, cc = i % kChannels;
      if (c0 + cc < Di) {
        const long long o = ((long long)row * S + t0 + tt) * Di + c0 + cc;
        fixed_sum::store(dx + o, dy_s[tt][cc]);
        ddt[o] = dt_s[tt][cc];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (on[i]) {
      if (dh0 != nullptr) dh0[st + i] = carry[i];
      part_ad[ad_row + (long long)d * N + n0 + i] = da_sum[i];
    }
  }
  if (live && lane_q == 0) part_ad[ad_row + (long long)Di * N + d] = dd_sum;
}

template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, const void* h_tiles, const void* dy,
           const void* dh, void* dx, void* ddt, void* dB, void* dC,
           void* part_bc, void* part_ad, void* dAD, void* dh0, void* h_last,
           const long long* st, int B, int S, int Di, int N,
           cudaStream_t stream) {
  const int blocks = (Di + kChannels - 1) / kChannels;
  mamba_scan_bwd_kernel<T><<<dim3(B, blocks), kThreads, 0, stream>>>(
      (const T*)x, (const float*)dt, (const T*)bm, (const T*)cm,
      (const float*)A, (const float*)D, (const float*)h_tiles,
      (const float*)dy, (const float*)dh, (T*)dx, (float*)ddt,
      (float*)part_bc, (float*)part_ad, (float*)dh0, (float*)h_last, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], S, Di, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dB and dC: over the channel blocks; dA and dD: over the rows
  fixed_sum::sum_leading<T>((const float*)part_bc, blocks,
                            (long long)B * S * 2 * N, 2 * N, N, (T*)dB,
                            (T*)dC, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long J = (long long)Di * N + Di;
  fixed_sum::sum_leading<float>((const float*)part_ad, B, J, (int)J, Di * N,
                                (float*)dAD, (float*)dAD + (long long)Di * N,
                                stream);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C, dx, dB and dC): 0 float32, 1 bfloat16.  Strides in
// elements (batch, step) of x, dt, B and C, whose last dimension is
// contiguous; A (Di, N), D (Di,), h_tiles (B, ⌈S/32⌉, Di, N), dy, dx and
// ddt (B, S, Di), dh and dh0 (B, Di, N), dB and dC (B, S, N), contiguous;
// dAD (Di·N + Di: dA, then dD); scratch part_bc (⌈Di/64⌉·B·S·2N floats) and
// part_ad (B·(Di·N + Di) floats).  dh null for zeros; dh0 and h_last (B,
// Di, N: receives the recomputed state of the last step) may be null.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* A, const void* D, const void* h_tiles, const void* dy,
    const void* dh, void* dx, void* ddt, void* dB, void* dC, void* part_bc,
    void* part_ad, void* dAD, void* dh0, void* h_last, long long x_sb,
    long long x_ss, long long dt_sb, long long dt_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, int B, int S, int Di,
    int N, int dtype, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, bm, cm, A, D, h_tiles, dy, dh, dx, ddt, dB,
                         dC, part_bc, part_ad, dAD, dh0, h_last, st, B, S, Di,
                         N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, A, D, h_tiles, dy, dh, dx,
                                 ddt, dB, dC, part_bc, part_ad, dAD, dh0,
                                 h_last, st, B, S, Di, N, s);
  return (int)cudaErrorInvalidValue;
}
