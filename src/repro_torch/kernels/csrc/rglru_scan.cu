// RG-LRU scan (RecurrentGemma's recurrent mixer): a_t = exp(la ⊙ r_t),
// h_t = a_t ⊙ h_{t-1} + sqrt(max(1 − a_t², 1e-12)) ⊙ (i_t ⊙ x_t), y_t = h_t,
// from a given or zero h0, returning the final h.
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
// RecurrentGemma-9B's decode step (B = 16, S = 1, W = 4096) moves ~1.5 MB
// (~0.44 µs at 3.35 TB/s), its 8 × 80 prefill ~37 MB (~11 µs).
//
// Design.  Only h = a·h + b is serial, two operations a step; the gates
// a_t and b_t = sqrt(max(1 − a_t², 1e-12))·(i_t·x_t) depend on no earlier
// step.  So a prefill takes them off the chain (the staged kernel): a block
// owns kC = 32 channels of one row, so an 8 × 80 prefill at W = 4096 runs
// 1,024 blocks, ~8 an SM.  It stages tiles of kT = 32 steps × kC channels of
// x, r and i in shared memory by 16-byte cp.async, double-buffered: the
// next tile's copies are in flight while the block works on this one.  All
// 128 threads compute the tile's a_t and b_t in place; then one thread per
// channel walks h = a·h + b down the tile from shared memory and leaves
// h_t in b's slot; then all threads store the tile's y as coalesced 16-byte
// stores.  W not a multiple of 8, or an operand not 16-byte aligned, takes
// the generic instantiation: element loads and stores, the same order.  A
// short call (S <= kDirectMaxS: the decode step) takes the direct kernel,
// where the staged one would only add its barriers: one thread per (row,
// channel) walks the steps (loading steps ahead in registers costs the
// decode step time and loses the prefill, tools/kernel_variants.py).  x is
// read in its own dtype (bf16 or float32), so the model passes its bf16
// branch without a cast.  Each thread reads its h0
// before it writes its h_final, so h0 may alias h_out (a decode step updates
// the cache slab in place).  Built with the repository's -fmad=false, every
// operation rounds as the plain version's separate multiplies and adds, in
// its order (b is the product it adds to a·h); expf and the IEEE sqrtf are
// the functions torch calls, so both kernels equal the plain version bit
// for bit.
//
// One launch serves and trains: the pools' prefills and decode steps
// (kernels/rglru/ops.py rglru_scan), and RGLRUScanFn's forward in training,
// which saves its y (the states h_t) for rglru_scan_bwd.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads of a block (both kernels)
constexpr int kC = 32;            // channels of a staged block
constexpr int kT = 32;            // steps of a staged tile
constexpr int kDirectMaxS = 4;    // longest call the direct kernel takes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// b_t, the term the step adds to a_t·h
__device__ __forceinline__ float gate_b(float a, float i, float x) {
  return sqrtf(fmaxf(1.0f - a * a, 1e-12f)) * (i * x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel_direct(const T* __restrict__ x,
                             const float* __restrict__ r,
                             const float* __restrict__ ig,
                             const float* __restrict__ la,
                             const float* h0, float* h_out,
                             float* __restrict__ y, int S, int W) {
  const int row = blockIdx.x;
  const int w = blockIdx.y * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long st = (long long)row * W + w;
  const float l = la[w];
  float h = h0 != nullptr ? h0[st] : 0.0f;
  long long o = (long long)row * S * W + w;
  for (int t = 0; t < S; ++t, o += W) {
    const float a = expf(l * r[o]);
    h = a * h + gate_b(a, ig[o], to_f(x[o]));
    y[o] = h;
  }
  h_out[st] = h;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
struct Tile {
  float r[kT][kC];   // r_t, then a_t
  float i[kT][kC];   // i_t, then b_t, then h_t
  T x[kT][kC];
};

// Stage steps [t0, t0 + nt) of the block's wc channels into `tile`.
// kVec: 16-byte cp.async chunks (W % 8 == 0, aligned operands); else
// element loads.
template <typename T, bool kVec>
__device__ __forceinline__ void stage(Tile<T>& tile, const T* x,
                                      const float* r, const float* ig,
                                      long long base, int t0, int nt, int wc,
                                      int W) {
  if (kVec) {
    constexpr int kF = kC / 4;                 // float chunks of a step
    constexpr int kX = kC * sizeof(T) / 16;    // x chunks of a step
    for (int q = threadIdx.x; q < nt * kF; q += kThreads) {
      const int t = q / kF, c = q % kF * 4;
      if (c < wc) {
        const long long o = base + (long long)(t0 + t) * W + c;
        cp_async16(&tile.r[t][c], r + o);
        cp_async16(&tile.i[t][c], ig + o);
      }
    }
    for (int q = threadIdx.x; q < nt * kX; q += kThreads) {
      const int t = q / kX, c = q % kX * (16 / (int)sizeof(T));
      if (c < wc)
        cp_async16(&tile.x[t][c], x + base + (long long)(t0 + t) * W + c);
    }
  } else {
    for (int e = threadIdx.x; e < nt * kC; e += kThreads) {
      const int t = e / kC, c = e % kC;
      if (c < wc) {
        const long long o = base + (long long)(t0 + t) * W + c;
        tile.r[t][c] = r[o];
        tile.i[t][c] = ig[o];
        tile.x[t][c] = x[o];
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel_staged(const T* __restrict__ x,
                             const float* __restrict__ r,
                             const float* __restrict__ ig,
                             const float* __restrict__ la,
                             const float* h0, float* h_out,
                             float* __restrict__ y, int S, int W) {
  __shared__ __align__(16) Tile<T> tiles[2];
  __shared__ float la_s[kC];
  const int row = blockIdx.x, c0 = blockIdx.y * kC, tid = threadIdx.x;
  const int wc = min(kC, W - c0);               // channels of this block
  const long long base = (long long)row * S * W + c0;
  const long long st = (long long)row * W + c0 + tid;
  if (tid < wc) la_s[tid] = la[c0 + tid];
  float h = tid < wc && h0 != nullptr ? h0[st] : 0.0f;

  const int n_tiles = (S + kT - 1) / kT;
  stage<T, kVec>(tiles[0], x, r, ig, base, 0, min(kT, S), wc, W);
  cp_async_commit();
  for (int n = 0; n < n_tiles; ++n) {
    Tile<T>& tile = tiles[n & 1];
    const int t0 = n * kT, nt = min(kT, S - t0);
    if (n + 1 < n_tiles)      // the other buffer was freed at the last barrier
      stage<T, kVec>(tiles[(n + 1) & 1], x, r, ig, base, t0 + kT,
                     min(kT, S - t0 - kT), wc, W);
    cp_async_commit();
    cp_async_wait_one();      // this thread's copies of tile n landed
    __syncthreads();          // and every thread's
    // the gates, off the chain: every thread, every (step, channel)
    for (int e = tid; e < nt * kC; e += kThreads) {
      const int t = e / kC, c = e % kC;
      if (c < wc) {
        const float a = expf(la_s[c] * tile.r[t][c]);
        tile.i[t][c] = gate_b(a, tile.i[t][c], to_f(tile.x[t][c]));
        tile.r[t][c] = a;
      }
    }
    __syncthreads();
    // the chain: one thread per channel
    if (tid < wc) {
#pragma unroll 8
      for (int t = 0; t < nt; ++t) {
        h = tile.r[t][tid] * h + tile.i[t][tid];
        tile.i[t][tid] = h;
      }
    }
    __syncthreads();
    // y, coalesced
    if (kVec) {
      constexpr int kF = kC / 4;
      for (int q = tid; q < nt * kF; q += kThreads) {
        const int t = q / kF, c = q % kF * 4;
        if (c < wc)
          *reinterpret_cast<float4*>(y + base + (long long)(t0 + t) * W + c) =
              *reinterpret_cast<const float4*>(&tile.i[t][c]);
      }
    } else {
      for (int e = tid; e < nt * kC; e += kThreads) {
        const int t = e / kC, c = e % kC;
        if (c < wc) y[base + (long long)(t0 + t) * W + c] = tile.i[t][c];
      }
    }
    __syncthreads();          // the buffer is free for tile n + 2
  }
  if (tid < wc) h_out[st] = h;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* x, const void* r, const void* ig, const void* la,
           const void* h0, void* h_out, void* y, int B, int S, int W,
           cudaStream_t stream) {
  const T* xt = (const T*)x;
  const float *rt = (const float*)r, *it = (const float*)ig,
              *lt = (const float*)la, *h0t = (const float*)h0;
  float *ht = (float*)h_out, *yt = (float*)y;
  if (S <= kDirectMaxS) {
    const dim3 grid(B, (W + kThreads - 1) / kThreads);
    rglru_scan_kernel_direct<T><<<grid, kThreads, 0, stream>>>(
        xt, rt, it, lt, h0t, ht, yt, S, W);
  } else {
    const dim3 grid(B, (W + kC - 1) / kC);
    if (W % 8 == 0 && aligned16(x) && aligned16(r) && aligned16(ig) &&
        aligned16(y))
      rglru_scan_kernel_staged<T, true><<<grid, kThreads, 0, stream>>>(
          xt, rt, it, lt, h0t, ht, yt, S, W);
    else
      rglru_scan_kernel_staged<T, false><<<grid, kThreads, 0, stream>>>(
          xt, rt, it, lt, h0t, ht, yt, S, W);
  }
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
