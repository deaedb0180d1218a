// Fused temporal-gating cell (paper Eq. 5-6) for a batch of streams.
//
// Replaces: src/repro/kernels/temporal_gate/kernel.py:gate_cell (Pallas body
// _gate_kernel), the TPU kernel that rides the packed (d, 3m) and (m, 2m)
// GEMMs on the MXU for a (256, d) stream tile.
//
// What bounds it on the H100: operations.  Per stream it reads dx (d
// floats), h (m floats) and vol, and writes h' (m floats), tau and mean(g):
// about 0.43 KB for d = 35, m = 32, against ~2·(3dm + 3m² + m) ≈ 13.9 kFLOP
// of float32 arithmetic, so at M = 4096 the bytes (1.8 MB, 0.5 us at
// 3.35 TB/s) weigh less than the operations (56.9 MFLOP, 0.85 us at
// 67 TFLOP/s).  Compiled with -fmad=false, a multiply and an add are two
// instructions, so the float32 pipes need twice that: ~1.7 us.
//
// Design: a persistent grid of one 512-thread block per SM (at most one per
// 32-stream tile).  Each block copies the weights (W_x, U_gr, U_h, w_o and
// the biases: 26.5 KB at d = 35) into shared memory once, by 16-byte
// cp.async, then walks tiles of 32 streams, the next tile's dx, h and vol
// staged by cp.async while the current one computes.  A warp serves 2
// streams of a tile; lane j owns hidden unit j of both, with independent
// accumulators, so one shared load of a weight feeds 2 products and the
// products need no shuffle: the k-loop reads each stream's dx and h row as
// 16-byte broadcasts (rows padded to a multiple of 4 floats), two groups
// of four k a step.  16 warps of 2 streams beat 8 of 4 and 4 of 8 on the
// H100 (PERF.md): the products wait on shared-load latency more than they
// issue.  r·h, which
// U_h's product needs across units, goes through shared memory behind a
// warp barrier.  tau and mean(g) are the warp's butterfly sums over its
// lanes.  Every dot product sums k ascending, a multiply then an add (see
// madd), exactly as the first design of this kernel did (one warp per
// stream, the dx row broadcast by shuffles): the results are bit-equal to
// it, and within 1e-5 of torch's GEMM.  The tensor cores are not used:
// TF32 keeps ~3 digits, and the float32 SIMT bound is under a microsecond.
// Ragged B and d (1..64) are masked, not sent down another path.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kM = 32;             // hidden units: one a lane
constexpr int kWarps = 16;         // warps a block
constexpr int kS = 2;              // streams a warp, one accumulator set each
constexpr int kTile = kWarps * kS; // streams a tile
constexpr int kMaxD = 64;
constexpr int kBlocksPerSm = 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// one term of a dot product: the product rounded, then the sum
__device__ __forceinline__ float madd(float acc, float x, float w) {
  return acc + x * w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// n floats from global to shared (n % 4 == 0): 16-byte pieces where the
// source is 16-byte aligned, else one float at a time
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) {
      cp_async<16>(dst + i, src + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      cp_async<4>(dst + i, src + i);
    }
  }
}

struct Args {
  const float *dx, *h, *vol, *w_x, *u_gr, *b_g, *alpha, *b_r, *u_h, *b_h,
      *w_o, *b_o;
  float *h_out, *tau, *g_mean;
  int B, d;
};

// shared memory: the weights, then two buffers of a tile's dx (rows of dp
// floats), h and vol, then r·h of the tile
struct Layout {
  int dp, wx, ugr, uh, vec, buf, dx, hh, vol, rh, total;
  __host__ __device__ explicit Layout(int d) {
    dp = (d + 3) & ~3;
    wx = 0;
    ugr = wx + d * 3 * kM;
    uh = ugr + kM * 2 * kM;
    vec = uh + kM * kM;                    // w_o | b_g | b_r | b_h
    buf = vec + 4 * kM;
    dx = 0;                                // offsets inside a buffer
    hh = dx + kTile * dp;
    vol = hh + kTile * kM;
    rh = buf + 2 * buf_floats();
    total = rh + kTile * kM;
  }
  __host__ __device__ int buf_floats() const { return vol + kTile; }
};

// start the copies of tile t's dx, h and vol into buffer s_buf (rows past B
// are not copied: their lanes compute on stale values and store nothing)
__device__ __forceinline__ void stage_tile(const Args& a, const Layout& L,
                                           float* s_buf, int t) {
  const int s0 = t * kTile;
  const int rows = a.B - s0 < kTile ? a.B - s0 : kTile;
  const float* dx = a.dx + (size_t)s0 * a.d;
  for (int q = threadIdx.x; q < rows * a.d; q += blockDim.x) {
    const int s = q / a.d, k = q - s * a.d;
    cp_async<4>(s_buf + L.dx + s * L.dp + k, dx + q);
  }
  copy_floats(s_buf + L.hh, a.h + (size_t)s0 * kM, rows * kM);
  for (int s = threadIdx.x; s < rows; s += blockDim.x) {
    cp_async<4>(s_buf + L.vol + s, a.vol + s0 + s);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    gate_cell_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (a.B + kTile - 1) / kTile;
  const int d = a.d, dp = L.dp;

  // the weights, once per block
  copy_floats(smem + L.wx, a.w_x, d * 3 * kM);
  copy_floats(smem + L.ugr, a.u_gr, kM * 2 * kM);
  copy_floats(smem + L.uh, a.u_h, kM * kM);
  copy_floats(smem + L.vec, a.w_o, kM);
  copy_floats(smem + L.vec + kM, a.b_g, kM);
  copy_floats(smem + L.vec + 2 * kM, a.b_r, kM);
  copy_floats(smem + L.vec + 3 * kM, a.b_h, kM);
  cp_async_commit();
  int t = blockIdx.x;
  if (t < n_tiles) stage_tile(a, L, smem + L.buf, t);
  cp_async_commit();
  const float alpha = a.alpha[0], b_o = a.b_o[0];
  const float* s_wx = smem + L.wx;
  const float* s_ugr = smem + L.ugr;
  const float* s_uh = smem + L.uh;
  const float* s_vec = smem + L.vec;
  float* s_rh = smem + L.rh + warp * kS * kM;

  for (int buf = 0; t < n_tiles; t += gridDim.x, buf ^= 1) {
    if (t + (int)gridDim.x < n_tiles) {
      stage_tile(a, L, smem + L.buf + (buf ^ 1) * L.buf_floats(),
                 t + gridDim.x);
    }
    cp_async_commit();
    cp_async_wait<1>();            // the weights and this tile arrived
    __syncthreads();
    const float* s_buf = smem + L.buf + buf * L.buf_floats();
    const float* xs = s_buf + L.dx + warp * kS * dp;
    const float* hs = s_buf + L.hh + warp * kS * kM;

    // packed dx·W_x: columns j (g), m + j (r), 2m + j (candidate)
    float xg[kS], xr[kS], xh[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) xg[s] = xr[s] = xh[s] = 0.0f;
    const int d4 = d & ~3;
#pragma unroll 2
    for (int k = 0; k < d4; k += 4) {
      float wg[4], wr[4], wh[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = s_wx + (k + u) * 3 * kM;
        wg[u] = row[lane];
        wr[u] = row[kM + lane];
        wh[u] = row[2 * kM + lane];
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 x4 = *reinterpret_cast<const float4*>(xs + s * dp + k);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xg[s] = madd(xg[s], x[u], wg[u]);
          xr[s] = madd(xr[s], x[u], wr[u]);
          xh[s] = madd(xh[s], x[u], wh[u]);
        }
      }
    }
    for (int k = d4; k < d; ++k) {
      const float* row = s_wx + k * 3 * kM;
      const float wg = row[lane], wr = row[kM + lane], wh = row[2 * kM + lane];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float x = xs[s * dp + k];
        xg[s] = madd(xg[s], x, wg);
        xr[s] = madd(xr[s], x, wr);
        xh[s] = madd(xh[s], x, wh);
      }
    }
    // packed h·U_gr: columns j (g), m + j (r)
    float hg[kS], hr[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) hg[s] = hr[s] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < kM; k += 4) {
      float wg[4], wr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = s_ugr + (k + u) * 2 * kM;
        wg[u] = row[lane];
        wr[u] = row[kM + lane];
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 h4 = *reinterpret_cast<const float4*>(hs + s * kM + k);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          hg[s] = madd(hg[s], hv[u], wg[u]);
          hr[s] = madd(hr[s], hv[u], wr[u]);
        }
      }
    }
    float g[kS], hj[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      hj[s] = hs[s * kM + lane];
      const float vol = s_buf[L.vol + warp * kS + s];
      g[s] = sigmoidf_(xg[s] + hg[s] + s_vec[kM + lane] + alpha * vol);
      const float r = sigmoidf_(xr[s] + hr[s] + s_vec[2 * kM + lane]);
      s_rh[s * kM + lane] = r * hj[s];
    }
    __syncwarp();
    float c[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) c[s] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < kM; k += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = s_uh[(k + u) * kM + lane];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 r4 = *reinterpret_cast<const float4*>(s_rh + s * kM + k);
        c[s] = madd(c[s], r4.x, w[0]);
        c[s] = madd(c[s], r4.y, w[1]);
        c[s] = madd(c[s], r4.z, w[2]);
        c[s] = madd(c[s], r4.w, w[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int b = t * kTile + warp * kS + s;
      const float cand = tanhf(xh[s] + c[s] + s_vec[3 * kM + lane]);
      const float hn = (1.0f - g[s]) * hj[s] + g[s] * cand;
      const float tsum = warp_sum(hn * s_vec[lane]);
      const float gs = warp_sum(g[s]);
      if (b < a.B) {               // warp-uniform
        a.h_out[(size_t)b * kM + lane] = hn;
        if (lane == 0) {
          a.tau[b] = sigmoidf_(tsum + b_o);
          a.g_mean[b] = gs / (float)kM;
        }
      }
    }
    __syncthreads();               // the buffer and r·h are free again
  }
  cp_async_wait<0>();
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
  if (m != kM || d < 1 || d > kMaxD || B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  static int card = -1, sms = 0;       // the device and its SMs, read once
  static bool opted_in = false;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != card) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    card = dev;
    opted_in = false;
  }
  const size_t smem = sizeof(float) * (size_t)Layout(kMaxD).total;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gate_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const Args a{(const float*)dx,   (const float*)h,    (const float*)vol,
               (const float*)w_x,  (const float*)u_gr, (const float*)b_g,
               (const float*)alpha, (const float*)b_r, (const float*)u_h,
               (const float*)b_h,  (const float*)w_o,  (const float*)b_o,
               (float*)h_out,      (float*)tau,        (float*)g_mean,
               B,                  d};
  const int n_tiles = (B + kTile - 1) / kTile;
  const int cap = kBlocksPerSm * sms;
  const int grid = n_tiles < cap ? n_tiles : cap;
  gate_cell_kernel<<<grid, kWarps * 32,
                     sizeof(float) * (size_t)Layout(d).total,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
