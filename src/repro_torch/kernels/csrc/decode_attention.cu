// Decode attention: one query token per batch row against that row's KV
// cache, GQA, masked at a per-row length — one block per (row, KV head).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:decode_attention
// (Pallas body _decode_kernel), whose grid walks (B·KV, cache tiles) in
// order on one TPU core, keeps the online-softmax state (m, l, acc) in VMEM
// scratch across the tiles and skips the tiles past `length`.
//
// What bounds it on the H100: bytes.  Each (row, KV head) reads its first
// `length` cache entries of K and V once (2·length·D values) for 4·G·D
// operations per entry: about one operation per byte in bf16, far below
// the ~295 at which the tensor cores would bound it.  At the serving slab
// (B = 16, S = 144, Qwen3-8B's KV = 8, D = 128) a full cache is 9.4 MB per
// layer per step, ~2.8 µs at 3.35 TB/s.
//
// Design: a block of four warps holds its G query rows (G <= 16; the
// kernel is instantiated for up to 8 and up to 16 rows) in shared
// memory as float and loops over tiles of 64 cache entries up to the row's
// length, so tiles past it are never read.  Scores: each warp takes every
// fourth entry, its lanes split D into neighbouring element pairs (a warp
// reads a whole 128- or 256-byte cache row per load), four entries' loads
// in flight before their warp sums give the G scores of each.  Softmax: one warp per query row updates (m, l) in float32
// from the float32 scores and rounds each probability to the value type
// for the P·V product, as the TPU kernel does; l sums the unrounded ones.
// P·V: thread groups own one element pair of D each and split the tile's
// entries, their partial sums added in a fixed order at the end, which
// divides by max(l, 1e-30).  The caches are read by strides (only D is
// contiguous), so the model's (B, S, KV, D) slab is read in place.
// Built with the repository's -fmad=false like every source; the kernel is
// held to a stated tolerance, not to the plain version's bits (its sums run
// in another order), so the flag costs it only the fused multiply-adds.
// Split-K over the cache (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // cache entries per tile: two per lane
constexpr int kMaxGroup = 16;  // query heads per KV head: G <= 8 or 16
constexpr int kMaxPairs = 4;   // element pairs per lane: D <= 256
constexpr int kMaxD = 2 * 32 * kMaxPairs;
constexpr int kBatch = 4;      // cache entries a warp loads before reducing

template <typename T, int kMaxG>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ length, T* __restrict__ out,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb,
                            long long v_sh, long long v_ss, int H, int KV,
                            int S, int D, float scale) {
  __shared__ float q_s[kMaxG * kMaxD];     // query rows, then the P·V sums
  __shared__ float p_s[kMaxG][kTile];      // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int G = H / KV;
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pairs = D >> 1;
  const int len = min(max(length[b], 0), S);

  for (int i = tid; i < G * pairs; i += kThreads) {
    const int g = i / pairs, c = i % pairs;
    const float2 x = Elem<T>::load2(q + b * q_sb + (kh * G + g) * q_sh + 2 * c);
    q_s[g * D + 2 * c] = x.x;
    q_s[g * D + 2 * c + 1] = x.y;
  }
  if (tid < G) {
    m_s[tid] = kAttnNegInf;
    l_s[tid] = 0.0f;
  }
  // P·V ownership: element pair `my_pair`, entries j ≡ my_group (mod groups)
  const int groups = kThreads / pairs;
  const int my_pair = tid % pairs, my_group = tid / pairs;
  const bool pv = my_group < groups;
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.0f;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    // each warp scores entries warp, warp + 4, ...: kBatch of them at a
    // time, their loads issued before the first reduction
    for (int u0 = 0; u0 < kTile / kWarps; u0 += kBatch) {
      float2 kk[kBatch][kMaxPairs];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = warp + kWarps * (u0 + u);
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          const int c = lane + 32 * i;
          kk[u][i] = j < n && c < pairs
                         ? Elem<T>::load2(kb + (t0 + j) * k_ss + 2 * c)
                         : make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = warp + kWarps * (u0 + u);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float dot = 0.0f;
#pragma unroll
            for (int i = 0; i < kMaxPairs; ++i) {
              const int c = lane + 32 * i;
              if (c < pairs) {
                dot += q_s[g * D + 2 * c] * kk[u][i].x;
                dot += q_s[g * D + 2 * c + 1] * kk[u][i].y;
              }
            }
            const float sum = warp_sum(dot);
            if (lane == 0) p_s[g][j] = j < n ? sum * scale : kAttnNegInf;
          }
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const float a = p_s[g][lane], c = p_s[g][lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = lane < n ? expf(a - m_new) : 0.0f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.0f;
      const float sum = warp_sum(pa + pc);
      p_s[g][lane] = Elem<T>::round(pa);
      p_s[g][lane + 32] = Elem<T>::round(pc);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    if (pv) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          acc[g][0] *= corr_s[g];
          acc[g][1] *= corr_s[g];
        }
      }
#pragma unroll 4
      for (int j = my_group; j < n; j += groups) {
        const float2 vv = Elem<T>::load2(vb + (t0 + j) * v_ss + 2 * my_pair);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float p = p_s[g][j];
            acc[g][0] += p * vv.x;
            acc[g][1] += p * vv.y;
          }
        }
      }
    }
    __syncthreads();
  }

  // the groups' partial sums, added in group order into q_s
  for (int gr = 0; gr < groups; ++gr) {
    if (pv && my_group == gr) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float* dst = q_s + g * D + 2 * my_pair;
          dst[0] = gr == 0 ? acc[g][0] : dst[0] + acc[g][0];
          dst[1] = gr == 0 ? acc[g][1] : dst[1] + acc[g][1];
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < G * pairs; i += kThreads) {
    const int g = i / pairs, c = i % pairs;
    const float l = fmaxf(l_s[g], 1e-30f);
    Elem<T>::store2(out + ((long long)b * H + kh * G + g) * D + 2 * c,
                    q_s[g * D + 2 * c] / l, q_s[g * D + 2 * c + 1] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, long long q_sb, long long q_sh, long long k_sb,
           long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, int B, int H, int KV, int S, int D, float scale,
           cudaStream_t stream) {
  // groups of up to 8 rows (the dense tiers' G = 1 and 4) take the 8-row
  // instantiation: the 16-row one took 83 µs instead of 55 at Qwen3-8B's
  // slab (chip_smoke.py on an H100 80GB HBM3 at 700 W)
  auto kernel = H / KV <= 8 ? decode_attention_kernel<T, 8>
                            : decode_attention_kernel<T, kMaxGroup>;
  kernel<<<B * KV, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)length, (T*)out,
      q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, H, KV, S, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements; out is (B, H, D)
// contiguous; scale is D^-0.5 as the caller rounds it to float.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* length, void* out,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int B,
    int H, int KV, int S, int D, float scale, int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup || D < 2 || D % 2 ||
      D > kMaxD || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, length, out, q_sb, q_sh, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss, B, H, KV, S, D, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, out, q_sb, q_sh, k_sb, k_sh,
                                 k_ss, v_sb, v_sh, v_ss, B, H, KV, S, D, scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}
