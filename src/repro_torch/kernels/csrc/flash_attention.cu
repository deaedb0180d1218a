// Flash (prefill) attention: causal GQA attention, optionally
// sliding-window or non-causal — one block per (batch row · KV head, query
// tile) with the G query heads of the KV head folded into the tile's rows.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention
// (Pallas body _flash_kernel), whose grid walks (B·KV, q tiles, k tiles)
// with the k tiles innermost and in order on one TPU core, keeps the online
// softmax state (m, l, acc) in VMEM scratch across them, folds the GQA
// group into the MXU's rows, multiplies bf16 operands with float32
// accumulation and skips the fully masked k tiles.  It asserts that Sq and
// Sk are multiples of its tiles; this kernel takes any lengths and masks
// the ragged edge itself.
//
// What bounds it on the H100: bytes, at the serving shapes.  A prefill of
// Sq = Sk <= 80 tokens reads q, k and v and writes the output once: a
// (row, KV head) holds ~Sq·D·(2G + 2) values for ~2·G·Sq²·D causal
// operations, tens of operations per byte in bf16, under the ~295 at which
// the tensor cores would bound it.  What the kernel has to avoid is
// latency: few key tiles per block, so loads must be wide and in flight
// while the previous tile computes.
//
// Common to both paths: a block of 128 threads owns 64 query rows (G heads
// × 64/G positions, so a block always fills its rows) and loops over key
// tiles from the first one a row of the tile may see (window) to the last
// one (causal), so fully masked tiles are never loaded.  The online
// softmax keeps (m, l) in float32 per row, sums l from the float32
// probabilities and rounds each probability to the value type before P·V,
// as the TPU kernel does; masked entries get probability 0; the output is
// divided by max(l, 1e-30).  q, k and v are read by strides (only D is
// contiguous), so the model's (B, S, H, D) projections are passed as
// permuted views, not copies.
//
// bfloat16 (the tier pools' type), flash_attention_kernel_bf16: the
// products run on the tensor cores, mma.sync m16n8k16 bf16 → float32.
// Each of the 4 warps owns 16 query rows.  Q (64 rows) and tiles of 32 keys
// of K and V are staged in shared memory as bf16 with 16-byte cp.async,
// the K/V tiles double-buffered (the next tile loads while the current one
// computes); rows are padded by 16 bytes so that the 8 row addresses of an
// ldmatrix fall in distinct banks.  32-key tiles keep the shared memory at
// 52 KB (D = 128) and 101 KB (D = 256), so that a prefill's blocks fit the
// card in one wave: 64-key tiles took 1.1–1.5× as long at the serving
// shapes (tools/kernel_variants.py).  S = Q·Kᵀ takes Q and K fragments
// through ldmatrix (Q re-read from shared memory at every k-step, so the
// registers hold only the 16 × 32 scores and the 16 × D output, D/2 + 16
// floats a thread, no spill at D = 256); the softmax runs on the
// accumulator fragments (a row lives on a quad of lanes: max and sum by
// two shuffles); P, rounded to bf16 in registers, is the A operand of
// O += P·V with V through ldmatrix.trans.  The output tile goes through
// the warp's own rows of the Q buffer and leaves in 16-byte stores.  Every
// row start must lie on a 16-byte boundary (the wrapper checks).  Scores
// are scaled by D^-0.5·log2(e) and exponentiated by ex2.approx on the SFU;
// each row's visible keys are one range [lo, hi), and each row's q and
// output offsets are computed once into shared memory, so that neither
// the softmax nor the copies spend instructions on masks, exp2f's range
// handling or divisions by BQ: at these shapes the kernel is bound by its
// instructions' latency, not by the tensor cores.  The training launch
// (a non-null lse) also stores each live row's log-sum-exp once, after the
// key loop, as m + log2(max(l, 1e-30)): in log2 units of the scaled scores,
// the base that ex2.approx here and the backward kernels
// (flash_attention_bwd.cu) exponentiate in, so P = 2^(s·D^-0.5·log2 e −
// lse).  A row that sees no key stores about -1e30 (its gradients are
// masked to zero).  The output's arithmetic is the serving launch's, so its
// bits are too.  The tensor-core helpers live in mma_bf16.cuh.
//
// float32, flash_attention_kernel_simt<float, D>: float32 multiply-adds on
// the CUDA cores (the tensor cores have no float32 product of full
// precision): tiles of 32 keys, two threads per row, each computing 16 of a
// tile's scores from shared memory, rows padded by one float.  The same
// kernel takes bfloat16 at the head dims under one m16n8k16 product's
// depth and width (D = 8 and 16, the SMOKE tier models of the serve
// launcher): operands widened to float32 as they are staged, each
// probability rounded to bf16 before P·V (l summed from the float32
// ones), the output rounded to bf16.  This kernel writes no LSE (its
// backward, the CUDA-core kernels, recomputes the row statistics): the
// launch refuses a non-null lse.
//
// Runtime positions (kPos, both paths): with an int32 (B, S) positions
// tensor (self-attention, Sq = Sk), query i sees key j iff pos[i] >= pos[j]
// and, with a window, pos[i] - pos[j] < window: the reference model's
// chunked_attention mask (src/repro/models/attention.py), which M-RoPE's
// temporal stream drives.  Positions need not grow with the index, so the
// block visits every key tile (k_lo = 0, k_hi = Sk) and masks each score
// from its row's position (a register) and the tile's key positions
// (staged in shared memory beside the K/V tile).  Every row sees its own
// key, so no row is empty.  Without positions (kPos false) the kernels are
// the index-masked ones, instruction for instruction.
//
// Built with the repository's -fmad=false like every source; the kernel is
// held to a stated tolerance, not to the plain version's bits (its sums run
// in another order).  wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attention.cuh"
#include "mma_bf16.cuh"
#include "sfu.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;             // query rows of a block (G × BQ)

// ---------------------------------------------------------------- float32

constexpr int kKeysF32 = 32;              // keys of a tile
constexpr int kPerThread = kKeysF32 / 2;  // scores per thread of a row's pair

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_bytes_f32() {
  return (int)sizeof(float) * (kRows * (D + 1) + kKeysF32 * (D + 1) +
                               kKeysF32 * D + kRows * (kKeysF32 + 1));
}

template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel_simt(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const int* __restrict__ pos,
                                T* __restrict__ out,
                                long long q_sb, long long q_sh, long long q_ss,
                                long long k_sb, long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh, long long v_ss,
                                int H, int KV, int Sq, int Sk, int BQ,
                                int window, int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kRows][D + 1], then the output
  float* k_s = q_s + kRows * (D + 1);       // [kKeysF32][D + 1]
  float* v_s = k_s + kKeysF32 * (D + 1);    // [kKeysF32][D]
  float* p_s = v_s + kKeysF32 * D;          // [kRows][kKeysF32 + 1]
  __shared__ int kpos_s[kKeysF32];          // the tile's key positions

  const int G = H / KV;
  const int R = G * BQ;                     // rows in use (<= kRows)
  const int b = blockIdx.y / KV, kh = blockIdx.y % KV;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / BQ, qpos = q0 + r % BQ;
    q_s[r * (D + 1) + d] =
        r < R && qpos < Sq
            ? to_f(q[b * q_sb + (kh * G + g) * q_sh + qpos * q_ss + d])
            : 0.0f;
  }

  // this thread's row and half of the tile's keys
  const int r = tid >> 1, half = tid & 1;
  const bool live = r < R && q0 + r % BQ < Sq;
  const int qpos = q0 + (r < R ? r % BQ : 0);
  const int* pb = kPos ? pos + (long long)b * Sk : nullptr;
  const int qp = kPos && live ? pb[qpos] : 0;   // the row's position
  float m = kAttnNegInf, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  // keys any row of the tile may see: [k_lo, k_hi) (all, by positions)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal && !kPos ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 && !kPos ? max(0, q0 - window + 1) : 0;

  for (int t0 = k_lo - k_lo % kKeysF32; t0 < k_hi; t0 += kKeysF32) {
    __syncthreads();   // q_s loaded; the previous tile's P·V done
    for (int i = tid; i < kKeysF32 * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool in = t0 + j < Sk;
      k_s[j * (D + 1) + d] = in ? to_f(kb[(t0 + j) * k_ss + d]) : 0.0f;
      v_s[j * D + d] = in ? to_f(vb[(t0 + j) * v_ss + d]) : 0.0f;
    }
    if (kPos && tid < kKeysF32)
      kpos_s[tid] = t0 + tid < Sk ? pb[t0 + tid] : 0;
    __syncthreads();

    float s[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        s[i] += qd * k_s[(half + 2 * i) * (D + 1) + d];
    }
    bool ok[kPerThread];
    float mx = kAttnNegInf;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int kpos = t0 + half + 2 * i;
      if (kPos) {
        const int kp = kpos_s[half + 2 * i];
        ok[i] = live && kpos < Sk && qp >= kp &&
                (window <= 0 || qp - kp < window);
      } else {
        ok[i] = live && kpos < Sk && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
      }
      s[i] = ok[i] ? s[i] * scale : kAttnNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.0f;
      sum += p;
      // P·V takes the probability in the value type (a no-op in float32)
      p_s[r * (kKeysF32 + 1) + half + 2 * i] = to_f(from_f<T>(p));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < kKeysF32; ++j) {
      const float p = p_s[r * (kKeysF32 + 1) + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += p * v_s[j * D + half + 2 * i];
    }
  }

  __syncthreads();
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    q_s[r * (D + 1) + half + 2 * i] = acc[i] / l_safe;
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int g = rr / BQ, qp = q0 + rr % BQ;
    if (qp < Sq)
      out[(((long long)b * H + kh * G + g) * Sq + qp) * D + d] =
          from_f<T>(q_s[rr * (D + 1) + d]);
  }
}

// --------------------------------------------------------------- bfloat16

constexpr int kKeys = 32;             // keys of a tile
constexpr int kWarpRows = 16;         // query rows of a warp (one m16 tile)

constexpr int kPad = 8;               // bf16 padding (16 bytes) of a shared row

// Q, then two K and two V tiles
template <int D>
constexpr int smem_bytes_bf16() {
  return (kRows + 4 * kKeys) * (D + kPad) * (int)sizeof(__nv_bfloat16);
}

// registers capped for 4 blocks an SM (2 at D = 256), as many as the shared
// memory admits
template <int D, bool kPos>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 4 : 2)
    flash_attention_kernel_bf16(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
        __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
        long long q_sb, long long q_sh, long long q_ss, long long k_sb,
        long long k_sh, long long k_ss, long long v_sb, long long v_sh,
        long long v_ss, int H, int KV, int Sq, int Sk, int BQ, int window,
        int causal, float scale_log2) {
  constexpr int LD = D + kPad;              // elements of a shared row
  constexpr int kChunks = D / 8;            // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kRows * LD;    // [2][kKeys][LD]
  __nv_bfloat16* v_s = k_s + 2 * kKeys * LD;  // [2][kKeys][LD]

  const int G = H / KV;
  const int R = G * BQ;                     // rows in use (<= kRows)
  const int b = blockIdx.y / KV, kh = blockIdx.y % KV;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;
  const int* pb = kPos ? pos + (long long)b * Sk : nullptr;
  __shared__ int kpos_s[2][kKeys];          // key positions of the K/V tiles

  // element offsets of each row's q and output (-1: a row not in use),
  // one division by BQ per row
  __shared__ long long q_off[kRows], o_off[kRows];
  if (tid < kRows) {
    const int g = tid / BQ, qpos = q0 + tid % BQ;
    const bool in = tid < R && qpos < Sq;
    q_off[tid] = in ? b * q_sb + (kh * G + g) * q_sh + qpos * q_ss : -1;
    o_off[tid] = in ? (((long long)b * H + kh * G + g) * Sq + qpos) * D : -1;
  }
  __syncthreads();

  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const long long off = q_off[r];
    cp_async16(smem_addr(q_s + r * LD + c * 8), off >= 0 ? q + off + c * 8 : q,
               off >= 0);
  }

  // keys any row of the tile may see: [k_lo, k_hi), in tiles from t_first
  // (every key, by positions)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal && !kPos ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 && !kPos ? max(0, q0 - window + 1) : 0;
  const int t_first = k_lo - k_lo % kKeys;
  const int n_tiles = k_hi > t_first ? (k_hi - t_first + kKeys - 1) / kKeys : 0;

  auto load_kv = [&](int t0, int buf) {
    __nv_bfloat16* kd = k_s + buf * kKeys * LD;
    __nv_bfloat16* vd = v_s + buf * kKeys * LD;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < Sk;
      const long long key = t0 + j;
      cp_async16(smem_addr(kd + j * LD + c * 8),
                 in ? kb + key * k_ss + c * 8 : kb, in);
      cp_async16(smem_addr(vd + j * LD + c * 8),
                 in ? vb + key * v_ss + c * 8 : vb, in);
    }
    // read after the barrier that follows this tile's cp.async wait
    if (kPos && tid < kKeys) kpos_s[buf][tid] = t0 + tid < Sk ? pb[t0 + tid] : 0;
  };

  if (n_tiles > 0) load_kv(t_first, 0);
  cp_async_commit();                        // Q and the first tile

  // this lane's two rows of the warp's 16: gq and gq + 8; its columns of
  // an 8-wide fragment: 2·tq and 2·tq + 1
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row address
  int lo[2], hi[2];                         // keys [lo, hi) a row sees
  int qp[2];                                // kPos: the row's position
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * kWarpRows + gq + 8 * h;
    const int pos = q0 + (r < R ? r % BQ : 0);
    const bool live = r < R && pos < Sq;
    if (kPos) {           // index bounds only; the positions mask the rest
      hi[h] = live ? Sk : 0;
      lo[h] = 0;
      qp[h] = live ? pb[pos] : 0;
    } else {
      hi[h] = !live ? 0 : causal ? min(pos + 1, Sk) : Sk;
      lo[h] = window > 0 ? pos - window + 1 : 0;
    }
  }
  float m[2] = {kAttnNegInf, kAttnNegInf}, l[2] = {0.0f, 0.0f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  const uint32_t q_row =
      smem_addr(q_s + (warp * kWarpRows + (mi & 1) * 8 + mr) * LD +
                (mi >> 1) * 8);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * kKeys, buf = it & 1;
    if (it + 1 < n_tiles) load_kv(t0 + kKeys, buf ^ 1);
    cp_async_commit();                      // (empty on the last tile)
    cp_async_wait<1>();                     // this tile (and Q) arrived
    __syncthreads();

    // S = Q·Kᵀ: 16 rows × kKeys keys a warp, in fragments of 8 keys
    const __nv_bfloat16* kt = k_s + buf * kKeys * LD;
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_row + kk * 16 * (int)sizeof(__nv_bfloat16));
#pragma unroll
      for (int j = 0; j < kKeys / 8; j += 2) {
        uint32_t bk[4];   // keys of fragments j and j + 1, d lo and hi
        ldmatrix_x4(bk, smem_addr(kt + ((j + (mi >> 1)) * 8 + mr) * LD +
                                  kk * 16 + (mi & 1) * 8));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask, scale to log2 units, and the online softmax per row
    static_assert(kKeys <= 64, "one mask bit per score of a lane");
    uint32_t ok = 0;                        // bit 4·j + e: entry s[j][e]
    float mx[2] = {kAttnNegInf, kAttnNegInf};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kpos = t0 + j * 8 + 2 * tq + (e & 1);
        bool in = kpos >= lo[h] && kpos < hi[h];
        if (kPos) {
          const int kp = kpos_s[buf][j * 8 + 2 * tq + (e & 1)];
          in = in && qp[h] >= kp && (window <= 0 || qp[h] - kp < window);
        }
        ok |= (uint32_t)in << (4 * j + e);
        s[j][e] = in ? s[j][e] * scale_log2 : kAttnNegInf;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2_approx(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = (ok >> (4 * j + e)) & 1u ? ex2_approx(s[j][e] - m[h]) : 0.0f;
        sum[h] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P·V: P (bf16) from the score fragments, 16 keys a step
    const __nv_bfloat16* vt = v_s + buf * kKeys * LD;
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t v_row =
          smem_addr(vt + (kc * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];   // d fragments n and n + 1, keys lo and hi
        ldmatrix_x4_trans(bv, v_row + n * 8 * (int)sizeof(__nv_bfloat16));
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with buf before it is reloaded
  }

  // epilogue: O / max(l, 1e-30) in bf16 into the warp's own Q rows, then
  // 16-byte stores of the rows in use
  cp_async_wait<0>();
  __syncthreads();
  const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
  // the training launch: each live row's LSE in log2 units of the scaled
  // scores (the base of ex2 above and of the backward kernels), once
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long off = o_off[warp * kWarpRows + gq + 8 * h];
      if (off >= 0) lse[off / D] = m[h] + log2f(fmaxf(l[h], 1e-30f));
    }
  }
  __nv_bfloat16* o_s = q_s + (warp * kWarpRows + gq) * LD + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(o_s + n * 8) =
        __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(o_s + 8 * LD + n * 8) =
        __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < kWarpRows * kChunks; i += 32) {
    const int rr = warp * kWarpRows + i / kChunks, c = i % kChunks;
    const long long off = o_off[rr];
    if (off < 0) continue;
    *reinterpret_cast<uint4*>(out + off + c * 8) =
        *reinterpret_cast<const uint4*>(q_s + rr * LD + c * 8);
  }
}

// Lets `fn` take `bytes` of dynamic shared memory on the current device,
// once per device (`done`: a bit per device ordinal, one set per kernel).
template <typename F>
cudaError_t allow_smem(F* fn, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <typename T, int D, bool kPos>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* lse, const long long* st, int B, int H, int KV,
           int Sq, int Sk, int BQ, int window, int causal, float scale,
           cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const dim3 grid((Sq + BQ - 1) / BQ, B * KV);
  if constexpr (std::is_same<T, float>::value || D < 32) {
    if (lse != nullptr) return (int)cudaErrorInvalidValue;   // writes none
    constexpr int smem = smem_bytes_f32<D>();
    cudaError_t e =
        allow_smem(flash_attention_kernel_simt<T, D, kPos>, smem, done);
    if (e != cudaSuccess) return (int)e;
    flash_attention_kernel_simt<T, D, kPos><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, pos, (T*)out, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], H, KV, Sq, Sk, BQ,
        window, causal, scale);
  } else {
    constexpr int smem = smem_bytes_bf16<D>();
    cudaError_t e =
        allow_smem(flash_attention_kernel_bf16<D, kPos>, smem, done);
    if (e != cudaSuccess) return (int)e;
    const float log2e = 1.4426950408889634f;
    flash_attention_kernel_bf16<D, kPos><<<grid, kThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, pos, (__nv_bfloat16*)out, lse, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], H, KV, Sq,
        Sk, BQ, window, causal, scale * log2e);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_p(const void* q, const void* k, const void* v, const int* pos,
             void* out, float* lse, const long long* st, int B, int H,
             int KV, int Sq, int Sk, int BQ, int window, int causal,
             float scale, cudaStream_t stream) {
  return pos ? launch<T, D, true>(q, k, v, pos, out, lse, st, B, H, KV, Sq,
                                  Sk, BQ, window, causal, scale, stream)
             : launch<T, D, false>(q, k, v, pos, out, lse, st, B, H, KV, Sq,
                                   Sk, BQ, window, causal, scale, stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* pos,
             void* out, float* lse, const long long* st, int B, int H,
             int KV, int Sq, int Sk, int D, int BQ, int window, int causal,
             float scale, cudaStream_t stream) {
#define FA_CASE(DD)                                                       \
  case DD:                                                               \
    return launch_p<T, DD>(q, k, v, pos, out, lse, st, B, H, KV, Sq, Sk, \
                           BQ, window, causal, scale, stream);
  switch (D) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements (batch, head, position
// of q, k and v); out is (B, H, Sq, D) contiguous.  In bfloat16 every row
// start (the pointers and the strides in bytes) is a multiple of 16 bytes.
// BQ query positions per block with G·BQ <= 64; window 0 means none; scale
// is D^-0.5 as the caller rounds it to float.  pos: null, or int32 (B, S)
// contiguous positions of causal self-attention (Sq = Sk, causal = 1).
// lse: null (the serving launch), or float32 (B·H·Sq) for each row's
// log2-sum-exp of the scaled scores (the training launch; bf16 at D >= 32
// only, the tensor-core kernel), written without changing out's bits.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* lse, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int B, int H, int KV, int Sq, int Sk, int D, int BQ,
    int window, int causal, float scale, int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || BQ < 1 ||
      (H / KV) * BQ > kRows || window < 0 ||
      (pos && (Sq != Sk || !causal)))
    return (int)cudaErrorInvalidValue;
  const int* p = (const int*)pos;
  float* l = (float*)lse;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, p, out, l, st, B, H, KV, Sq, Sk, D, BQ,
                           window, causal, scale, s);
  if (dtype == 1) {
    const uintptr_t base = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                           (uintptr_t)out;
    for (int i = 0; i < 9; ++i)
      if (st[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
    if (base % 16 != 0) return (int)cudaErrorMisalignedAddress;
    return launch_d<__nv_bfloat16>(q, k, v, p, out, l, st, B, H, KV, Sq, Sk,
                                   D, BQ, window, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
