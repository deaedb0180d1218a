// Backward of the flash (prefill) attention: dQ, dK and dV of causal,
// sliding-window, non-causal or positions-masked GQA attention, two kernels
// a call on one stream.
//
// Replaces: no TPU kernel.  The JAX package has no backward Pallas kernel:
// its training step differentiates the model's jnp chunked_attention
// (src/repro/models/attention.py:285-291) with jax.grad.  The port trains
// on the forward kernel (csrc/flash_attention.cu) through
// FlashAttentionFn, and this is its backward.
//
// The gradient of O = softmax(scale·Q·Kᵀ, masked)·V for an incoming dO:
//   P = exp(scale·Q·Kᵀ − LSE)   (LSE: the row's log of its sum of exp)
//   Δ = rowsum(dO ∘ O)
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − Δ),
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q.
// Float32 accumulation throughout; each output rounded once to the input
// type.  No float atomics: every sum runs in a fixed order, so two
// launches give the same bits (and a resumed training run its losses).
//
// What bounds it on the H100: at the training shape (Qwen1.5-0.5B: B 8,
// H = KV 16, S 512, D 64, causal, bf16) the function moves 67.1 MB (q, k,
// v, o and dO read once, dq, dk and dv written once: 0.020 ms at 3.35
// TB/s) and its five products over the visible pairs are 10.76 GFLOP
// (0.0109 ms at 989 TFLOP/s in bf16): bytes, by less than 2×, so the
// products must run on the tensor cores to stay under the bytes.  The two
// kernels below do not share their scores (dQ sums over keys, dK and dV
// over queries, and a shared pass would need float atomics for one of
// them): each recomputes S and dP, so the card does seven products, not
// five (15.1 GFLOP, 0.0152 ms).  The design keeps both recomputations on
// the tensor cores and reads the row statistics instead of rebuilding
// them.
//
// Tensor-core design (bf16 at D = 32, 64, 128 and 256, every row start on
// a 16-byte boundary): every product is mma.sync m16n8k16 bf16 → float32
// on tiles staged with 16-byte cp.async, double-buffered, rows padded by
// 16 bytes so that the 8 row addresses of an ldmatrix fall in distinct
// banks (the forward's layout and helpers, mma_bf16.cuh).  The forward's
// training launch stored each row's LSE in log2 units of the scaled
// scores (m + log2 l over 2^(s·D^-0.5·log2 e), the base of its
// ex2.approx), and both kernels exponentiate in that base: P =
// ex2.approx(s·D^-0.5·log2 e − LSE), one SFU op an entry, no pass over the
// key tiles to rebuild (m, l).  Masked entries are 0 by their mask, never
// by the exponential, so a row that sees no key (LSE about -1e30) gets
// zero gradients, not NaN.
// 1. fa_bwd_dq_kernel_mma, one block of 4 warps per (batch row · KV head,
//    query tile), the forward's row layout (G heads × BQ positions, 64
//    rows, 16 a warp), the tiles with the most keys launched first: Q and
//    dO staged once; Δ = rowsum(dO∘O) from 16-byte loads while the copies
//    fly, written to a float32 scratch for the dk/dv kernel; then one pass
//    over the key tiles of 32 a row may see: S = Q·Kᵀ and dP = dO·Vᵀ on the
//    tensor cores, P and dS = P∘(dP − Δ) on the accumulator fragments,
//    and dQ += dS·K with dS rounded to bf16 in registers as the A operand
//    and K through ldmatrix.trans (D/2 floats of dQ a thread).
// 2. fa_bwd_dkv_kernel_mma, one block of 4 warps per (batch row · KV head,
//    64 keys), 16 keys a warp: K and V staged once; it walks the G query
//    heads of its KV group in order and, for each, the query tiles of 64
//    that may see its keys (Q, dO, LSE and Δ of the next tile copied while
//    the current one computes): Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with the keys as
//    rows, so Pᵀ and dSᵀ sit in the accumulator fragments and become the
//    A operands of dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q through
//    ldmatrix.trans (dK and dV: D floats a thread).  At D = 256 that would
//    be 256 floats a thread: built in one pass it took 255 registers and
//    spilled 1,824 bytes a thread (980 with 32-query tiles; ptxas -v) and
//    took 1.8-2.4× as long, so there the blocks split into a dV half and
//    a dK half (blockIdx.z, kSplitDkv), D/2 floats a thread each and no
//    spill, at the cost of Sᵀ formed in both halves (eight products a
//    call, not seven).
// The dk/dv kernel's query tiles are 64 wide, not 32: 4-18% faster at the
// timed shapes (tools/kernel_variants.py, in turns), for 8 bytes a thread
// spilled at D = 128 (16 with positions; ptxas -v).  The dq kernel's key
// tiles stay 32 wide: 64 took as long, within the noise, with more
// registers.  Skipping the mask arithmetic on the tiles that a lane's rows
// see whole was 2-8% slower than masking every tile.
// The two kernels form S in different fragment orders, so P need not have
// the same bits in both; each is within the tolerance of the plain
// version.  P is rounded to bf16 before dV += Pᵀ·dO, as the forward
// rounds it before P·V, and dS before its two products.
//
// CUDA-core design (the first design: float32 multiply-adds; float32 at
// every D, since the tensor cores have no full-precision float32 product,
// and bf16 at D = 8 and 16, under one m16n8k16's depth): it reads no LSE.
// 1. fa_bwd_dq_kernel, one block of 128 threads per (batch row · KV head,
//    query tile) with the forward's row layout (two threads a row, each 16
//    of a 32-key tile's scores): Δ from O and dO; a first pass over the
//    key tiles for (m, l) by the online rule; the row's (m, 1/max(l,
//    1e-30), Δ) written to a float32 scratch (3, B·H·Sq); a second pass
//    over the same tiles for S, dP, P and dS, and dQ += dS·K in registers
//    (D/2 values a thread).
// 2. fa_bwd_dkv_kernel, one block per (batch row · KV head, 32-key tile),
//    four threads a key (each D/4 of its dK and dV in registers and 8 of a
//    32-query tile's scores): it walks the G query heads of its KV group in
//    order and, for each, the query tiles that may see its keys, reads the
//    rows' statistics from the scratch, recomputes S and dP, and sums
//    dV += Pᵀ·dO and dK += dSᵀ·Q.  The scores are the dq kernel's products
//    in the same order, so P has the same bits in both kernels.
// Operands are read by strides (only D contiguous), element by element,
// and widened to float32 as they are staged, one shared-memory read a
// multiply-add: 1.90-1.97 ms at the training shape against the
// tensor-core design's 0.110-0.115 (an H100 80GB HBM3 at 700 W, in
// turns).
//
// Which design runs is fixed by the dtype and D (kTensorCores), never by a
// failure.  dQ is (B, H, Sq, D), dK and dV (B, KV, Sk, D), contiguous.
// Built with the repository's -fmad=false like every source.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attention.cuh"
#include "mma_bf16.cuh"
#include "sfu.cuh"

namespace {

// ------------------------------------------------- CUDA cores (first design)

constexpr int kThreads = 128;
constexpr int kRows = 64;         // dq kernel: query rows of a block (G × BQ)
constexpr int kKeys = 32;         // dq kernel: keys of a tile
constexpr int kHalf = kKeys / 2;  // dq kernel: scores a thread of a row pair
constexpr int kKeyRows = 32;      // dkv kernel: keys of a block
constexpr int kQueries = 32;      // dkv kernel: queries of a tile
constexpr int kQuarter = kQueries / 4;  // dkv kernel: scores a thread

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* pos;      // int32 (B, S) positions, or null
  void* dq;
  void* dk;
  void* dv;
  float* stats;        // (3, B·H·Sq): m, 1/max(l, 1e-30), Δ (the
                       // tensor-core design uses Δ only)
  const float* lse;    // (B·H·Sq) the forward's LSE, log2 units, or null
  long long sq[3], sk[3], sv[3], so[3], sd[3];  // (batch, head, position)
  int B, H, KV, Sq, Sk, BQ, window, causal;
  float scale;         // D^-0.5
  float scale_log2;    // D^-0.5·log2 e, the forward's
};

// query position qpos (pos qp) sees key position kpos (pos kp)
template <bool kPos>
__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos, int kpos,
                                        int qp, int kp) {
  if (kPos) return qp >= kp && (a.window <= 0 || qp - kp < a.window);
  return (!a.causal || qpos >= kpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

template <int D>
constexpr int dq_smem_bytes() {
  return (int)sizeof(float) *
         (2 * kRows * (D + 1) + 2 * kKeys * (D + 1) + kRows * (kKeys + 1));
}

template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kRows][D + 1], then dQ
  float* do_s = q_s + kRows * (D + 1);      // [kRows][D + 1]
  float* k_s = do_s + kRows * (D + 1);      // [kKeys][D + 1]
  float* v_s = k_s + kKeys * (D + 1);       // [kKeys][D + 1]
  float* ds_s = v_s + kKeys * (D + 1);      // [kRows][kKeys + 1]
  __shared__ int kpos_s[kKeys];             // the tile's key positions

  const T* q = static_cast<const T*>(a.q);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const int G = a.H / a.KV, BQ = a.BQ, R = G * BQ;
  const int b = blockIdx.y / a.KV, kh = blockIdx.y % a.KV;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[1];
  const int* pb = kPos ? a.pos + (long long)b * a.Sk : nullptr;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int hh = kh * G + r / BQ, qpos = q0 + r % BQ;
    const bool in = r < R && qpos < a.Sq;
    q_s[r * (D + 1) + d] =
        in ? Elem<T>::load(q + b * a.sq[0] + hh * a.sq[1] + qpos * a.sq[2] + d)
           : 0.0f;
    do_s[r * (D + 1) + d] =
        in ? Elem<T>::load(dout + b * a.sd[0] + hh * a.sd[1] +
                           qpos * a.sd[2] + d)
           : 0.0f;
  }
  __syncthreads();

  // this thread's row and half of the tile's keys (and of the row's dims)
  const int r = tid >> 1, half = tid & 1;
  const bool live = r < R && q0 + r % BQ < a.Sq;
  const int hh = kh * G + (r < R ? r / BQ : 0);
  const int qpos = q0 + (r < R ? r % BQ : 0);
  const int qp = kPos && live ? pb[qpos] : 0;

  // Δ = rowsum(dO ∘ O), half the dims a thread
  float delta = 0.0f;
  if (live) {
    const T* orow = o + b * a.so[0] + hh * a.so[1] + qpos * a.so[2];
    for (int d = half; d < D; d += 2)
      delta += do_s[r * (D + 1) + d] * Elem<T>::load(orow + d);
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);

  // keys any row of the tile may see: [k_lo, k_hi) (all, by positions)
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal && !kPos ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_lo = a.window > 0 && !kPos ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_lo - k_lo % kKeys;

  auto load_tile = [&](int t0, bool with_v) {
    __syncthreads();   // every thread is done with the previous tile
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool in = t0 + j < a.Sk;
      k_s[j * (D + 1) + d] =
          in ? Elem<T>::load(kb + (long long)(t0 + j) * a.sk[2] + d) : 0.0f;
      if (with_v)
        v_s[j * (D + 1) + d] =
            in ? Elem<T>::load(vb + (long long)(t0 + j) * a.sv[2] + d) : 0.0f;
    }
    if (kPos && tid < kKeys) kpos_s[tid] = t0 + tid < a.Sk ? pb[t0 + tid] : 0;
    __syncthreads();
  };
  // scale·q·k of this thread's keys, -inf where masked (ok: visible)
  auto scores = [&](int t0, float (&s)[kHalf], bool (&ok)[kHalf]) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        s[i] += qd * k_s[(half + 2 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int kpos = t0 + half + 2 * i;
      ok[i] = live && kpos < a.Sk &&
              visible<kPos>(a, qpos, kpos, qp, kPos ? kpos_s[half + 2 * i] : 0);
      s[i] = ok[i] ? s[i] * a.scale : kAttnNegInf;
    }
  };

  // pass 1: the row's max and sum of exp (the forward's online rule)
  float m = kAttnNegInf, l = 0.0f;
  for (int t0 = t_first; t0 < k_hi; t0 += kKeys) {
    load_tile(t0, false);
    float s[kHalf];
    bool ok[kHalf];
    scores(t0, s, ok);
    float mx = kAttnNegInf;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) mx = fmaxf(mx, s[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) sum += ok[i] ? expf(s[i] - m_new) : 0.0f;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * expf(m - m_new) + sum;
    m = m_new;
  }
  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
  if (live && half == 0) {
    const long long row = ((long long)b * a.H + hh) * a.Sq + qpos;
    const long long n = (long long)a.B * a.H * a.Sq;
    a.stats[row] = m;
    a.stats[n + row] = inv_l;
    a.stats[2 * n + row] = delta;
  }

  // pass 2: dS = P ∘ (dP − Δ) and dQ += dS·K
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int t0 = t_first; t0 < k_hi; t0 += kKeys) {
    load_tile(t0, true);
    float s[kHalf], dp[kHalf];
    bool ok[kHalf];
    scores(t0, s, ok);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) dp[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float od = do_s[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        dp[i] += od * v_s[(half + 2 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float p = ok[i] ? expf(s[i] - m) * inv_l : 0.0f;
      ds_s[r * (kKeys + 1) + half + 2 * i] = p * (dp[i] - delta);
    }
    __syncwarp();   // the row's two threads (one warp) wrote its dS
    for (int j = 0; j < kKeys; ++j) {
      const float ds = ds_s[r * (kKeys + 1) + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] += ds * k_s[j * (D + 1) + half + 2 * i];
    }
  }

  // dQ = scale·acc through the Q rows, then rows of D stored
  __syncthreads();
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    q_s[r * (D + 1) + half + 2 * i] = acc[i] * a.scale;
  __syncthreads();
  T* dq = static_cast<T*>(a.dq);
  for (int i = tid; i < R * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int qq = q0 + rr % BQ;
    if (qq < a.Sq)
      Elem<T>::store(
          dq + (((long long)b * a.H + kh * G + rr / BQ) * a.Sq + qq) * D + d,
          q_s[rr * (D + 1) + d]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (int)sizeof(float) * (2 * kKeyRows * (D + 1) + 2 * kQueries * (D + 1) +
                               2 * kKeyRows * (kQueries + 1) + 3 * kQueries);
}

template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* k_s = smem;                            // [kKeyRows][D + 1]
  float* v_s = k_s + kKeyRows * (D + 1);        // [kKeyRows][D + 1]
  float* q_s = v_s + kKeyRows * (D + 1);        // [kQueries][D + 1]
  float* do_s = q_s + kQueries * (D + 1);       // [kQueries][D + 1]
  float* p_s = do_s + kQueries * (D + 1);       // [kKeyRows][kQueries + 1]
  float* ds_s = p_s + kKeyRows * (kQueries + 1);  // [kKeyRows][kQueries + 1]
  float* st_s = ds_s + kKeyRows * (kQueries + 1);  // [3][kQueries]
  __shared__ int qpos_s[kQueries];              // the tile's query positions

  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int G = a.H / a.KV;
  const int b = blockIdx.y / a.KV, kh = blockIdx.y % a.KV;
  const int k0 = blockIdx.x * kKeyRows;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[1];
  const int* pb = kPos ? a.pos + (long long)b * a.Sk : nullptr;
  const long long n_rows = (long long)a.B * a.H * a.Sq;

  for (int i = tid; i < kKeyRows * D; i += kThreads) {
    const int j = i / D, d = i % D;
    const bool in = k0 + j < a.Sk;
    k_s[j * (D + 1) + d] =
        in ? Elem<T>::load(kb + (long long)(k0 + j) * a.sk[2] + d) : 0.0f;
    v_s[j * (D + 1) + d] =
        in ? Elem<T>::load(vb + (long long)(k0 + j) * a.sv[2] + d) : 0.0f;
  }

  // this thread's key and quarter of the tile's queries (and of its dims)
  const int j = tid >> 2, c = tid & 3;
  const int key = k0 + j;
  const bool key_in = key < a.Sk;
  const int kp = kPos && key_in ? pb[key] : 0;
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.0f;

  // queries that may see a key of the block: [q_lo, q_hi) (all, by
  // positions)
  const int k_last = min(k0 + kKeyRows, a.Sk) - 1;
  const int q_lo = a.causal && !kPos ? k0 : 0;
  const int q_hi = a.window > 0 && !kPos ? min(a.Sq, k_last + a.window) : a.Sq;
  const int t_first = q_lo - q_lo % kQueries;

  for (int g = 0; g < G; ++g) {
    const int hh = kh * G + g;
    const long long row0 = ((long long)b * a.H + hh) * a.Sq;
    for (int t0 = t_first; t0 < q_hi; t0 += kQueries) {
      __syncthreads();   // K/V staged; the previous tile's reads done
      for (int i = tid; i < kQueries * D; i += kThreads) {
        const int qi = i / D, d = i % D;
        const int qq = t0 + qi;
        const bool in = qq < a.Sq;
        q_s[qi * (D + 1) + d] =
            in ? Elem<T>::load(q + b * a.sq[0] + hh * a.sq[1] + qq * a.sq[2] + d)
               : 0.0f;
        do_s[qi * (D + 1) + d] =
            in ? Elem<T>::load(dout + b * a.sd[0] + hh * a.sd[1] +
                               qq * a.sd[2] + d)
               : 0.0f;
      }
      if (tid < kQueries) {
        const int qq = t0 + tid;
        const bool in = qq < a.Sq;
        st_s[tid] = in ? a.stats[row0 + qq] : 0.0f;
        st_s[kQueries + tid] = in ? a.stats[n_rows + row0 + qq] : 0.0f;
        st_s[2 * kQueries + tid] = in ? a.stats[2 * n_rows + row0 + qq] : 0.0f;
        if (kPos) qpos_s[tid] = in ? pb[qq] : 0;
      }
      __syncthreads();

      // S and dP of this key against queries c, c + 4, ... of the tile, in
      // the dq kernel's order of products and sums
      float s[kQuarter], dp[kQuarter];
#pragma unroll
      for (int i = 0; i < kQuarter; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = k_s[j * (D + 1) + d], vd = v_s[j * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < kQuarter; ++i) {
          s[i] += q_s[(c + 4 * i) * (D + 1) + d] * kd;
          dp[i] += do_s[(c + 4 * i) * (D + 1) + d] * vd;
        }
      }
#pragma unroll
      for (int i = 0; i < kQuarter; ++i) {
        const int qi = c + 4 * i, qq = t0 + qi;
        const bool ok = key_in && qq < a.Sq &&
                        visible<kPos>(a, qq, key, kPos ? qpos_s[qi] : 0, kp);
        const float p =
            ok ? expf(s[i] * a.scale - st_s[qi]) * st_s[kQueries + qi] : 0.0f;
        p_s[j * (kQueries + 1) + qi] = p;
        ds_s[j * (kQueries + 1) + qi] = p * (dp[i] - st_s[2 * kQueries + qi]);
      }
      __syncwarp();   // the key's four threads (one warp) wrote its P, dS
      for (int qi = 0; qi < kQueries; ++qi) {
        const float p = p_s[j * (kQueries + 1) + qi];
        const float ds = ds_s[j * (kQueries + 1) + qi];
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          dv[i] += p * do_s[qi * (D + 1) + c + 4 * i];
          dk[i] += ds * q_s[qi * (D + 1) + c + 4 * i];
        }
      }
    }
  }

  if (!key_in) return;
  const long long out = (((long long)b * a.KV + kh) * a.Sk + key) * D;
  T* dkp = static_cast<T*>(a.dk) + out;
  T* dvp = static_cast<T*>(a.dv) + out;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    Elem<T>::store(dkp + c + 4 * i, dk[i] * a.scale);
    Elem<T>::store(dvp + c + 4 * i, dv[i]);
  }
}

// ----------------------------------------------------------- tensor cores

using bf16 = __nv_bfloat16;

// bf16 at D = 32 ... 256: the tensor-core kernels (they read the LSE)
template <typename T, int D>
constexpr bool kTensorCores = std::is_same<T, bf16>::value && D >= 32;

// D = 256: the dk/dv kernel's blocks split into a dV half and a dK half
// (blockIdx.z), so that each holds D/2 accumulator floats a thread, not D
// (one pass spilled 980 bytes a thread at 255 registers)
template <int D>
constexpr bool kSplitDkv = D > 128;
constexpr int kPad = 8;          // bf16 padding (16 bytes) of a shared row
constexpr int kKeyTile = 32;     // keys of a dq tile
constexpr int kQueryTile = 64;   // queries of a dk/dv tile
constexpr int kWarpRows = 16;    // rows of a warp (one m16 tile)

// Q, dO and two tiles of K and V (dq); K, V and two tiles of Q and dO
// (dk/dv)
template <int D, int kTile>
constexpr int mma_smem_bytes() {
  return (2 * kRows + 4 * kTile) * (D + kPad) * (int)sizeof(bf16);
}

template <int D, bool kPos>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel_mma(const BwdArgs a) {
  constexpr int LD = D + kPad;             // elements of a shared row
  constexpr int kChunks = D / 8;           // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD], then dQ
  bf16* do_s = q_s + kRows * LD;                   // [kRows][LD]
  bf16* k_s = do_s + kRows * LD;                   // [2][kKeyTile][LD]
  bf16* v_s = k_s + 2 * kKeyTile * LD;             // [2][kKeyTile][LD]
  // each row's q and dO element offsets and (b·H + h)·Sq + position (-1:
  // a row not in use); its LSE and Δ; the key positions of the K/V tiles
  __shared__ long long q_off[kRows], d_off[kRows], row_of[kRows];
  __shared__ float lse_s[kRows], delta_s[kRows];
  __shared__ int kpos_s[2][kKeyTile];

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* o = static_cast<const bf16*>(a.o);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int G = a.H / a.KV, BQ = a.BQ, R = G * BQ;
  const int b = blockIdx.y / a.KV, kh = blockIdx.y % a.KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // most keys first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + kh * a.sk[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + kh * a.sv[1];
  const int* pb = kPos ? a.pos + (long long)b * a.Sk : nullptr;
  const long long n_rows = (long long)a.B * a.H * a.Sq;

  if (tid < kRows) {
    const int hh = kh * G + tid / BQ, qpos = q0 + tid % BQ;
    const bool in = tid < R && qpos < a.Sq;
    q_off[tid] = in ? b * a.sq[0] + hh * a.sq[1] + qpos * a.sq[2] : -1;
    d_off[tid] = in ? b * a.sd[0] + hh * a.sd[1] + qpos * a.sd[2] : -1;
    row_of[tid] = in ? ((long long)b * a.H + hh) * a.Sq + qpos : -1;
  }
  __syncthreads();
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const long long qo = q_off[r], dof = d_off[r];
    cp_async16(smem_addr(q_s + r * LD + c * 8), qo >= 0 ? q + qo + c * 8 : q,
               qo >= 0);
    cp_async16(smem_addr(do_s + r * LD + c * 8),
               dof >= 0 ? dout + dof + c * 8 : dout, dof >= 0);
  }

  // keys any row of the tile may see: [k_lo, k_hi), in tiles from t_first
  // (every key, by positions)
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal && !kPos ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_lo = a.window > 0 && !kPos ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_lo - k_lo % kKeyTile;
  const int n_tiles =
      k_hi > t_first ? (k_hi - t_first + kKeyTile - 1) / kKeyTile : 0;

  auto load_kv = [&](int t0, int buf) {
    bf16* kd = k_s + buf * kKeyTile * LD;
    bf16* vd = v_s + buf * kKeyTile * LD;
    for (int i = tid; i < kKeyTile * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < a.Sk;
      const long long key = t0 + j;
      cp_async16(smem_addr(kd + j * LD + c * 8),
                 in ? kb + key * a.sk[2] + c * 8 : kb, in);
      cp_async16(smem_addr(vd + j * LD + c * 8),
                 in ? vb + key * a.sv[2] + c * 8 : vb, in);
    }
    // read after the barrier that follows this tile's cp.async wait
    if (kPos && tid < kKeyTile)
      kpos_s[buf][tid] = t0 + tid < a.Sk ? pb[t0 + tid] : 0;
  };

  if (n_tiles > 0) load_kv(t_first, 0);
  cp_async_commit();                       // Q, dO and the first tile

  // Δ = rowsum(dO ∘ O) in float32 while the copies fly: two threads a row,
  // alternate 16-byte chunks, then their pair sum; the row's LSE
  {
    const int r = tid >> 1, half = tid & 1;
    const long long row = row_of[r];
    float delta = 0.0f;
    if (row >= 0) {
      const int hh = kh * G + r / BQ, qpos = q0 + r % BQ;
      const bf16* orow = o + b * a.so[0] + hh * a.so[1] + qpos * a.so[2];
      const bf16* drow = dout + d_off[r];
      for (int c = half; c < kChunks; c += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c * 8);
        const bf16* op = reinterpret_cast<const bf16*>(&ov);
        const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          delta += __bfloat162float(dp[e]) * __bfloat162float(op[e]);
      }
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    if (half == 0) {
      delta_s[r] = delta;
      lse_s[r] = row >= 0 ? a.lse[row] : 0.0f;
      if (row >= 0) a.stats[2 * n_rows + row] = delta;
    }
  }
  __syncthreads();

  // this lane's two rows of the warp's 16: gq and gq + 8; its columns of
  // an 8-wide fragment: 2·tq and 2·tq + 1
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row address
  int lo[2], hi[2], qp[2];                  // keys [lo, hi); kPos: position
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * kWarpRows + gq + 8 * h;
    const int pos = q0 + (r < R ? r % BQ : 0);
    const bool live = row_of[r] >= 0;
    if (kPos) {           // index bounds only; the positions mask the rest
      hi[h] = live ? a.Sk : 0;
      lo[h] = 0;
      qp[h] = live ? pb[pos] : 0;
    } else {
      hi[h] = !live ? 0 : a.causal ? min(pos + 1, a.Sk) : a.Sk;
      lo[h] = a.window > 0 ? pos - a.window + 1 : 0;
      qp[h] = 0;
    }
    lse[h] = lse_s[r];
    delta[h] = delta_s[r];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int a_row = (warp * kWarpRows + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
  const uint32_t q_row = smem_addr(q_s + a_row);
  const uint32_t do_row = smem_addr(do_s + a_row);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * kKeyTile, buf = it & 1;
    if (it + 1 < n_tiles) load_kv(t0 + kKeyTile, buf ^ 1);
    cp_async_commit();                     // (empty on the last tile)
    cp_async_wait<1>();                    // this tile (and Q, dO) arrived
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × kKeyTile keys a warp, in fragments
    // of 8 keys
    const bf16* kt = k_s + buf * kKeyTile * LD;
    const bf16* vt = v_s + buf * kKeyTile * LD;
    float s[kKeyTile / 8][4], dp[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      ldmatrix_x4(aq, q_row + kk * 16 * (int)sizeof(bf16));
      ldmatrix_x4(ad, do_row + kk * 16 * (int)sizeof(bf16));
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; j += 2) {
        const int off = ((j + (mi >> 1)) * 8 + mr) * LD + kk * 16 +
                        (mi & 1) * 8;
        uint32_t bk[4], bv[4];  // keys of fragments j, j + 1; d lo and hi
        ldmatrix_x4(bk, smem_addr(kt + off));
        mma_bf16(s[j], aq, bk[0], bk[1]);
        mma_bf16(s[j + 1], aq, bk[2], bk[3]);
        ldmatrix_x4(bv, smem_addr(vt + off));
        mma_bf16(dp[j], ad, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ad, bv[2], bv[3]);
      }
    }

    // P = 2^(s·scale·log2 e − LSE) where visible, dS = P ∘ (dP − Δ) into s
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = j * 8 + 2 * tq + (e & 1), kpos = t0 + c;
        bool in = kpos >= lo[h] && kpos < hi[h];
        if (kPos) {
          const int kp = kpos_s[buf][c];
          in = in && qp[h] >= kp && (a.window <= 0 || qp[h] - kp < a.window);
        }
        const float p = in ? ex2_approx(s[j][e] * a.scale_log2 - lse[h])
                           : 0.0f;
        s[j][e] = p * (dp[j][e] - delta[h]);
      }

    // dQ += dS·K: dS (bf16) from the fragments, 16 keys a step, K through
    // ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 16; ++kc) {
      uint32_t as[4];
      pack_a(as, s[2 * kc], s[2 * kc + 1]);
      const uint32_t k_row = smem_addr(
          kt + (kc * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];   // d fragments n and n + 1, keys lo and hi
        ldmatrix_x4_trans(bk, k_row + n * 8 * (int)sizeof(bf16));
        mma_bf16(acc[n], as, bk[0], bk[1]);
        mma_bf16(acc[n + 1], as, bk[2], bk[3]);
      }
    }
    __syncthreads();   // every warp is done with buf before it is reloaded
  }

  // epilogue: scale·dQ in bf16 into the warp's own Q rows, then 16-byte
  // stores of the rows in use
  cp_async_wait<0>();
  __syncthreads();
  bf16* dq_s = q_s + (warp * kWarpRows + gq) * LD + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(dq_s + n * 8) = __floats2bfloat162_rn(
        acc[n][0] * a.scale, acc[n][1] * a.scale);
    *reinterpret_cast<__nv_bfloat162*>(dq_s + 8 * LD + n * 8) =
        __floats2bfloat162_rn(acc[n][2] * a.scale, acc[n][3] * a.scale);
  }
  __syncwarp();
  bf16* dq = static_cast<bf16*>(a.dq);
  for (int i = lane; i < kWarpRows * kChunks; i += 32) {
    const int rr = warp * kWarpRows + i / kChunks, c = i % kChunks;
    const long long row = row_of[rr];
    if (row < 0) continue;
    *reinterpret_cast<uint4*>(dq + row * D + c * 8) =
        *reinterpret_cast<const uint4*>(q_s + rr * LD + c * 8);
  }
}

// what a dk/dv block computes: both gradients, or one half of a split
enum DkvPart { kBoth = 0, kDvOnly = 1, kDkOnly = 2 };

template <int D, bool kPos, int kPart>
__device__ __forceinline__ void dkv_mma(const BwdArgs& a) {
  constexpr bool kV = kPart != kDkOnly, kK = kPart != kDvOnly;
  constexpr int LD = D + kPad;             // elements of a shared row
  constexpr int kChunks = D / 8;           // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD], then dK
  bf16* v_s = k_s + kRows * LD;                    // [kRows][LD], then dV
  bf16* q_s = v_s + kRows * LD;                    // [2][kQueryTile][LD]
  bf16* do_s = q_s + 2 * kQueryTile * LD;          // [2][kQueryTile][LD]
  // the LSE, Δ and positions of the Q/dO tiles' queries
  __shared__ float lse_s[2][kQueryTile], delta_s[2][kQueryTile];
  __shared__ int qpos_s[2][kQueryTile];

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int G = a.H / a.KV;
  const int b = blockIdx.y / a.KV, kh = blockIdx.y % a.KV;
  const int k0 = blockIdx.x * kRows;       // the first key tiles see most
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + kh * a.sk[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + kh * a.sv[1];
  const int* pb = kPos ? a.pos + (long long)b * a.Sk : nullptr;
  const long long n_rows = (long long)a.B * a.H * a.Sq;

  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int j = i / kChunks, c = i % kChunks;
    const bool in = k0 + j < a.Sk;
    const long long key = k0 + j;
    cp_async16(smem_addr(k_s + j * LD + c * 8),
               in ? kb + key * a.sk[2] + c * 8 : kb, in);
    if (kK)   // V enters dP, which only dK needs
      cp_async16(smem_addr(v_s + j * LD + c * 8),
                 in ? vb + key * a.sv[2] + c * 8 : vb, in);
  }
  // queries that may see a key of the block: [q_lo, q_hi) (all, by
  // positions), in tiles from t_first, for each of the G heads in order
  const int k_last = min(k0 + kRows, a.Sk) - 1;
  const int q_lo = a.causal && !kPos ? k0 : 0;
  const int q_hi =
      a.window > 0 && !kPos ? min(a.Sq, k_last + a.window) : a.Sq;
  const int t_first = q_lo - q_lo % kQueryTile;
  const int n_qt =
      q_hi > t_first ? (q_hi - t_first + kQueryTile - 1) / kQueryTile : 0;
  const int n_items = G * n_qt;

  auto load_q = [&](int it, int buf) {
    const int hh = kh * G + it / n_qt;
    const int t0 = t_first + (it % n_qt) * kQueryTile;
    const bf16* qb = q + b * a.sq[0] + hh * a.sq[1];
    const bf16* db = dout + b * a.sd[0] + hh * a.sd[1];
    bf16* qd = q_s + buf * kQueryTile * LD;
    bf16* dd = do_s + buf * kQueryTile * LD;
    for (int i = tid; i < kQueryTile * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < a.Sq;
      const long long qq = t0 + j;
      cp_async16(smem_addr(qd + j * LD + c * 8),
                 in ? qb + qq * a.sq[2] + c * 8 : qb, in);
      cp_async16(smem_addr(dd + j * LD + c * 8),
                 in ? db + qq * a.sd[2] + c * 8 : db, in);
    }
    // read after the barrier that follows this tile's cp.async wait
    if (tid < kQueryTile) {
      const int qq = t0 + tid;
      const bool in = qq < a.Sq;
      const long long row = ((long long)b * a.H + hh) * a.Sq + qq;
      lse_s[buf][tid] = in ? a.lse[row] : 0.0f;
      delta_s[buf][tid] = in ? a.stats[2 * n_rows + row] : 0.0f;
      if (kPos) qpos_s[buf][tid] = in ? pb[qq] : 0;
    }
  };

  if (n_items > 0) load_q(0, 0);
  cp_async_commit();                       // K, V and the first Q/dO tile

  // this lane's two keys of the warp's 16: gq and gq + 8 (the rows of the
  // transposed products); its queries of an 8-wide fragment: 2·tq and
  // 2·tq + 1
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row address
  int lo[2], hi[2], kp[2];                  // queries [lo, hi); kPos: pos
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * kWarpRows + gq + 8 * h;
    const bool in = key < a.Sk;
    if (kPos) {           // index bounds only; the positions mask the rest
      lo[h] = 0;
      hi[h] = in ? a.Sq : 0;
      kp[h] = in ? pb[key] : 0;
    } else {
      lo[h] = a.causal ? key : 0;
      hi[h] = !in ? 0 : a.window > 0 ? min(a.Sq, key + a.window) : a.Sq;
      kp[h] = 0;
    }
  }
  // the accumulators of the part this block computes (one float a thread
  // for the other)
  float dk[kK ? D / 8 : 1][4], dv[kV ? D / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < (kK ? D / 8 : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < (kV ? D / 8 : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.0f;

  const int a_row = (warp * kWarpRows + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
  const uint32_t k_row = smem_addr(k_s + a_row);
  const uint32_t v_row = smem_addr(v_s + a_row);

  for (int it = 0; it < n_items; ++it) {
    const int t0 = t_first + (it % n_qt) * kQueryTile, buf = it & 1;
    if (it + 1 < n_items) load_q(it + 1, buf ^ 1);
    cp_async_commit();                     // (empty on the last tile)
    cp_async_wait<1>();                    // this tile (and K, V) arrived
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dK only): 16 keys × kQueryTile queries a
    // warp, in fragments of 8 queries
    const bf16* qt = q_s + buf * kQueryTile * LD;
    const bf16* dt = do_s + buf * kQueryTile * LD;
    float st[kQueryTile / 8][4], dpt[kQueryTile / 8][4];
#pragma unroll
    for (int j = 0; j < kQueryTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, k_row + kk * 16 * (int)sizeof(bf16));
      if (kK) ldmatrix_x4(av, v_row + kk * 16 * (int)sizeof(bf16));
#pragma unroll
      for (int j = 0; j < kQueryTile / 8; j += 2) {
        const int off = ((j + (mi >> 1)) * 8 + mr) * LD + kk * 16 +
                        (mi & 1) * 8;
        uint32_t bq[4], bd[4];  // queries of fragments j, j + 1; d lo, hi
        ldmatrix_x4(bq, smem_addr(qt + off));
        mma_bf16(st[j], ak, bq[0], bq[1]);
        mma_bf16(st[j + 1], ak, bq[2], bq[3]);
        if (kK) {
          ldmatrix_x4(bd, smem_addr(dt + off));
          mma_bf16(dpt[j], av, bd[0], bd[1]);
          mma_bf16(dpt[j + 1], av, bd[2], bd[3]);
        }
      }
    }

    // Pᵀ into st, dSᵀ = Pᵀ ∘ (dPᵀ − Δ) into dpt
#pragma unroll
    for (int j = 0; j < kQueryTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = j * 8 + 2 * tq + (e & 1), qq = t0 + c;
        bool in = qq >= lo[h] && qq < hi[h];
        if (kPos) {
          const int qp = qpos_s[buf][c];
          in = in && qp >= kp[h] && (a.window <= 0 || qp - kp[h] < a.window);
        }
        const float p =
            in ? ex2_approx(st[j][e] * a.scale_log2 - lse_s[buf][c]) : 0.0f;
        st[j][e] = p;
        if (kK) dpt[j][e] = p * (dpt[j][e] - delta_s[buf][c]);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q: Pᵀ and dSᵀ (bf16) from the fragments,
    // 16 queries a step, dO and Q through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kQueryTile / 16; ++kc) {
      uint32_t ap[4], as[4];
      if (kV) pack_a(ap, st[2 * kc], st[2 * kc + 1]);
      if (kK) pack_a(as, dpt[2 * kc], dpt[2 * kc + 1]);
      const int row = (kc * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
      const uint32_t d_rowt = smem_addr(dt + row), q_rowt = smem_addr(qt + row);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bd[4], bq[4];   // d fragments n and n + 1, queries lo, hi
        if constexpr (kV) {
          ldmatrix_x4_trans(bd, d_rowt + n * 8 * (int)sizeof(bf16));
          mma_bf16(dv[n], ap, bd[0], bd[1]);
          mma_bf16(dv[n + 1], ap, bd[2], bd[3]);
        }
        if constexpr (kK) {
          ldmatrix_x4_trans(bq, q_rowt + n * 8 * (int)sizeof(bf16));
          mma_bf16(dk[n], as, bq[0], bq[1]);
          mma_bf16(dk[n + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with buf before it is reloaded
  }

  // epilogue: scale·dK and dV in bf16 into the warp's own K and V rows,
  // then 16-byte stores of the keys in range
  cp_async_wait<0>();
  __syncthreads();
  bf16* dk_s = k_s + (warp * kWarpRows + gq) * LD + 2 * tq;
  bf16* dv_s = v_s + (warp * kWarpRows + gq) * LD + 2 * tq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if constexpr (kK) {
      *reinterpret_cast<__nv_bfloat162*>(dk_s + n * 8) =
          __floats2bfloat162_rn(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dk_s + 8 * LD + n * 8) =
          __floats2bfloat162_rn(dk[n][2] * a.scale, dk[n][3] * a.scale);
    }
    if constexpr (kV) {
      *reinterpret_cast<__nv_bfloat162*>(dv_s + n * 8) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_s + 8 * LD + n * 8) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
  __syncwarp();
  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
  for (int i = lane; i < kWarpRows * kChunks; i += 32) {
    const int jr = warp * kWarpRows + i / kChunks, c = i % kChunks;
    const int key = k0 + jr;
    if (key >= a.Sk) continue;
    const long long out = (((long long)b * a.KV + kh) * a.Sk + key) * D + c * 8;
    if (kK)
      *reinterpret_cast<uint4*>(dkp + out) =
          *reinterpret_cast<const uint4*>(k_s + jr * LD + c * 8);
    if (kV)
      *reinterpret_cast<uint4*>(dvp + out) =
          *reinterpret_cast<const uint4*>(v_s + jr * LD + c * 8);
  }
}

template <int D, bool kPos>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel_mma(const BwdArgs a) {
  if constexpr (kSplitDkv<D>) {
    if (blockIdx.z == 0)
      dkv_mma<D, kPos, kDvOnly>(a);
    else
      dkv_mma<D, kPos, kDkOnly>(a);
  } else {
    dkv_mma<D, kPos, kBoth>(a);
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

// the dq kernel, then the dk/dv kernel (which reads the dq kernel's Δ)
template <typename Fq, typename Fkv>
int launch_pair(Fq* dq_fn, Fkv* dkv_fn, int smem_q, int smem_kv,
                std::atomic<unsigned>& done_q, std::atomic<unsigned>& done_kv,
                dim3 grid_q, dim3 grid_kv, const BwdArgs& a,
                cudaStream_t stream) {
  cudaError_t e = allow_smem(dq_fn, smem_q, done_q);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(dkv_fn, smem_kv, done_kv);
  if (e != cudaSuccess) return (int)e;
  dq_fn<<<grid_q, kThreads, smem_q, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_fn<<<grid_kv, kThreads, smem_kv, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kPos>
int launch(const BwdArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned> done_q{0}, done_kv{0};
  const dim3 grid_q((a.Sq + a.BQ - 1) / a.BQ, a.B * a.KV);
  if constexpr (kTensorCores<T, D>) {
    if (a.lse == nullptr) return (int)cudaErrorInvalidValue;
    // 16-byte row starts: cp.async and the 16-byte loads of O
    const uintptr_t base = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                           (uintptr_t)a.o | (uintptr_t)a.dout;
    const long long* st[5] = {a.sq, a.sk, a.sv, a.so, a.sd};
    for (const long long* s : st)
      for (int i = 0; i < 3; ++i)
        if (s[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
    if (base % 16 != 0) return (int)cudaErrorMisalignedAddress;
    return launch_pair(fa_bwd_dq_kernel_mma<D, kPos>,
                       fa_bwd_dkv_kernel_mma<D, kPos>,
                       mma_smem_bytes<D, kKeyTile>(),
                       mma_smem_bytes<D, kQueryTile>(), done_q,
                       done_kv, grid_q,
                       dim3((a.Sk + kRows - 1) / kRows, a.B * a.KV,
                            kSplitDkv<D> ? 2 : 1),
                       a, stream);
  } else {
    return launch_pair(fa_bwd_dq_kernel<T, D, kPos>,
                       fa_bwd_dkv_kernel<T, D, kPos>, dq_smem_bytes<D>(),
                       dkv_smem_bytes<D>(), done_q, done_kv, grid_q,
                       dim3((a.Sk + kKeyRows - 1) / kKeyRows, a.B * a.KV), a,
                       stream);
  }
}

template <typename T, int D>
int launch_p(const BwdArgs& a, cudaStream_t stream) {
  return a.pos ? launch<T, D, true>(a, stream) : launch<T, D, false>(a, stream);
}

template <typename T>
int launch_d(const BwdArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch_p<T, 8>(a, stream);
    case 16:
      return launch_p<T, 16>(a, stream);
    case 32:
      return launch_p<T, 32>(a, stream);
    case 64:
      return launch_p<T, 64>(a, stream);
    case 128:
      return launch_p<T, 128>(a, stream);
    case 256:
      return launch_p<T, 256>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements (batch, head,
// position) of q, k, v, o and dout, each with D contiguous (on the
// tensor-core design every row start on a 16-byte boundary); dq (B, H,
// Sq, D), dk and dv (B, KV, Sk, D) contiguous in the input type; stats a
// float32 scratch of 3·B·H·Sq; lse float32 (B·H·Sq), the forward's
// training launch's row LSE in log2 units (read by the tensor-core design,
// which refuses a null one; the CUDA-core design reads none).  BQ query
// positions per dq block with G·BQ <= 64; window 0 means none; scale is
// D^-0.5 as the caller rounds it to float.  pos: null, or int32 (B, S)
// contiguous positions of causal self-attention (Sq = Sk, causal = 1).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* pos, void* dq, void* dk, void* dv,
    void* stats, const void* lse, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long d_sb, long long d_sh,
    long long d_ss, int B, int H, int KV, int Sq, int Sk, int D, int BQ,
    int window, int causal, float scale, int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || BQ < 1 ||
      (H / KV) * BQ > kRows || window < 0 || (pos && (Sq != Sk || !causal)))
    return (int)cudaErrorInvalidValue;
  // the forward's scale in log2 units, rounded as its launch rounds it
  const float log2e = 1.4426950408889634f;
  BwdArgs a = {q, k, v, o, dout, (const int*)pos, dq, dk, dv, (float*)stats,
               (const float*)lse, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
               {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}, {d_sb, d_sh, d_ss},
               B, H, KV, Sq, Sk, BQ, window, causal, scale, scale * log2e};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
