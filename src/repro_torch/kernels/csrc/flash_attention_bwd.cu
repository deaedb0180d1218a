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
//   P = exp(scale·Q·Kᵀ − m)/l   (m, l the row's max and sum of exp)
//   Δ = rowsum(dO ∘ O)
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − Δ),
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q.
// Float32 accumulation throughout; each output rounded once to the input
// type.  The forward saves nothing beyond O: the row statistics (m, l) are
// recomputed here under the same masks, so the serving forward launch is
// unchanged.
//
// 1. fa_bwd_dq_kernel, one block of 128 threads per (batch row · KV head,
//    query tile) with the forward's row layout (G heads × BQ positions,
//    64 rows, two threads a row, each 16 of a 32-key tile's scores):
//    Δ from O and dO; a first pass over the key tiles for (m, l) by the
//    online rule; the row's (m, 1/max(l, 1e-30), Δ) written to a float32
//    scratch (3, B·H·Sq); a second pass over the same tiles for S, dP, P
//    and dS, and dQ += dS·K in registers (D/2 values a thread).
// 2. fa_bwd_dkv_kernel, one block per (batch row · KV head, 32-key tile),
//    four threads a key (each D/4 of its dK and dV in registers and 8 of a
//    32-query tile's scores): it walks the G query heads of its KV group in
//    order and, for each, the query tiles that may see its keys, reads the
//    rows' statistics from the scratch, recomputes S and dP, and sums
//    dV += Pᵀ·dO and dK += dSᵀ·Q.  The scores are the dq kernel's products
//    in the same order, so P has the same bits in both kernels.
// No float atomics: every sum runs in a fixed order, so two launches give
// the same bits.
//
// What bounds it on the H100: at the training shape (B 8, H = KV 16,
// S 512, D 64, causal) the operations, ~2·S²/2·D·4 multiply-adds a
// (row, head) in each kernel against ~S·D·7 values read and written: well
// above the ~295 operations a byte at which the tensor cores would bound
// it.  This first design runs them on the CUDA cores in float32 (for
// bfloat16 inputs too: the operands are widened as they are staged), one
// shared-memory read a multiply-add; the tensor cores (mma/wgmma on bf16
// tiles) and keeping the forward's row statistics are later work.
//
// Inputs are read by strides (only D contiguous), element by element; dQ
// is (B, H, Sq, D), dK and dV (B, KV, Sk, D), contiguous.  Built with the
// repository's -fmad=false like every source.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attention.cuh"

namespace {

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
  float* stats;        // (3, B·H·Sq): m, 1/max(l, 1e-30), Δ
  long long sq[3], sk[3], sv[3], so[3], sd[3];  // (batch, head, position)
  int B, H, KV, Sq, Sk, BQ, window, causal;
  float scale;
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
int launch(const BwdArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned> done_q{0}, done_kv{0};
  constexpr int smem_q = dq_smem_bytes<D>(), smem_kv = dkv_smem_bytes<D>();
  cudaError_t e = allow_smem(fa_bwd_dq_kernel<T, D, kPos>, smem_q, done_q);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(fa_bwd_dkv_kernel<T, D, kPos>, smem_kv, done_kv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((a.Sq + a.BQ - 1) / a.BQ, a.B * a.KV);
  fa_bwd_dq_kernel<T, D, kPos><<<grid_q, kThreads, smem_q, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((a.Sk + kKeyRows - 1) / kKeyRows, a.B * a.KV);
  fa_bwd_dkv_kernel<T, D, kPos><<<grid_kv, kThreads, smem_kv, stream>>>(a);
  return (int)cudaGetLastError();
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
// position) of q, k, v, o and dout, each with D contiguous; dq (B, H, Sq,
// D), dk and dv (B, KV, Sk, D) contiguous in the input type; stats a
// float32 scratch of 3·B·H·Sq.  BQ query positions per dq block with
// G·BQ <= 64; window 0 means none; scale is D^-0.5 as the caller rounds it
// to float.  pos: null, or int32 (B, S) contiguous positions of causal
// self-attention (Sq = Sk, causal = 1).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* pos, void* dq, void* dk, void* dv,
    void* stats, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long d_sb, long long d_sh, long long d_ss, int B,
    int H, int KV, int Sq, int Sk, int D, int BQ, int window, int causal,
    float scale, int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || BQ < 1 ||
      (H / KV) * BQ > kRows || window < 0 || (pos && (Sq != Sk || !causal)))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {q, k, v, o, dout, (const int*)pos, dq, dk, dv, (float*)stats,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, {d_sb, d_sh, d_ss},
               B, H, KV, Sq, Sk, BQ, window, causal, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
