// Flash (prefill) attention: causal GQA attention, optionally
// sliding-window or non-causal — one block per (batch row · KV head, query
// tile) with the G query heads of the KV head folded into the tile's rows.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention
// (Pallas body _flash_kernel), whose grid walks (B·KV, q tiles, k tiles)
// with the k tiles innermost and in order on one TPU core, keeps the online
// softmax state (m, l, acc) in VMEM scratch across them, folds the GQA
// group into the MXU's rows and skips the fully masked k tiles.  It asserts
// that Sq and Sk are multiples of its tiles; this kernel takes any lengths
// and masks the ragged edge itself.
//
// What bounds it on the H100: bytes, at the serving shapes.  A prefill of
// Sq = Sk <= 80 tokens reads q, k and v and writes the output once: a
// (row, KV head) holds ~Sq·D·(2G + 2) values for ~2·G·Sq²·D causal
// operations, tens of operations per byte in bf16, under the ~295 at which
// the tensor cores would bound it.
//
// Design: a block of 128 threads owns 64 query rows (G heads × 64/G
// positions, so a block always fills its rows) held in shared memory as
// float, and loops over tiles of 32 keys from the first one a row of the
// tile may see (window) to the last one (causal), so fully masked tiles are
// never loaded.  Two threads share a row: each computes 16 of the tile's 32
// scores from shared memory (rows padded by one float, so neighbouring rows
// fall in different banks), and the pair's max and sum meet by one shuffle.
// The online softmax keeps (m, l) in float32 per row, sums l from the
// float32 probabilities and rounds each probability to the value type
// before P·V, as the TPU kernel does; masked entries get probability 0.
// P·V: each thread of a pair owns every other element of D for its row (D/2
// float32 accumulators in registers).  The tile's output goes through
// shared memory so that its stores are coalesced, divided by max(l, 1e-30).
// q, k and v are read by strides (only D is contiguous), so the model's
// (B, S, H, D) projections are passed as permuted views, not copies.
// Built with the repository's -fmad=false like every source; the kernel is
// held to a stated tolerance, not to the plain version's bits (its sums run
// in another order), so the flag costs it only the fused multiply-adds.
// Tensor-core MMA (wgmma), TMA and split-K are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;             // query rows of a block (G × BQ)
constexpr int kKeys = 32;             // keys of a tile
constexpr int kPerThread = kKeys / 2; // scores per thread of a row's pair

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kKeys * (D + 1) + kKeys * D + kRows * (kKeys + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           int H, int KV, int Sq, int Sk, int BQ, int window,
                           int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kRows][D + 1], then the output
  float* k_s = q_s + kRows * (D + 1);       // [kKeys][D + 1]
  float* v_s = k_s + kKeys * (D + 1);       // [kKeys][D]
  float* p_s = v_s + kKeys * D;             // [kRows][kKeys + 1]

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
            ? Elem<T>::load(q + b * q_sb + (kh * G + g) * q_sh + qpos * q_ss + d)
            : 0.0f;
  }

  // this thread's row and half of the tile's keys
  const int r = tid >> 1, half = tid & 1;
  const bool live = r < R && q0 + r % BQ < Sq;
  const int qpos = q0 + (r < R ? r % BQ : 0);
  float m = kAttnNegInf, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  // keys any row of the tile may see: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t0 = k_lo - k_lo % kKeys; t0 < k_hi; t0 += kKeys) {
    __syncthreads();   // q_s loaded; the previous tile's P·V done
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool in = t0 + j < Sk;
      k_s[j * (D + 1) + d] = in ? Elem<T>::load(kb + (t0 + j) * k_ss + d) : 0.0f;
      v_s[j * D + d] = in ? Elem<T>::load(vb + (t0 + j) * v_ss + d) : 0.0f;
    }
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
      ok[i] = live && kpos < Sk && (!causal || qpos >= kpos) &&
              (window <= 0 || qpos - kpos < window);
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
      p_s[r * (kKeys + 1) + half + 2 * i] = Elem<T>::round(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < kKeys; ++j) {
      const float p = p_s[r * (kKeys + 1) + j];
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
      Elem<T>::store(out + (((long long)b * H + kh * G + g) * Sq + qp) * D + d,
                     q_s[rr * (D + 1) + d]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* st, int B, int H, int KV, int Sq, int Sk, int BQ,
           int window, int causal, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * KV);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], H, KV, Sq, Sk, BQ, window,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const long long* st, int B, int H, int KV, int Sq, int Sk, int D,
             int BQ, int window, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, st, B, H, KV, Sq, Sk, BQ, window,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, st, B, H, KV, Sq, Sk, BQ, window,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, st, B, H, KV, Sq, Sk, BQ, window,
                            causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, st, B, H, KV, Sq, Sk, BQ, window,
                            causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements (batch, head, position
// of q, k and v); out is (B, H, Sq, D) contiguous.  BQ query positions per
// block with G·BQ <= 64; window 0 means none; scale is D^-0.5 as the caller
// rounds it to float.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int B,
    int H, int KV, int Sq, int Sk, int D, int BQ, int window, int causal,
    float scale, int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || BQ < 1 ||
      (H / KV) * BQ > kRows || window < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, st, B, H, KV, Sq, Sk, D, BQ, window,
                           causal, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, st, B, H, KV, Sq, Sk, D, BQ,
                                   window, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
