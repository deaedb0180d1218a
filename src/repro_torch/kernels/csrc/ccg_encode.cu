// Fused per-task CCG encoding (the inputs of the unrolled Alg. 2 solver).
//
// Replaces: src/repro/kernels/ccg_encode/kernel.py:ccg_encode (Pallas body
// _encode_kernel), the TPU kernel that streams (128,)-task tiles with the
// (K, P, F) pole-scaled cost slab resident in VMEM and folds the (M, P, F)
// recourse slab in place.
//
// What bounds it on the H100: bytes.  It must write the (M, P, F) recourse
// slab, the (M, F) bitmask and the (M,) argmax: at M = 4096, P = 16, F = 50
// that is 13.1 MB + 0.82 MB, about 4.2 us at 3.35 TB/s (the slab fits in the
// 50 MB L2, so a run may write it faster than HBM would take it), against
// some 20 operations per (task, option, version) once the accuracy's
// task-independent part is tabulated (~0.1 us at the float32 peak).  The
// inputs are a few kilobytes.
//
// The table path (K <= 5, the paper's K = 5, F <= 64 and tables that fit;
// ccg_encode_kernel_tables) does the writing and little else.  A persistent
// grid, one block of kTableWarps warps an SM, builds the task-independent
// tables once per block in dynamic shared memory (ccg_tables.cuh, shared
// with ccg_solve.cu): a_max·sat per (version, option) and the recourse of
// every version subset at every pole, rec[p][code][f], from the (K, P, F)
// pole-scaled costs.  A lane holds options f = lane and f = lane + 32: their
// coordinates and a_max·sat at every version sit in registers for the whole
// walk.  Then each warp walks its tasks, loading the next task's (z, aq) one
// task ahead: per option the two difficulty terms and K subtract/clamp/test
// steps give the feasible-version bitmask `code`; the flat accuracy argmax
// (index f·K + k) is a lane-local strict `>` in increasing index, then a
// vote in which the lower index wins ties, the reference's first maximum;
// and each of the task's P·F recourse values is one shared load,
// rec[p][code[f]][f], stored row by row (a pole's options across the
// lanes, coalesced; staging the task's block in shared memory for 16-byte
// or bulk-copy stores was slower on the H100, as were blocks of 8 or 32
// warps, and copying a prebuilt table from device memory was slower than
// building it).
//
// The generic path (ccg_encode_kernel, this kernel's first design), for
// K > 5, F > 64 or tables that do not fit: one warp per task, lanes striding
// over the options; each lane computes its options' accuracy for every
// version (accuracy.cuh), sets the bits, and writes the option's recourse at
// every pole as the masked min of the pole-scaled costs (a (K, P, F) slab in
// shared memory, loaded once per block of eight tasks) over the feasible
// versions; the argmax as above by butterfly shuffles.  The min-fold and the
// subset table equal the plain version's gather of the (P, F, 2^K) subset
// lookup bit for bit, since a float min is exact and its order does not
// matter; both paths compute the accuracy with the plain version's float32
// operations in its order, compiled with -fmad=false.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "accuracy.cuh"
#include "ccg_tables.cuh"
#include "warp_reduce.cuh"

namespace {

using ccg::kBig;
using ccg::kMaxF;
using ccg::table_fs;
using ccg::table_ps;

constexpr int kWarps = 8;          // tasks per block, one warp each (generic)
constexpr int kMaxSlab = 12288;    // K·P·F floats in 48 KB of shared memory
constexpr int kMaxK = 31;          // the bitmask is an int32
constexpr int kTableWarps = 16;    // warps per block, table kernel
constexpr int kTableMaxK = 5;      // largest K of the table kernel

__global__ void ccg_encode_kernel(
    const float* __restrict__ z, const float* __restrict__ aq,
    const float* __restrict__ rn, const float* __restrict__ pn,
    const float* __restrict__ tier, const float* __restrict__ y_ok,
    const float* __restrict__ b2s, int* __restrict__ code_out,
    float* __restrict__ rec_out, int* __restrict__ best_out, int M, int F,
    int K, int P, float margin) {
  extern __shared__ float s_b2s[];   // (K, P, F)
  const int slab = K * P * F;
  for (int i = threadIdx.x; i < slab; i += blockDim.x) s_b2s[i] = b2s[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= M) return;   // warp-uniform

  const float zt = z[task];
  const float thr = aq[task] + margin;
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int f = lane; f < F; f += 32) {
    const bool ok = y_ok[f] > 0.0f;
    const float r = rn[f], p = pn[f], t = tier[f];
    int code = 0;
    for (int k = 0; k < K; ++k) {
      float acc = accuracy(zt, r, p, (float)k, t);
      if (!ok) acc = -kBig;
      if (acc >= thr) code |= 1 << k;
      if (acc > bv) { bv = acc; bi = f * K + k; }
    }
    code_out[(size_t)task * F + f] = code;
    float* rec = rec_out + (size_t)task * P * F + f;
    for (int pole = 0; pole < P; ++pole) {
      float v = kBig;
      for (int k = 0; k < K; ++k) {
        if ((code >> k) & 1) v = fminf(v, s_b2s[(k * P + pole) * F + f]);
      }
      rec[(size_t)pole * F] = v;
    }
  }
  warp_argmax(bv, bi);
  if (lane == 0) best_out[task] = bi;
}

struct Encode {
  const float *z, *aq, *rn, *pn, *tier, *y_ok, *b2s;
  int* code_out;
  float* rec_out;
  int* best_out;
  int M, F, K, P;
  float margin;
};

// the dynamic shared memory of the table kernel: its tables
inline size_t table_kernel_bytes(int F, int K, int P) {
  return ccg::table_bytes(F, K, P);
}

// A lane's option: its difficulty factors, availability and a_max·sat at
// every version, held for the whole walk.
template <int kK>
struct Option {
  bool has, ok;
  float one_m_p, one_m_r;
  float base[kK];

  __device__ Option(const ccg::OptionTable& s, const float* ams, int fs,
                    int f, int F)
      : has(f < F) {
    ok = has && s.ok[f] > 0.0f;
    one_m_p = has ? 1.0f - s.pn[f] : 0.0f;
    one_m_r = has ? 1.0f - s.rn[f] : 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) base[k] = has ? ams[k * fs + f] : 0.0f;
  }

  // the feasible-version bitmask at (z, thr); the lane's running flat
  // argmax (bv, bi) takes the option's versions in increasing index
  __device__ int encode(float zt, float thr, int f, float& bv,
                        int& bi) const {
    if (!has) return 0;
    const float zp = 0.10f * zt * one_m_p;
    const float zr = 0.06f * zt * one_m_r;
    int code = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float acc = accuracy_clamp(base[k], zp, zr);
      if (!ok) acc = -kBig;
      if (acc >= thr) code |= 1 << k;
      if (acc > bv) { bv = acc; bi = f * kK + k; }
    }
    return code;
  }
};

// The table kernel: builds the tables once, then walks tasks
// blockIdx.x·kTableWarps + warp, stepping by the grid's warps.
template <int kK>
__global__ void __launch_bounds__(32 * kTableWarps, 1)
    ccg_encode_kernel_tables(Encode e) {
  __shared__ ccg::OptionTable s;
  extern __shared__ __align__(16) float dyn[];
  const int F = e.F, P = e.P;
  const int fs = table_fs(F), ps = table_ps(F, kK);
  float* ams = dyn;
  float* rec_tab = dyn + kK * fs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kTableWarps;
  int task = blockIdx.x * kTableWarps + warp;
  float2 next = task < e.M ? make_float2(e.z[task], e.aq[task])
                           : make_float2(0.0f, 0.0f);
  ccg::fill_options(s, e.rn, e.pn, e.tier, e.y_ok, F);
  __syncthreads();
  ccg::fill_ams<kK>(ams, s.rn, s.tier, F);
  const float* b2s = e.b2s;
  auto pole_cost = [&](int k, int p, int f) {
    return b2s[(k * P + p) * F + f];
  };
  ccg::fill_subsets<kK>(rec_tab, F, P, pole_cost);
  __syncthreads();

  const int f0 = lane, f1 = lane + 32;
  const Option<kK> o0(s, ams, fs, f0, F), o1(s, ams, fs, f1, F);
  const float* tab0 = rec_tab + f0;
  const float* tab1 = rec_tab + f1;
  for (; task < e.M; task += stride) {   // warp-uniform
    const float zt = next.x, thr = next.y + e.margin;
    if (task + stride < e.M) next = make_float2(e.z[task + stride],
                                                e.aq[task + stride]);
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    const int code0 = o0.encode(zt, thr, f0, bv, bi);
    const int code1 = o1.encode(zt, thr, f1, bv, bi);
    const int best = vote_first<true>(bv, bi);
    if (lane == 0) e.best_out[task] = best;
    int* code_t = e.code_out + (size_t)task * F;
    if (o0.has) code_t[f0] = code0;
    if (o1.has) code_t[f1] = code1;

    float* out = e.rec_out + (size_t)task * P * F;
    const float* t0 = tab0 + code0 * fs;
    const float* t1 = tab1 + code1 * fs;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      if (o0.has) out[p * F + f0] = t0[p * ps];
      if (o1.has) out[p * F + f1] = t1[p * ps];
    }
  }
}

int table_smem(const ccg::Card& card) {
  return card.optin - (int)sizeof(ccg::OptionTable);
}

template <int kK>
int launch_table(const Encode& e, const ccg::Card& card,
                 cudaStream_t stream) {
  static int opted_in = -1;   // the device whose limit this kernel took
  const cudaError_t err = ccg::opt_in(ccg_encode_kernel_tables<kK>, card,
                                      table_smem(card), opted_in);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (e.M + kTableWarps - 1) / kTableWarps;
  ccg_encode_kernel_tables<kK>
      <<<blocks < card.sms ? blocks : card.sms, 32 * kTableWarps,
         table_kernel_bytes(e.F, kK, e.P), stream>>>(e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccg_encode_launch(
    const void* z, const void* aq, const void* rn, const void* pn,
    const void* tier, const void* y_ok, const void* b2s, void* code,
    void* rec_all, void* best, int M, int F, int K, int P, float margin,
    void* stream) {
  if (M < 0 || F < 1 || K < 1 || K > kMaxK || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const ccg::Card& card = ccg::current_card();
  if (K <= kTableMaxK && F <= kMaxF &&
      table_kernel_bytes(F, K, P) <= (size_t)table_smem(card)) {
    const Encode e{(const float*)z,    (const float*)aq,  (const float*)rn,
                   (const float*)pn,   (const float*)tier,
                   (const float*)y_ok, (const float*)b2s, (int*)code,
                   (float*)rec_all,    (int*)best,        M,
                   F,                  K,                 P,
                   margin};
    switch (K) {
      case 1: return launch_table<1>(e, card, st);
      case 2: return launch_table<2>(e, card, st);
      case 3: return launch_table<3>(e, card, st);
      case 4: return launch_table<4>(e, card, st);
      default: return launch_table<5>(e, card, st);
    }
  }
  if ((long long)K * P * F > kMaxSlab) return (int)cudaErrorInvalidValue;
  const int grid = (M + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * (size_t)K * P * F;
  ccg_encode_kernel<<<grid, 32 * kWarps, smem, st>>>(
      (const float*)z, (const float*)aq, (const float*)rn, (const float*)pn,
      (const float*)tier, (const float*)y_ok, (const float*)b2s, (int*)code,
      (float*)rec_all, (int*)best, M, F, K, P, margin);
  return (int)cudaGetLastError();
}
