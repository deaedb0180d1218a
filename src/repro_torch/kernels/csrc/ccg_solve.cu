// Fully fused CCG solve (paper Alg. 2) — one warp per task.
//
// Replaces: src/repro/kernels/ccg_solve/kernel.py:ccg_solve (Pallas body
// _solve_kernel), the TPU kernel that runs encode, the min(max_iters, P+1)
// master/adversary steps and the epilogue for a (128,)-task tile with the
// (M, F) solver state resident in VMEM.
//
// What bounds it on the H100: latency, not bytes or operations.  Per task it
// reads 12 B and writes 24 B (147 KB at M = 4096, 44 ns at 3.35 TB/s); once
// the task-independent tables (a_max·sat per option and version, the
// recourse of every version subset at every pole) are built, the function
// needs about 1.6 k operations of encode and 0.2 k per CCG step, some 8-9 M
// for the batch (~0.13 us at the float32 peak); but each step is a chain of
// dependent warp reductions (master argmin over F, worst pole over P) and up
// to 8 steps run back to back.  This kernel recomputes those tables' entries
// per task, so it does several times that count.
//
// Design: F = 50 options are padded to 64, two per lane (f = lane and
// f = lane + 32); padded options are infeasible with objective +inf and
// accuracy -inf, so they never win a reduction that a real option could.
// The per-option state (feasibility bitmask `code`, running eta) lives in
// registers for all steps.  The task-independent tables (c1, option
// coordinates, the (K, F) costs, 1 + u for every pole) sit in shared memory.
// Every argmin/argmax is a butterfly shuffle reduction on (value, index) in
// which the lower index wins ties, which is the reference's
// first-index-achieving-the-extremum rule.  The worst-pole search runs one
// pole per lane (P <= 32).  A warp whose task has converged leaves the step
// loop: done lanes are frozen in the reference, so the exit is exact and is
// also the per-task early exit.  Arithmetic is the plain version's float32
// operations in the same order, compiled with -fmad=false, so decisions,
// bounds and iteration counts match it bit for bit on the same card.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;        // tasks per block
constexpr int kMaxF = 64;
constexpr int kMaxK = 8;
constexpr int kMaxP = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float accuracy(float z, float r, float p, float k,
                                          float tier) {
  // repro/core/cost_model.py:_accuracy_formula, same op order
  const float a_max = 0.60f + 0.045f * k + 0.04f * tier;
  const float sat = 1.0f - expf(-(2.5f + 0.3f * k) * r);
  float f = a_max * sat;
  f = f - 0.10f * z * (1.0f - p) - 0.06f * z * (1.0f - r);
  return fminf(fmaxf(f, 0.0f), 1.0f);
}

// (value, index) reductions across the warp; the lower index wins ties.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

struct Tables {
  float c1[kMaxF], rn[kMaxF], pn[kMaxF], tier[kMaxF], ok[kMaxF];
  float b2k[kMaxK * kMaxF];   // (K, F)
  float opu[kMaxP * kMaxK];   // (P, K): 1 + u
  float u[kMaxP * kMaxK];     // (P, K)
};

__global__ void ccg_solve_kernel(
    const float* __restrict__ z, const float* __restrict__ aq,
    const int* __restrict__ warm_y, const float* __restrict__ rn,
    const float* __restrict__ pn, const float* __restrict__ tier,
    const float* __restrict__ y_ok, const float* __restrict__ b2k,
    const float* __restrict__ u_all, const float* __restrict__ c1,
    int* __restrict__ y_f_out, int* __restrict__ v_out,
    float* __restrict__ o_up_out, float* __restrict__ o_down_out,
    int* __restrict__ iters_out, int* __restrict__ infeas_out,
    int M, int F, int K, int P, int n_steps, float margin, float theta) {
  __shared__ Tables s;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    s.c1[i] = c1[i];
    s.rn[i] = rn[i];
    s.pn[i] = pn[i];
    s.tier[i] = tier[i];
    s.ok[i] = y_ok[i];
  }
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) s.b2k[i] = b2k[i];
  for (int i = threadIdx.x; i < P * K; i += blockDim.x) {
    s.u[i] = u_all[i];
    s.opu[i] = 1.0f + u_all[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= M) return;   // warp-uniform

  const float zt = z[task];
  const float thr = aq[task] + margin;
  const int f0 = lane, f1 = lane + 32;
  const bool has0 = f0 < F, has1 = f1 < F;

  // ---- encode: feasibility bitmask + running flat accuracy argmax ----
  int code0 = 0, code1 = 0;
  float bv0 = -CUDART_INF_F, bv1 = -CUDART_INF_F;
  int bk0 = 0, bk1 = 0;
  for (int k = 0; k < K; ++k) {
    const float kf = (float)k;
    if (has0) {
      float f = accuracy(zt, s.rn[f0], s.pn[f0], kf, s.tier[f0]);
      if (!(s.ok[f0] > 0.0f)) f = -kBig;
      if (f >= thr) code0 |= 1 << k;
      if (k == 0 || f > bv0) { bv0 = f; bk0 = k; }
    }
    if (has1) {
      float f = accuracy(zt, s.rn[f1], s.pn[f1], kf, s.tier[f1]);
      if (!(s.ok[f1] > 0.0f)) f = -kBig;
      if (f >= thr) code1 |= 1 << k;
      if (k == 0 || f > bv1) { bv1 = f; bk1 = k; }
    }
  }
  // flat argmax over (F, K), k minor: first option with the max, its k
  float bmax = bv0;
  int by = f0;
  if (bv1 > bmax) { bmax = bv1; by = f1; }
  warp_argmax(bmax, by);
  const int bk_by = __shfl_sync(kFull, by < 32 ? bk0 : bk1, by & 31);
  const int best = by * K + bk_by;
  const bool fs0 = has0 && code0 > 0, fs1 = has1 && code1 > 0;
  const bool none_ok = !__any_sync(kFull, fs0 || fs1);

  // (q, worst pole) of option y: one pole per lane, K-fold masked min
  auto sp_worst = [&](int y, float& q, int& pole) {
    const int cy = __shfl_sync(kFull, y < 32 ? code0 : code1, y & 31);
    float sp = -CUDART_INF_F;
    if (lane < P) {
      sp = kBig;
      for (int k = 0; k < K; ++k) {
        const float term = s.b2k[k * F + y] * s.opu[lane * K + k];
        if ((cy >> k) & 1) sp = fminf(sp, term);
      }
    }
    q = sp;
    pole = lane;
    warp_argmax(q, pole);
  };
  // recourse of this lane's two options at `pole`
  auto rec_at = [&](int code, int f, int pole) {
    float rec = kBig;
    for (int k = 0; k < K; ++k) {
      const float term = s.b2k[k * F + f] * s.opu[pole * K + k];
      if ((code >> k) & 1) rec = fminf(rec, term);
    }
    return rec;
  };

  // ---- warm start: seed the scenario set with the warm y's worst pole ----
  const int wy = warm_y[task];
  const int wyc = wy > 0 ? wy : 0;
  const bool fs_wy = __shfl_sync(kFull, (int)(wyc < 32 ? fs0 : fs1), wyc & 31) != 0;
  const bool use_warm = wy >= 0 && fs_wy;
  float q_w;
  int warm_pole;
  sp_worst(wyc, q_w, warm_pole);
  float o_up = use_warm ? s.c1[wyc] + q_w : kBig;
  float eta0 = 0.0f, eta1 = 0.0f;
  if (use_warm) {
    if (has0) eta0 = rec_at(code0, f0, warm_pole);
    if (has1) eta1 = rec_at(code1, f1, warm_pole);
  }
  float o_down = -kBig;
  int y_best = wyc;
  int iters = 0;

  // ---- CCG alternation; a converged task leaves the loop ----
  for (int step = 0; step < n_steps; ++step) {
    float od = fs0 ? s.c1[f0] + eta0 : (has0 ? kBig : CUDART_INF_F);
    int y_star = f0;
    const float o1 = fs1 ? s.c1[f1] + eta1 : (has1 ? kBig : CUDART_INF_F);
    if (o1 < od) { od = o1; y_star = f1; }
    warp_argmin(od, y_star);
    float q;
    int worst_pole;
    sp_worst(y_star, q, worst_pole);
    const float cand = s.c1[y_star] + q;
    const float up_new = fminf(o_up, cand);
    if (cand < o_up) y_best = y_star;
    o_down = od;
    o_up = up_new;
    if (has0) eta0 = fmaxf(eta0, rec_at(code0, f0, worst_pole));
    if (has1) eta1 = fmaxf(eta1, rec_at(code1, f1, worst_pole));
    iters += 1;
    if ((up_new - od) <= theta) break;
  }

  // ---- epilogue: final worst pole, v*, all-infeasible fallback ----
  float qf;
  int wp;
  sp_worst(y_best, qf, wp);
  const int code_y = __shfl_sync(kFull, y_best < 32 ? code0 : code1, y_best & 31);
  if (lane == 0) {
    float vmin = CUDART_INF_F;
    int v_star = 0;
    for (int k = 0; k < K; ++k) {
      const float val = ((code_y >> k) & 1)
                            ? s.b2k[k * F + y_best] * (1.0f + s.u[wp * K + k])
                            : kBig;
      if (val < vmin) { vmin = val; v_star = k; }
    }
    y_f_out[task] = none_ok ? best / K : y_best;
    v_out[task] = none_ok ? best % K : v_star;
    o_up_out[task] = o_up;
    o_down_out[task] = o_down;
    iters_out[task] = iters;
    infeas_out[task] = none_ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int ccg_solve_launch(
    const void* z, const void* aq, const void* warm_y, const void* rn,
    const void* pn, const void* tier, const void* y_ok, const void* b2k,
    const void* u_all, const void* c1, void* y_f, void* v_star, void* o_up,
    void* o_down, void* iters, void* infeasible, int M, int F, int K, int P,
    int n_steps, float margin, float theta, void* stream) {
  if (F < 1 || F > kMaxF || K < 1 || K > kMaxK || P < 1 || P > kMaxP ||
      M % kWarps != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M > 0) {
    ccg_solve_kernel<<<M / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const float*)z, (const float*)aq, (const int*)warm_y,
        (const float*)rn, (const float*)pn, (const float*)tier,
        (const float*)y_ok, (const float*)b2k, (const float*)u_all,
        (const float*)c1, (int*)y_f, (int*)v_star, (float*)o_up,
        (float*)o_down, (int*)iters, (int*)infeasible, M, F, K, P, n_steps,
        margin, theta);
  }
  return (int)cudaGetLastError();
}
