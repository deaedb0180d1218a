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
// to 8 steps run back to back.
//
// Design: F = 50 options are padded to 64, two per lane (f = lane and
// f = lane + 32); padded options are infeasible with objective +inf and
// accuracy -inf, so they never win a reduction that a real option could.
// The per-option state (feasibility bitmask `code`, running eta) lives in
// registers for all steps.  Every argmin/argmax takes the first index
// achieving the extremum, the reference's rule: one warp reduction
// (redux.sync) of keys in the floats' order, then a ballot of the lanes
// holding it (f = lane before f = lane + 32).  The worst-pole search runs
// one pole per lane (P <= 32).  A warp whose task has converged leaves the
// step loop: done lanes are frozen in the reference, so the exit is exact
// and is also the per-task early exit.
//
// The table path (K <= 5, the paper's K = 5; ccg_solve_kernel_tables) does
// the work the bound counts.  A persistent grid, one block of kTableWarps
// warps an SM, builds the task-independent tables once per block in
// dynamic shared memory (ccg_tables.cuh, shared with ccg_encode.cu): a_max·sat
// per (version, option) and the recourse of every version subset at every
// pole, rec[p][code][f] = the masked min over code's versions of
// b2k·(1 + u) (P = 16, 2^K = 32: 131 KB).  Then each warp walks its share
// of the tasks: the encode is the
// per-option difficulty terms and K subtract/clamp/test steps, and every
// recourse value one shared load.  A larger K (the wrapper admits K <= 8),
// or tables that do not fit, take the generic kernel (ccg_solve_kernel),
// which recomputes those entries per task (K exponentials per option, a
// K-fold masked min per recourse value).  Both paths run the plain version's
// float32 operations in its order, compiled with -fmad=false (fminf is
// exact, the products single multiplies), so decisions, bounds and
// iteration counts match it bit for bit on the same card.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "accuracy.cuh"
#include "ccg_tables.cuh"
#include "warp_reduce.cuh"

namespace {

using ccg::kBig;
using ccg::kMaxF;
using ccg::table_bytes;
using ccg::table_fs;
using ccg::table_ps;

constexpr int kWarps = 8;          // tasks per block, generic kernel
constexpr int kTableWarps = 32;    // warps per block, table kernel
constexpr int kTableMaxK = 5;      // largest K of the table kernel
constexpr int kMaxK = 8;
constexpr int kMaxP = 32;

struct Tables : ccg::OptionTable {
  float c1[kMaxF];
  float b2k[kMaxK * kMaxF];   // (K, F)
  float opu[kMaxP * kMaxK];   // (P, K): 1 + u
  float u[kMaxP * kMaxK];     // (P, K)
};

// A task's inputs: difficulty, accuracy requirement, warm start.
struct Task {
  float z, aq;
  int warm_y;
};

struct Problem {
  const float* z;
  const float* aq;
  const int* warm_y;
  int* y_f;
  int* v_star;
  float* o_up;
  float* o_down;
  int* iters;
  int* infeasible;
  int M, F, K, P, n_steps;
  float margin, theta;
  __device__ Task load(int task) const {
    return {z[task], aq[task], warm_y[task]};
  }
};

// The task-independent inputs: (F,) option coordinates, availability and
// first-stage costs, the (K, F) second-stage costs, the (P, K) deviations.
struct Inputs {
  const float *rn, *pn, *tier, *y_ok, *b2k, *u_all, *c1;
};

__device__ void fill_tables(Tables& s, const Inputs& in, int F, int K,
                            int P) {
  ccg::fill_options(s, in.rn, in.pn, in.tier, in.y_ok, F);
  for (int i = threadIdx.x; i < F; i += blockDim.x) s.c1[i] = in.c1[i];
  for (int i = threadIdx.x; i < K * F; i += blockDim.x) s.b2k[i] = in.b2k[i];
  for (int i = threadIdx.x; i < P * K; i += blockDim.x) {
    s.u[i] = in.u_all[i];
    s.opu[i] = 1.0f + in.u_all[i];
  }
}

// The first lane holding the warp's max of v, and that max in v: one
// reduction of the keys, one ballot of the lanes that hold it (a third of
// the instructions of five shuffle rounds on (value, index)).
__device__ __forceinline__ int argmax_lanes(float& v) {
  const unsigned key = order_key(v);
  const unsigned top = __reduce_max_sync(kFullMask, key);
  const int i = __ffs(__ballot_sync(kFullMask, key == top)) - 1;
  v = __shfl_sync(kFullMask, v, i);
  return i;
}

// The first index f in [0, 64) of the warp's min (kMax: max) over v0, the
// value of f = lane, and v1, that of f = lane + 32; the value in `best`.
template <bool kMax>
__device__ __forceinline__ int arg_pair(float v0, float v1, float& best) {
  const unsigned k0 = order_key(v0), k1 = order_key(v1);
  const unsigned m = kMax ? __reduce_max_sync(kFullMask, k0 > k1 ? k0 : k1)
                          : __reduce_min_sync(kFullMask, k0 < k1 ? k0 : k1);
  const unsigned b0 = __ballot_sync(kFullMask, k0 == m);
  const int i =
      b0 ? __ffs(b0) - 1 : 31 + __ffs(__ballot_sync(kFullMask, k1 == m));
  best = __shfl_sync(kFullMask, i < 32 ? v0 : v1, i & 31);
  return i;
}

// Per-task recomputation (any K <= 8): a_max·sat with its exponential,
// and the K-fold masked min of every recourse value.
struct Recompute {
  const Tables& s;
  int F, K;
  __device__ int versions() const { return K; }
  __device__ float base(int f, int k) const {
    return accuracy_base(s.rn[f], (float)k, s.tier[f]);
  }
  __device__ float rec(int code, int f, int pole) const {
    float v = kBig;
    for (int k = 0; k < K; ++k) {
      const float term = s.b2k[k * F + f] * s.opu[pole * K + k];
      if ((code >> k) & 1) v = fminf(v, term);
    }
    return v;
  }
};

// Lookups in the tables that the table kernel built in shared memory; K
// is a constant, so the per-version loops unroll.
template <int kK>
struct Lookup {
  const float* ams;       // (K, fs): a_max·sat
  const float* rec_tab;   // (P, ps): pole p's (2^K, fs) subsets, padded
  int fs, ps;
  __device__ static constexpr int versions() { return kK; }
  __device__ float base(int f, int k) const { return ams[k * fs + f]; }
  __device__ float rec(int code, int f, int pole) const {
    return rec_tab[pole * ps + code * fs + f];
  }
};

// The whole solve of one task, its inputs `in`, by one warp.
template <class Tab>
__device__ __forceinline__ void solve_task(const Tab& tab, const Tables& s,
                                           const Problem& pr, int task,
                                           const Task& in, int lane) {
  const int F = pr.F, K = tab.versions(), P = pr.P;
  const float zt = in.z;
  const float thr = in.aq + pr.margin;
  const int f0 = lane, f1 = lane + 32;
  const bool has0 = f0 < F, has1 = f1 < F;

  // ---- encode: feasibility bitmask + running flat accuracy argmax ----
  int code0 = 0, code1 = 0;
  float bv0 = -CUDART_INF_F, bv1 = -CUDART_INF_F;
  int bk0 = 0, bk1 = 0;
  if (has0) {
    const float zp = 0.10f * zt * (1.0f - s.pn[f0]);
    const float zr = 0.06f * zt * (1.0f - s.rn[f0]);
    const bool ok = s.ok[f0] > 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float f = accuracy_clamp(tab.base(f0, k), zp, zr);
      if (!ok) f = -kBig;
      if (f >= thr) code0 |= 1 << k;
      if (k == 0 || f > bv0) { bv0 = f; bk0 = k; }
    }
  }
  if (has1) {
    const float zp = 0.10f * zt * (1.0f - s.pn[f1]);
    const float zr = 0.06f * zt * (1.0f - s.rn[f1]);
    const bool ok = s.ok[f1] > 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float f = accuracy_clamp(tab.base(f1, k), zp, zr);
      if (!ok) f = -kBig;
      if (f >= thr) code1 |= 1 << k;
      if (k == 0 || f > bv1) { bv1 = f; bk1 = k; }
    }
  }
  // flat argmax over (F, K), k minor: first option with the max, its k
  float bmax;
  const int by = arg_pair<true>(bv0, bv1, bmax);
  const int bk_by = __shfl_sync(kFullMask, by < 32 ? bk0 : bk1, by & 31);
  const int best = by * K + bk_by;
  const bool fs0 = has0 && code0 > 0, fs1 = has1 && code1 > 0;
  const bool none_ok = !__any_sync(kFullMask, fs0 || fs1);

  // (q, worst pole) of option y: one pole per lane
  auto sp_worst = [&](int y, float& q, int& pole) {
    const int cy = __shfl_sync(kFullMask, y < 32 ? code0 : code1, y & 31);
    q = lane < P ? tab.rec(cy, y, lane) : -CUDART_INF_F;
    pole = argmax_lanes(q);
  };

  // ---- warm start: seed the scenario set with the warm y's worst pole ----
  const int wy = in.warm_y;
  const int wyc = wy > 0 ? wy : 0;
  const bool fs_wy = __shfl_sync(kFullMask, (int)(wyc < 32 ? fs0 : fs1), wyc & 31) != 0;
  const bool use_warm = wy >= 0 && fs_wy;
  float q_w;
  int warm_pole;
  sp_worst(wyc, q_w, warm_pole);
  float o_up = use_warm ? s.c1[wyc] + q_w : kBig;
  float eta0 = 0.0f, eta1 = 0.0f;
  if (use_warm) {
    if (has0) eta0 = tab.rec(code0, f0, warm_pole);
    if (has1) eta1 = tab.rec(code1, f1, warm_pole);
  }
  float o_down = -kBig;
  int y_best = wyc;
  int iters = 0;

  // ---- CCG alternation; a converged task leaves the loop ----
  for (int step = 0; step < pr.n_steps; ++step) {
    const float o0 = fs0 ? s.c1[f0] + eta0 : (has0 ? kBig : CUDART_INF_F);
    const float o1 = fs1 ? s.c1[f1] + eta1 : (has1 ? kBig : CUDART_INF_F);
    float od;
    const int y_star = arg_pair<false>(o0, o1, od);
    float q;
    int worst_pole;
    sp_worst(y_star, q, worst_pole);
    const float cand = s.c1[y_star] + q;
    const float up_new = fminf(o_up, cand);
    if (cand < o_up) y_best = y_star;
    o_down = od;
    o_up = up_new;
    if (has0) eta0 = fmaxf(eta0, tab.rec(code0, f0, worst_pole));
    if (has1) eta1 = fmaxf(eta1, tab.rec(code1, f1, worst_pole));
    iters += 1;
    if ((up_new - od) <= pr.theta) break;
  }

  // ---- epilogue: final worst pole, v*, all-infeasible fallback ----
  float qf;
  int wp;
  sp_worst(y_best, qf, wp);
  const int code_y = __shfl_sync(kFullMask, y_best < 32 ? code0 : code1, y_best & 31);
  if (lane == 0) {
    float vmin = CUDART_INF_F;
    int v_star = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float val = ((code_y >> k) & 1)
                            ? s.b2k[k * F + y_best] * (1.0f + s.u[wp * K + k])
                            : kBig;
      if (val < vmin) { vmin = val; v_star = k; }
    }
    pr.y_f[task] = none_ok ? best / K : y_best;
    pr.v_star[task] = none_ok ? best % K : v_star;
    pr.o_up[task] = o_up;
    pr.o_down[task] = o_down;
    pr.iters[task] = iters;
    pr.infeasible[task] = none_ok ? 1 : 0;
  }
}

// The generic kernel: one task per warp, kWarps tasks a block.
__global__ void ccg_solve_kernel(Problem pr, Inputs in) {
  __shared__ Tables s;
  fill_tables(s, in, pr.F, pr.K, pr.P);
  __syncthreads();
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= pr.M) return;   // warp-uniform
  solve_task(Recompute{s, pr.F, pr.K}, s, pr, task, pr.load(task),
             threadIdx.x & 31);
}

// The table kernel: builds the tables once, then walks tasks
// blockIdx.x·kTableWarps + warp, stepping by the grid's warps; each task's
// inputs are loaded one task ahead (the first while the tables are built).
template <int kK>
__global__ void __launch_bounds__(32 * kTableWarps, 1)
    ccg_solve_kernel_tables(Problem pr, Inputs in) {
  __shared__ Tables s;
  extern __shared__ float dyn[];
  const int F = pr.F, P = pr.P;
  const int fs = table_fs(F), ps = table_ps(F, kK);
  float* ams = dyn;
  float* rec_tab = dyn + kK * fs;
  const int stride = gridDim.x * kTableWarps;
  int task = blockIdx.x * kTableWarps + (threadIdx.x >> 5);
  Task next = task < pr.M ? pr.load(task) : Task{};
  fill_tables(s, in, F, kK, P);
  __syncthreads();
  ccg::fill_ams<kK>(ams, s.rn, s.tier, F);
  auto pole_cost = [&](int k, int p, int f) {
    return s.b2k[k * F + f] * s.opu[p * kK + k];
  };
  ccg::fill_subsets<kK>(rec_tab, F, P, pole_cost);
  __syncthreads();
  const Lookup<kK> tab{ams, rec_tab, fs, ps};
  const int lane = threadIdx.x & 31;
  for (; task < pr.M; task += stride) {   // warp-uniform
    const Task in = next;
    if (task + stride < pr.M) next = pr.load(task + stride);
    solve_task(tab, s, pr, task, in, lane);
  }
}

// the dynamic shared memory a table block may take
int table_smem(const ccg::Card& card) {
  return card.optin - (int)sizeof(Tables);
}

template <int kK>
int launch_table(const Problem& pr, const Inputs& in, const ccg::Card& card,
                 cudaStream_t stream) {
  static int opted_in = -1;   // the device whose limit this kernel took
  const cudaError_t e = ccg::opt_in(ccg_solve_kernel_tables<kK>, card,
                                    table_smem(card), opted_in);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = table_bytes(pr.F, kK, pr.P);
  const int sms = card.sms;
  const int blocks = (pr.M + kTableWarps - 1) / kTableWarps;
  ccg_solve_kernel_tables<kK>
      <<<blocks < sms ? blocks : sms, 32 * kTableWarps, smem, stream>>>(
          pr, in);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccg_solve_launch(
    const void* z, const void* aq, const void* warm_y, const void* rn,
    const void* pn, const void* tier, const void* y_ok, const void* b2k,
    const void* u_all, const void* c1, void* y_f, void* v_star, void* o_up,
    void* o_down, void* iters, void* infeasible, int M, int F, int K, int P,
    int n_steps, float margin, float theta, void* stream) {
  if (F < 1 || F > kMaxF || K < 1 || K > kMaxK || P < 1 || P > kMaxP ||
      M < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaGetLastError();
  const Problem pr{(const float*)z, (const float*)aq, (const int*)warm_y,
                   (int*)y_f, (int*)v_star, (float*)o_up, (float*)o_down,
                   (int*)iters, (int*)infeasible, M, F, K, P, n_steps,
                   margin, theta};
  const Inputs in{(const float*)rn,   (const float*)pn,
                  (const float*)tier, (const float*)y_ok,
                  (const float*)b2k,  (const float*)u_all,
                  (const float*)c1};
  cudaStream_t st = (cudaStream_t)stream;
  const ccg::Card& card = ccg::current_card();
  if (K <= kTableMaxK && table_bytes(F, K, P) <= (size_t)table_smem(card)) {
    switch (K) {
      case 1: return launch_table<1>(pr, in, card, st);
      case 2: return launch_table<2>(pr, in, card, st);
      case 3: return launch_table<3>(pr, in, card, st);
      case 4: return launch_table<4>(pr, in, card, st);
      default: return launch_table<5>(pr, in, card, st);
    }
  }
  ccg_solve_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(pr,
                                                                      in);
  return (int)cudaGetLastError();
}
