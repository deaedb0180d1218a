#!/usr/bin/env python3
"""Variants of the port's CUDA kernels, checked and timed in turns on one
NVIDIA GPU.

    python3 tools/kernel_variants.py [--kernel ccg_encode|ccg_master|
                                      mamba_scan|flash_attention|
                                      decode_attention|lpt_queue|
                                      rglru_scan|ccg_solve|gate_cell|
                                      gate_cell_bwd|c6_repair|
                                      flash_attention_bwd]
                                     [--rounds 2] [--diagnose] [--reps 200]
                                     [--baseline TREE]

Builds each kernel as committed (``src/repro_torch/kernels/csrc/``) and
variants made by editing its source, each into its own library under
``build/kernel_variants/`` (one ``nvcc`` per variant, all started
together), then checks and times every library in turn, ``--rounds`` times
over and in the reverse order every other round, so that a drift of the
card reaches them alike.  A variant outside its tolerance is reported, not
timed.

  ccg_encode       committed      K <= 5: tables once per block, persistent
                                  grid of 16-warp blocks, a pole's row
                                  stored across the lanes; else generic
                   fold           the generic kernel (the kernel's first
                                  design: one warp per task, the K-fold
                                  masked min per recourse value) at every K
                   copy_table     the subset table copied from device
                                  memory (given in the shared layout,
                                  ``shared_layout``), not built
                   stores_vector  a task's block staged in shared memory,
                                  stored in 16-byte vectors
                   stores_bulk    staged, stored by one cp.async.bulk
                   warps32/8      table blocks of 32 or 8 warps
                   subsets_first  the subset table's loads issued before
                                  the options' barrier
  ccg_master       committed      one warp per task, 16 a block: one batch
                                  of mask/feasibility/c1 loads, the pole
                                  set by ballot, recourse loads two poles
                                  at a time, a redux.sync vote
                   warp_per_task  the kernel's first design (8 warps a
                                  block, per option its feasibility then
                                  each pole's recourse in turn, butterfly
                                  shuffles)
                   warps8/32      blocks of 8 or 32 warps
                   two_per_warp   two tasks a warp (16 lanes, 4 options
                                  each)
                   poles1/4       recourse loads one or four poles at a
                                  time
  mamba_scan       committed      2^(dt·(A·log2 e)) by ex2.approx.ftz, A
                                  scaled once; steps unrolled by 4
                   exp2f          exp2f (subnormal results kept) instead
                   expf           IEEE expf of dt·A, as the plain version
                   unroll8        steps unrolled by 8
                   tile64         64 steps staged at once, not 32
  flash_attention  committed      tiles of 32 keys, double-buffered
                   keys64         tiles of 64 keys
                   keys16         tiles of 16 keys
                   no_min_blocks  registers not capped (committed: for 4
                                  blocks an SM, 2 at D = 256)
  decode_attention committed      the wrapper's split rule (3 / 2 / 5
                                  splits at the cloud / edge /
                                  RecurrentGemma slabs)
                   splits2/4/8    2, 4 or 8 splits at every shape
  lpt_queue        committed      the sorted walk where the inputs allow it
                                  (each tier's loads kept sorted by load and
                                  index), else the tree walk
                   tree           the tree walk always: a balanced-tree
                                  argmin over a tier's loads each task
                   linear         the tree walk with a linear chain of
                                  compare-selects for the argmin
  rglru_scan       committed      S <= 4 direct (a thread a channel, a
                                  step at a time), else staged: 32-step
                                  tiles of 32 channels by cp.async, gates
                                  off the chain
                   tile16         staged tiles of 16 steps
                   channels64     staged blocks of 64 channels, tiles of
                                  16 steps (the same shared memory)
                   ahead4         the direct kernel loading 4 steps ahead
                   prefetch8/16   the direct kernel at every S, 8 or 16
                                  steps loaded ahead in registers
  ccg_solve        committed      K <= 5: tables once per block, persistent
                                  grid of 32-warp blocks; else generic
                   warps16        table blocks of 16 warps
                   generic        the generic kernel (the kernel's first
                                  design: per-task recomputation) at
                                  every K
                   shuffles       butterfly shuffles of (value, index) for
                                  every argmin/argmax, not a vote
  gate_cell        committed      persistent grid, weights copied once a
                                  block, 16 warps × 2 streams a 32-stream
                                  tile, the dx k-loop two groups of four a
                                  step, a multiply then an add
                   fma            fmaf for every product and sum (one
                                  rounding: not bit-equal to committed)
                   no_unroll      the dx k-loop one group a step
                   warps8_streams4  8 warps × 4 streams, not unrolled (this
                                  kernel's first shape)
                   warps4_streams8  4 warps × 8 streams a tile
                   tile64         16 warps × 4 streams: 64-stream tiles
  gate_cell_bwd    committed      a 512-thread block a 32-stream tile
                                  (source temporal_gate_bwd.cu): 16 warps
                                  × 2 streams side by side, then 4 × 4
                                  tiles of the weight gradients; then the
                                  ordered sum over tiles in 256-thread
                                  blocks
                   warps32_streams1  32 warps × 1 stream a tile
                   reduce64       the sum over tiles in 64-thread blocks
  c6_repair        committed      one block of 1024 threads up to 16,384
                                  tasks, a thread block cluster of 16 such
                                  blocks above (source c6_tail.cu)
                   threads512     blocks of 512 threads (another order
                                  of the sums: held to the tolerance)
                   shared_network every sort stage through shared memory
                                  (this kernel's first sort), not the
                                  stages within 64 keys in registers
                   cluster8       clusters of 8 blocks (the portable
                                  size; 16 above 131,072 tasks), not 16:
                                  the first cluster of this design, 16,384
                                  tasks a block at 131,072 (another order
                                  of the sums)
                   per_round      no cluster: above 16,384 tasks the
                                  per-round path (a c6_tail launch a round
                                  and the selection in torch), the first
                                  design there
  flash_attention_bwd committed   bf16 at D 32-256 on the tensor cores,
                                  reading the forward's LSE (D 256: the
                                  dk/dv blocks split into dV and dK
                                  halves), tiles of 32 keys (dq) and 64
                                  queries (dk/dv); float32 and bf16 at D
                                  8, 16 on the CUDA cores
                   first_design   bf16 on the CUDA cores at every D (the
                                  kernel's first design: float32
                                  multiply-adds, the row statistics
                                  recomputed by a pass over the key tiles)
                   d256_one_pass  D = 256 in one dk/dv pass (dK and dV in
                                  one block: spills)
                   dq_tile64      tiles of 64 keys in the dq kernel
                   dkv_tile32     tiles of 32 queries in the dk/dv kernel
                                  (this design's first tiles)

``flash_attention_bwd`` runs in bf16 at Qwen1.5-0.5B's training shape
(B 8, S 512, H = KV 16, D 64, causal), Qwen3-8B's GQA (B 2, S 512, H 32 /
KV 8, D 128) and RecurrentGemma's D = 256 with a window of 128 (B 2, S
512, H 16 / KV 1), through its wrapper with the variant's library and the
LSE of the committed forward kernel's training launch: dq, dk and dv
within ``chip_smoke.BWD_TOL`` of the plain version's largest |entry|, two
launches bit-equal; timed by the profiler's device time of a call (both
kernels), CUDA events beside it; the ptxas report (registers, spills) of
each variant's backward kernels is printed once.
``gate_cell`` runs at M = 4096, d = 35 on the stream's round-0 features
and ``c6_repair`` on ``chip_smoke.py``'s ``c6_repair_cases`` at M = 4096
(the main path's inputs and the demoting case) and on both tiled to
M = 16,385, 53,248 and 131,072 (the cluster's sizes), both through their
wrappers with the variant's library in place of ``_build.library()`` and
timed by the profiler's device time (their launches are shorter than the
host's call), events beside it: ``gate_cell`` within 1e-5 of the plain
version (and whether bit-equal to the committed kernel), ``c6_repair``
within its tolerance (``compare_repairs``).  ``ccg_encode`` runs at
M = 4096 on round 0 of the seeded stream that
``chip_smoke.py`` serves, ``ccg_solve`` on the same round warm-started from
Stage 1 (the main path's inputs), ``ccg_master`` on the inputs of each of
the 8 master steps of that warm solve (``chip_smoke.py``'s
``warm_solve_master_inputs``; ``ms`` the first step's, ``ms_per_warm_solve``
the sum over the steps), ``lpt_queue`` at M = 4096 on all-edge
routes (the main path's) and on mixed ones: each must equal the plain
version exactly.  ``lpt_queue`` is timed by CUDA events around ``--reps``
back-to-back launches (median of five); ``ccg_encode``, ``ccg_master``
and ``ccg_solve``, whose launches are shorter than their host calls, by
the profiler's device time over ``--reps`` launches, the events beside
it.  ``mamba_scan``, ``rglru_scan``,
``flash_attention`` and ``decode_attention`` go through ``chip_smoke.py``'s
own checks and timings with the variant's library in place of
``_build.library()``: every case of the kernel-vs-plain comparison within
its tolerance, the device time (profiler) and the call time (CUDA events)
at the serving shapes.

``--baseline TREE`` adds a variant ``baseline``: the kernel's source as it
stands in another checkout (``TREE/src/repro_torch/kernels/csrc/``, e.g. an
earlier commit unpacked by ``git archive``), built and timed in turns
beside the others; its entry point must take the committed one's
arguments, and a case its library refuses is reported as refused.

With ``--diagnose`` it builds instead variants that drop one part of the
work, compute wrong results on purpose and are only timed, to show where a
kernel's time goes:

  ccg_encode       tables_only    the tables built, no task encoded
                   launch_only    neither tables nor tasks: the grid's
                                  launch, options copy and barrier
                   no_stores      tables and encode, no recourse stored
                   fold           (the first design, as above) and its
                   fold_no_fold   cuts: a value that needs no shared-memory
                                  reads stored,
                   fold_no_stores the fold without its stores,
                   fold_no_recourse accuracy, bitmask and argmax only
  ccg_master       no_reads       the same grid storing constants: the
                                  floor that launch and tail set
                   no_recourse    every load but the recourse's, the pole
                                  set and the vote
                   warp_per_task  (the first design, timed beside)
  mamba_scan       no_exp         dt·A in place of its exponential
                   no_shuffle     no quad sum of y
                   no_bc_loads    B_t, C_t not read from shared memory
                   no_xdt_loads   x_t, dt_t not read from shared memory
                   no_staging     nothing staged in shared memory
  flash_attention  no_mma         no tensor-core product
                   no_loads       no copy into shared memory
                   no_stores      no output store
  flash_attention_bwd no_mma      no tensor-core product
                   no_loads       no copy into shared memory
  decode_attention no_combine     each split's own partial out: no cluster
                                  sync, no distributed shared memory
                   no_cluster     the same, launched without clusters
                   no_loads       no copy of K/V into shared memory
  lpt_queue        no_prefetch    each batch of 32 tasks read from shared
                                  memory as its walk starts, not a batch
                                  ahead
                   no_walk        gather and scatter only
  rglru_scan       no_gates       a_t = la·r, b_t = i·x: no exp, no sqrt
                   no_chain       h_t = b_t: no dependent step
                   no_loads       nothing staged in shared memory
                   no_stores      no store of y
  ccg_solve        no_encode      a_max·sat a constant (no exponential,
                                  no table read) in the encode
                   one_step       one CCG step at most
                   no_table_fill  the subset-recourse table not built
                                  (its contents garbage: steps may differ)
                   tables_only    the tables built, no task solved
                   generic_no_encode, generic_one_step
                                  the same two cuts of the generic kernel
  gate_cell        no_weight_copy the weights not copied into shared
                                  memory (products of stale values)
                   no_recurrence  no h·U_gr and no (r·h)·U_h product
                   copies_only    no product at all: the launch, the copies,
                                  the gates and the stores
                   fma            (as above, timed beside the cuts)
  gate_cell_bwd    no_phase1      no stream's forward or chain rule
                                  (the tile sums of stale values)
                   no_phase2      no weight-gradient sum (the launch, the
                                  copies, the per-stream pass, the
                                  reduction)
                   no_weights     the weights not copied into shared
                                  memory
                   reduce_only    none of the three: the launch, the
                                  tile's copies and the reduction
  c6_repair        no_sort        the keys not sorted (demotes in
                                  compaction order)
                   no_early_stop  every round runs its pass, sort and scan
                                  after the repair stopped demoting

Prints one JSON line per (round, variant) and, last, the card's name and
power limit.  Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
M = 4096                          # ccg_encode's tasks, as chip_smoke.py

# ccg_encode.cu: the generic path (the first design) ...
FOLD = "if ((code >> k) & 1) v = fminf(v, s_b2s[(k * P + pole) * F + f]);"
STORE = "rec[(size_t)pole * F] = v;"
POLES = "for (int pole = 0; pole < P; ++pole)"
ENC_TABLE_K = "constexpr int kTableMaxK = 5;"
# ... and the table path
ENC_WARPS = "constexpr int kTableWarps = 16;"
ENC_SUBSETS = "ccg::fill_subsets<kK>(rec_tab, F, P, pole_cost);"
# the subset table copied from device memory, where the caller put it in
# the shared layout (CcgEncode passes it in place of the costs)
ENC_COPY = """{
    const int n = P * ps, n4 = n / 4;
    const float4* src = reinterpret_cast<const float4*>(b2s);
    float4* dst = reinterpret_cast<float4*>(rec_tab);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
      rec_tab[i] = b2s[i];
    }
  }"""
ENC_TASKS = "for (; task < e.M; task += stride)"
ENC_AMS = "ccg::fill_ams<kK>(ams, s.rn, s.tier, F);"
# the build: the options behind a barrier, then a_max·sat and the subsets
ENC_BUILD = """  ccg::fill_options(s, e.rn, e.pn, e.tier, e.y_ok, F);
  __syncthreads();
  ccg::fill_ams<kK>(ams, s.rn, s.tier, F);
  const float* b2s = e.b2s;
  auto pole_cost = [&](int k, int p, int f) {
    return b2s[(k * P + p) * F + f];
  };
  ccg::fill_subsets<kK>(rec_tab, F, P, pole_cost);
  __syncthreads();
"""
# the subsets' loads issued before the options' barrier
ENC_SUBSETS_FIRST = """  const float* b2s = e.b2s;
  auto pole_cost = [&](int k, int p, int f) {
    return b2s[(k * P + p) * F + f];
  };
  ccg::fill_subsets<kK>(rec_tab, F, P, pole_cost);
  ccg::fill_options(s, e.rn, e.pn, e.tier, e.y_ok, F);
  __syncthreads();
  ccg::fill_ams<kK>(ams, s.rn, s.tier, F);
  __syncthreads();
"""
ENC_ROWS = ("for (int p = 0; p < P; ++p) {\n"
            "      if (o0.has) out[p * F + f0] = t0[p * ps];")
# the committed store (a pole's row across the lanes, straight from the
# table) ...
ENC_ROW_STORE = """#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      if (o0.has) out[p * F + f0] = t0[p * ps];
      if (o1.has) out[p * F + f1] = t1[p * ps];
    }
  }
}
"""
# ... and the staged stores that rival it: the task's P·F block staged in
# a warp's area of shared memory at the offset of its start from a 16-byte
# boundary, then copied by the lanes in 16-byte vectors or by one bulk
# copy (cp.async.bulk shared -> global), a scalar head and tail beside
ENC_STAGE_HELPERS = """// A warp's staging area of a task's recourse, in floats: P·F values that
// may start at any of four offsets from a 16-byte boundary.
__host__ __device__ inline int stage_floats(int P, int F) {
  return (P * F + 3 + 3) / 4 * 4;
}
// where the staging areas start in the dynamic shared memory (16-byte
// aligned)
__host__ __device__ inline size_t stage_start(int F, int K, int P) {
  return (ccg::table_floats(F, K, P) + 3) / 4 * 4;
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
      "cp.async.bulk.commit_group;\\n" ::"l"(dst), "r"(s), "r"(bytes)
      : "memory");
}

"""
ENC_KERNEL_START = "// the dynamic shared memory of the table kernel: its tables"
ENC_SMEM = "  return ccg::table_bytes(F, K, P);\n"
ENC_STAGE_SMEM = ("  return sizeof(float) * (stage_start(F, K, P) +\n"
                  "                          (size_t)kTableWarps * "
                  "stage_floats(P, F));\n")
ENC_WARP = "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
ENC_STAGE_AREA = ("  float* stage = dyn + stage_start(F, kK, P) + "
                  "warp * stage_floats(P, F);\n")


def staged_store(bulk: bool) -> str:
    """The staged store in place of ENC_ROW_STORE: by 16-byte vectors, or
    (bulk) by one bulk copy a task."""
    wait = ("""    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncwarp();   // the last bulk copy has read the stage
""" if bulk else "")
    fence = ("""    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
""" if bulk else "")
    copy = ("""    if (lane == 0 && n4 > 0) bulk_store(out + head, st + head, 16 * n4);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
""" if bulk else """    const float4* src = reinterpret_cast<const float4*>(st + head);
    float4* dst = reinterpret_cast<float4*>(out + head);
    for (int v = lane; v < n4; v += 32) dst[v] = src[v];
    __syncwarp();   // before the next task overwrites the stage
  }
}
""")
    return f"""    const int n = P * F;
    const int off = (int)(((size_t)out >> 2) & 3);
    const int head = min(n, (4 - off) & 3);
    const int n4 = (n - head) >> 2;
    const int tail = head + 4 * n4;
    float* st = stage + off;
{wait}#pragma unroll 4
    for (int p = 0; p < P; ++p) {{
      if (o0.has) st[p * F + f0] = t0[p * ps];
      if (o1.has) st[p * F + f1] = t1[p * ps];
    }}
{fence}    __syncwarp();
    if (lane < head) out[lane] = st[lane];
    if (lane < n - tail) out[tail + lane] = st[tail + lane];
{copy}"""


def staged(src: str, bulk: bool) -> str:
    """ccg_encode.cu with the staged store of ``staged_store``."""
    return edit(src, (ENC_KERNEL_START, ENC_STAGE_HELPERS + ENC_KERNEL_START),
                (ENC_SMEM, ENC_STAGE_SMEM),
                (ENC_WARP, ENC_WARP + ENC_STAGE_AREA),
                (ENC_ROW_STORE, staged_store(bulk)))
# ccg_master.cu
MASTER_WARPS = "constexpr int kWarps = 16;        // warps per block"
MASTER_LANES = "constexpr int kLanes = 32;"
MASTER_BATCH = "constexpr int kPoleBatch = 2;"
MASTER_LIVE = "  const bool live = task < M;\n"
MASTER_POLES = "for (Set b = poles; b;)"
MASTER_KERNEL = ("template <bool kWide>\n__global__ void __launch_bounds__("
                 "32 * kWarps) ccg_master_kernel(", "}  // namespace")
# the kernel's first design: one warp per task, the mask, then per option
# its feasibility, then c1 and the generated poles' recourse one pole at a
# time, then five butterfly rounds on (value, index)
MASTER_FIRST = """template <bool kWide>
__global__ void ccg_master_kernel(
    const float* __restrict__ rec, const float* __restrict__ scen_mask,
    const unsigned char* __restrict__ fs_ok, const float* __restrict__ c1,
    int* __restrict__ y_out, float* __restrict__ od_out, int M, int P,
    int F) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= M) return;   // warp-uniform

  const float* mask = scen_mask + (size_t)task * P;
  const unsigned lo = __ballot_sync(kFullMask, lane < P && mask[lane] > 0.0f);
  const unsigned hi =
      __ballot_sync(kFullMask, lane + 32 < P && mask[lane + 32] > 0.0f);
  const unsigned long long poles = ((unsigned long long)hi << 32) | lo;

  const float* rec_t = rec + (size_t)task * P * F;
  const unsigned char* ok_t = fs_ok + (size_t)task * F;
  float best = CUDART_INF_F;
  int arg = INT_MAX;
  for (int f = lane; f < F; f += 32) {
    float obj = kBig;
    if (ok_t[f]) {
      float eta = 0.0f;
      if (poles) {
        eta = -kBig;
        for (unsigned long long b = poles; b; b &= b - 1) {
          const int pole = __ffsll((long long)b) - 1;
          eta = fmaxf(eta, rec_t[(size_t)pole * F + f]);
        }
      }
      obj = c1[f] + eta;
    }
    if (obj < best) { best = obj; arg = f; }
  }
  warp_argmin(best, arg);
  if (lane == 0) {
    y_out[task] = arg;
    od_out[task] = best;
  }
}

"""
# mamba_scan.cu
EX2 = "const float da = ex2_approx(dv * a[i]);"
SCALE = ("#pragma unroll\n  for (int i = 0; i < kPerLane; ++i) "
         "a[i] *= 1.4426950408889634f;   // log2(e)\n")
UNROLL = "#pragma unroll 4\n    for (int tt = 0; tt < nt; ++tt) {"
TILE = "constexpr int kTileT = 32;"
BC_LOADS = ("const float4 b4 = *reinterpret_cast<const float4*>(&b_s[tt][n0]);"
            "\n        const float4 c4 = *reinterpret_cast<const float4*>"
            "(&c_s[tt][n0]);\n")
XDT_LOADS = ("const float xv = x_s[tt][ch];\n"
             "      const float dv = dt_s[tt][ch];\n")
SHUFFLES = ("      acc += __shfl_xor_sync(0xffffffffu, acc, 1);\n"
            "      acc += __shfl_xor_sync(0xffffffffu, acc, 2);\n")
# flash_attention.cu
KEYS = "constexpr int kKeys = 32;"
FLASH_BOUNDS = ("__global__ void __launch_bounds__(kThreads, D <= 128 ? 4 : 2)"
                "\n    flash_attention_kernel_bf16(")
MMA = '''  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
CP_ASYNC = ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
            '::"r"(dst),')
STORE_SKIP = "    if (off < 0) continue;\n    *reinterpret_cast<uint4*>(out"
# the tensor-core helpers of both attention sources (MMA and CP_ASYNC live
# there: a variant that edits them gets the header inlined)
MMA_HEADER = '#include "mma_bf16.cuh"\n'
NO_MMA = ("  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & "
          "0x3f800000u) * 1e-30f;")
NO_LOADS = ('if (dst == 1u) asm volatile("cp.async.cg.shared.global [%0], '
            '[%1], 16, %2;\\n" ::"r"(dst),')
# flash_attention_bwd.cu
BWD_DESIGN = ("constexpr bool kTensorCores = std::is_same<T, bf16>::value "
              "&& D >= 32;")
BWD_SPLIT = "constexpr bool kSplitDkv = D > 128;"
BWD_KEY_TILE = "constexpr int kKeyTile = 32;"
BWD_QUERY_TILE = "constexpr int kQueryTile = 64;"
# decode_attention.cu
LAUNCH_STREAM = "cudaStream_t st = (cudaStream_t)stream;"
PEER_M = "      if (r < splits) {\n        m_i[r] = *peer(m_s + g, r);"
PEER_ACC = ("      if (r < splits) {\n"
            "        const float w = exp2f(m_i[r] - m);")
PEER = ("auto peer = [&](float* p, int r) { return cluster.map_shared_rank(p, "
        "r); };")
SYNC_READY = "cluster.sync();                            // every split's"
SYNC_DONE = "cluster.sync();                            // peers done"
CLUSTER_ATTR = "cfg.numAttrs = 1;"
CP16 = 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),'
# rglru_scan.cu
RG_TILE = "constexpr int kT = 32;"
RG_CHANNELS = "constexpr int kC = 32;"
RG_DIRECT = "constexpr int kDirectMaxS = 4;"
RG_STEPS = """  long long o = (long long)row * S * W + w;
  for (int t = 0; t < S; ++t, o += W) {
    const float a = expf(l * r[o]);
    h = a * h + gate_b(a, ig[o], to_f(x[o]));
    y[o] = h;
  }"""


def rg_prefetch(n: int) -> str:
    """The direct kernel's loop loading ``n`` steps' gates into registers
    before it computes them."""
    return f"""  const long long o0 = (long long)row * S * W + w;
  for (int t0 = 0; t0 < S; t0 += {n}) {{
    float rv[{n}], iv[{n}], xv[{n}];
#pragma unroll
    for (int u = 0; u < {n}; ++u) {{
      if (t0 + u < S) {{
        const long long o = o0 + (long long)(t0 + u) * W;
        rv[u] = r[o];
        iv[u] = ig[o];
        xv[u] = to_f(x[o]);
      }}
    }}
#pragma unroll
    for (int u = 0; u < {n}; ++u) {{
      if (t0 + u < S) {{
        const float a = expf(l * rv[u]);
        h = a * h + gate_b(a, iv[u], xv[u]);
        y[o0 + (long long)(t0 + u) * W] = h;
      }}
    }}
  }}"""
RG_GATES = ("const float a = expf(la_s[c] * tile.r[t][c]);\n"
            "        tile.i[t][c] = gate_b(a, tile.i[t][c], "
            "to_f(tile.x[t][c]));\n")
RG_CHAIN = "h = tile.r[t][tid] * h + tile.i[t][tid];"
RG_LOADS = ("for (int q = threadIdx.x; q < nt * kF; q += kThreads)",
            "for (int q = threadIdx.x; q < nt * kX; q += kThreads)")
RG_STORES = "for (int q = tid; q < nt * kF; q += kThreads)"
# ccg_solve.cu
CCG_WARPS = "constexpr int kTableWarps = 32;"
CCG_TABLE_K = "constexpr int kTableMaxK = 5;"
CCG_VOTE_LANES = """  const unsigned key = order_key(v);
  const unsigned top = __reduce_max_sync(kFullMask, key);
  const int i = __ffs(__ballot_sync(kFullMask, key == top)) - 1;
  v = __shfl_sync(kFullMask, v, i);
  return i;"""
CCG_VOTE_PAIR = """  const unsigned k0 = order_key(v0), k1 = order_key(v1);
  const unsigned m = kMax ? __reduce_max_sync(kFullMask, k0 > k1 ? k0 : k1)
                          : __reduce_min_sync(kFullMask, k0 < k1 ? k0 : k1);
  const unsigned b0 = __ballot_sync(kFullMask, k0 == m);
  const int i =
      b0 ? __ffs(b0) - 1 : 31 + __ffs(__ballot_sync(kFullMask, k1 == m));
  best = __shfl_sync(kFullMask, i < 32 ? v0 : v1, i & 31);
  return i;"""
# five butterfly rounds on (value, index) (warp_reduce.cuh), lower index
# winning ties
SHUFFLE_LANES = """  int i = threadIdx.x & 31;
  warp_argmax(v, i);
  return i;"""
SHUFFLE_PAIR = """  int i = threadIdx.x & 31;
  best = v0;
  if (kMax ? v1 > best : v1 < best) { best = v1; i += 32; }
  if (kMax) warp_argmax(best, i); else warp_argmin(best, i);
  return i;"""
CCG_BASE = ("float f = accuracy_clamp(tab.base(f0, k), zp, zr);",
            "float f = accuracy_clamp(tab.base(f1, k), zp, zr);")
CCG_STEPS = "for (int step = 0; step < pr.n_steps; ++step)"
CCG_FILL = "ccg::fill_subsets<kK>(rec_tab, F, P, pole_cost);"
CCG_TASKS = "for (; task < pr.M; task += stride)"
# temporal_gate.cu
GATE_MADD = "  return acc + x * w;"
GATE_SHAPE = ("constexpr int kWarps = 16;", "constexpr int kS = 2;")
GATE_WEIGHTS = """  copy_floats(smem + L.wx, a.w_x, d * 3 * kM);
  copy_floats(smem + L.ugr, a.u_gr, kM * 2 * kM);
  copy_floats(smem + L.uh, a.u_h, kM * kM);
"""
GATE_UNROLL = "#pragma unroll 2\n"
GATE_X = ("    for (int k = 0; k < d4; k += 4) {\n",
          "    for (int k = d4; k < d; ++k) {\n")
GATE_RECURRENCE = (
    "for (int k = 0; k < kM; k += 4) {\n      float wg[4], wr[4];",
    "for (int k = 0; k < kM; k += 4) {\n      float w[4];")
# c6_tail.cu (c6_repair)
REPAIR_THREADS = "constexpr int kRepairThreads = 1024;"
# the first design's network: every stage through shared memory, a warp
# barrier between stages whose pairs stay within one warp's 64 keys
REPAIR_NETWORK = (
    ("  sort_windows(keys, n, 2, 64);\n"
     "  for (int size = 128; size <= n; size <<= 1) {\n"
     "    for (int stride = size >> 1; stride >= 64; stride >>= 1) {",
     "  for (int size = 2; size <= n; size <<= 1) {\n"
     "    for (int stride = size >> 1; stride > 0; stride >>= 1) {"),
    ("      __syncthreads();\n    }\n    sort_windows(keys, n, size, size);"
     "\n  }\n}",
     "      const int next = stride > 1 ? stride >> 1 : size;\n"
     "      if (stride <= 32 && next <= 32) {\n        __syncwarp();\n"
     "      } else {\n        __syncthreads();\n      }\n    }\n  }\n"
     "  __syncthreads();\n}"))
REPAIR_SORT = "    bitonic_sort(keys, n);\n"
REPAIR_STOP = "if (!(excess > 0.0f) || count == 0) {"
CLUSTER_BLOCKS = "constexpr int kClusterBlocks = 16;"
CLUSTER_LIMIT = "M > kClusterTasks * kMaxClusterBlocks"
# lpt_queue.cu
TREE = """  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) {
      const bool right = val[i + w] < val[i];
      val[i] = right ? val[i + w] : val[i];
      idx[i] = right ? idx[i + w] : idx[i];
    }
  }"""
LINEAR = """  for (int i = 1; i < N; ++i) {
    const bool right = val[i] < val[0];
    val[0] = right ? val[i] : val[0];
    idx[0] = right ? idx[i] : idx[0];
  }"""
AHEAD = ("      t[4 * u] = next[u].x;\n      t[4 * u + 1] = next[u].y;\n"
         "      t[4 * u + 2] = next[u].z;\n      t[4 * u + 3] = next[u].w;\n")
SORTED_WALK = "const bool sorted = !odd & cloud_alive;"
WALKERS = ("(tid == 0) & (n_edge_tasks > 0)", "(tid == 32) & (n_cloud_tasks > 0)",
           "} else if (!sorted & (tid == 0)) {")


# temporal_gate_bwd.cu
BWD_STREAMS = "  if (sf < rows) {                               // warp-uniform"
BWD_ITEMS = "  for (int it = tid; it < n_items; it += nt) {"
BWD_WEIGHTS = ("  for (int i = tid; i < d * kM; i += nt) {",
               "  for (int i = tid; i < kM * kM; i += nt) {")
BWD_REDUCE = "constexpr int kReduceThreads = 256;"
BWD_SHAPE = ("constexpr int kWarps = 16;", "constexpr int kS = 2;")


# the source file of a kernel whose file is named otherwise
SOURCE_OF = {"gate_cell": "temporal_gate", "c6_repair": "c6_tail",
             "gate_cell_bwd": "temporal_gate_bwd"}


def source_file(kernel: str) -> str:
    return f"{SOURCE_OF.get(kernel, kernel)}.cu"


def with_header(src: str) -> str:
    """``src`` with ``mma_bf16.cuh`` inlined, so that an edit of its
    helpers reaches this source alone."""
    header = (CSRC / "mma_bf16.cuh").read_text().replace("#pragma once\n",
                                                          "")
    return edit(src, (MMA_HEADER, header))


def gate_shape(warps: int, streams: int):
    return tuple((old, old.replace(old.split("= ")[1][:-1], str(n)))
                 for old, n in zip(GATE_SHAPE, (warps, streams)))


def edit(src: str, *pairs) -> str:
    """``src`` with each (old, new) pair replaced; each old text must occur
    exactly once."""
    for old, new in pairs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def replace_span(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` up to (not including) ``end``
    replaced by ``new``; each marker must occur exactly once."""
    assert src.count(start) == 1 and src.count(end) == 1, (start, end)
    i, j = src.index(start), src.index(end)
    assert i < j, (start, end)
    return src[:i] + new + src[j:]


def with_constant(src: str, line: str, value: int) -> str:
    """``src`` with the constant declared on ``line`` (``... = n;``) set to
    ``value``."""
    name_eq, _ = line.rsplit("= ", 1)
    return edit(src, (line, f"{name_eq}= {value};"))


def variants(kernel: str, src: str) -> dict:
    """The committed source and the variants that keep its results."""
    if kernel == "ccg_encode":
        return {"committed": src,
                "fold": with_constant(src, ENC_TABLE_K, 0),
                "copy_table": edit(src, (ENC_SUBSETS, ENC_COPY)),
                "stores_vector": staged(src, bulk=False),
                "stores_bulk": staged(src, bulk=True),
                "warps32": with_constant(src, ENC_WARPS, 32),
                "warps8": with_constant(src, ENC_WARPS, 8),
                "subsets_first": edit(src, (ENC_BUILD, ENC_SUBSETS_FIRST))}
    if kernel == "ccg_master":
        return {"committed": src,
                "warp_per_task": with_constant(
                    replace_span(src, *MASTER_KERNEL, MASTER_FIRST),
                    MASTER_WARPS, 8),
                "warps8": with_constant(src, MASTER_WARPS, 8),
                "warps32": with_constant(src, MASTER_WARPS, 32),
                "two_per_warp": with_constant(src, MASTER_LANES, 16),
                "poles1": with_constant(src, MASTER_BATCH, 1),
                "poles4": with_constant(src, MASTER_BATCH, 4)}
    if kernel == "mamba_scan":
        return {
            "committed": src,
            "exp2f": edit(src, (EX2, "const float da = exp2f(dv * a[i]);")),
            "expf": edit(src, (EX2, "const float da = expf(dv * a[i]);"),
                         (SCALE, "")),
            "unroll8": edit(src, (UNROLL, UNROLL.replace("4", "8", 1))),
            "tile64": edit(src, (TILE, TILE.replace("32", "64"))),
        }
    if kernel == "decode_attention":
        return {"committed": src, **{
            f"splits{n}": edit(src, (LAUNCH_STREAM, f"splits = min({n}, S);"
                                     f"\n  {LAUNCH_STREAM}"))
            for n in (2, 4, 8)}}
    if kernel == "lpt_queue":
        tree = edit(src, (SORTED_WALK, "const bool sorted = false;"))
        return {"committed": src, "tree": tree,
                "linear": edit(tree, (TREE, LINEAR))}
    if kernel == "rglru_scan":
        return {
            "committed": src,
            "tile16": edit(src, (RG_TILE, RG_TILE.replace("32", "16"))),
            # 64 channels with 16-step tiles: the same shared memory
            "channels64": edit(src, (RG_CHANNELS,
                                     RG_CHANNELS.replace("32", "64")),
                               (RG_TILE, RG_TILE.replace("32", "16"))),
            "ahead4": edit(src, (RG_STEPS, rg_prefetch(4))),
            **{f"prefetch{n}": edit(
                src, (RG_DIRECT, RG_DIRECT.replace("4", "1 << 30")),
                (RG_STEPS, rg_prefetch(n))) for n in (8, 16)},
        }
    if kernel == "gate_cell":
        no_unroll = (GATE_UNROLL + GATE_X[0], GATE_X[0])
        return {"committed": src,
                "fma": edit(src, (GATE_MADD, "  return fmaf(x, w, acc);")),
                "no_unroll": edit(src, no_unroll),
                "warps8_streams4": edit(src, *gate_shape(8, 4), no_unroll),
                "warps4_streams8": edit(src, *gate_shape(4, 8)),
                "tile64": edit(src, *gate_shape(16, 4))}
    if kernel == "gate_cell_bwd":
        return {"committed": src,
                "warps32_streams1": edit(src, (BWD_SHAPE[0], BWD_SHAPE[0]
                                               .replace("16", "32")),
                                         (BWD_SHAPE[1], BWD_SHAPE[1]
                                          .replace("2", "1"))),
                "reduce64": edit(src, (BWD_REDUCE,
                                       BWD_REDUCE.replace("256", "64")))}
    if kernel == "c6_repair":
        return {"committed": src,
                "threads512": edit(src, (REPAIR_THREADS,
                                         REPAIR_THREADS.replace("1024",
                                                                "512"))),
                "shared_network": edit(src, *REPAIR_NETWORK),
                "cluster8": with_constant(src, CLUSTER_BLOCKS, 8),
                "per_round": edit(src, (CLUSTER_LIMIT, "M > kRepairCap"))}
    if kernel == "flash_attention_bwd":
        return {"committed": src,
                "first_design": edit(src, (BWD_DESIGN, "constexpr bool "
                                           "kTensorCores = false;")),
                "d256_one_pass": edit(src, (BWD_SPLIT, BWD_SPLIT.replace(
                    "D > 128", "false"))),
                "dq_tile64": with_constant(src, BWD_KEY_TILE, 64),
                "dkv_tile32": with_constant(src, BWD_QUERY_TILE, 32)}
    if kernel == "ccg_solve":
        return {"committed": src,
                "warps16": edit(src, (CCG_WARPS, CCG_WARPS.replace("32",
                                                                   "16"))),
                "generic": edit(src, (CCG_TABLE_K,
                                      CCG_TABLE_K.replace("5", "0"))),
                "shuffles": edit(src, (CCG_VOTE_LANES, SHUFFLE_LANES),
                                 (CCG_VOTE_PAIR, SHUFFLE_PAIR))}
    return {
        "committed": src,
        "keys64": edit(src, (KEYS, KEYS.replace("32", "64"))),
        "keys16": edit(src, (KEYS, KEYS.replace("32", "16"))),
        "no_min_blocks": edit(src, (FLASH_BOUNDS, FLASH_BOUNDS.replace(
            "(kThreads, D <= 128 ? 4 : 2)", "(kThreads)"))),
    }


def diagnostics(kernel: str, src: str) -> dict:
    """The committed source and variants that drop one part of the work
    (wrong results: timed only)."""
    if kernel == "ccg_encode":
        fold = with_constant(src, ENC_TABLE_K, 0)
        return {
            "committed": src,
            "tables_only": edit(src, (ENC_TASKS, ENC_TASKS.replace(
                "task < e.M", "task < 0 * e.M"))),
            "launch_only": edit(src, (ENC_TASKS, ENC_TASKS.replace(
                "task < e.M", "task < 0 * e.M")), (ENC_SUBSETS, ""),
                                (ENC_AMS, "")),
            "no_stores": edit(src, (ENC_ROWS, ENC_ROWS.replace(
                "p < P", "p < 0 * P"))),
            "fold": fold,
            "fold_no_fold": edit(fold, (FOLD, "v = fminf(v, (float)(code "
                                        ">> k));")),
            "fold_no_stores": edit(fold, (STORE, "if (v == 12345.0f) "
                                          "rec[(size_t)pole * F] = v;")),
            "fold_no_recourse": edit(fold, (POLES, POLES.replace("< P",
                                                                 "< 0"))),
        }
    if kernel == "ccg_master":
        return {
            "committed": src,
            "no_reads": edit(src, (MASTER_LIVE, MASTER_LIVE + (
                "  if (live && gl == 0) {\n    y_out[task] = 0;\n"
                "    od_out[task] = 0.0f;\n  }\n  return;\n"))),
            "no_recourse": edit(src, (MASTER_POLES, MASTER_POLES.replace(
                "b = poles", "b = 0"))),
            "warp_per_task": with_constant(
                replace_span(src, *MASTER_KERNEL, MASTER_FIRST),
                MASTER_WARPS, 8),
        }
    if kernel == "mamba_scan":
        return {
            "committed": src,
            "no_exp": edit(src, (EX2, "const float da = dv * a[i];")),
            "no_shuffle": edit(src, (SHUFFLES, "")),
            "no_bc_loads": edit(src, (BC_LOADS, "const float4 b4 = make_float4("
                                      "xv, dv, xv, dv), c4 = make_float4("
                                      "dv, xv, dv, xv);\n")),
            "no_xdt_loads": edit(src, (XDT_LOADS, "const float xv = 0.5f + "
                                       "1e-3f * (tt + ch);\n      const "
                                       "float dv = 0.25f + 1e-3f * tt;\n")),
            "no_staging": edit(
                src, ("i < nt * N; i += kThreads", "i < 0; i += kThreads"),
                ("i < nt * kChannels; i += kThreads",
                 "i < 0; i += kThreads")),
        }
    if kernel == "decode_attention":
        no_combine = ((PEER_M, PEER_M.replace("r < splits", "r < 1")),
                      (PEER_ACC, PEER_ACC.replace("r < splits", "r < 1")),
                      (PEER, "auto peer = [&](float* p, int r) { return p; };"),
                      (SYNC_READY, "__syncthreads();  // "),
                      (SYNC_DONE, "// "))
        return {
            "committed": src,
            "no_combine": edit(src, *no_combine),
            "no_cluster": edit(src, *no_combine,
                               (CLUSTER_ATTR, "cfg.numAttrs = 0;")),
            "no_loads": edit(src, (CP16, "if (d == 1u) " + CP16)),
        }
    if kernel == "rglru_scan":
        return {
            "committed": src,
            "no_gates": edit(src, (RG_GATES, (
                "const float a = la_s[c] * tile.r[t][c];\n"
                "        tile.i[t][c] = tile.i[t][c] * to_f(tile.x[t][c]);"
                "\n"))),
            "no_chain": edit(src, (RG_CHAIN, "h = tile.i[t][tid];")),
            "no_loads": edit(src, *((loop, loop.replace("q < nt", "q < 0 * nt"))
                                    for loop in RG_LOADS)),
            "no_stores": edit(src, (RG_STORES,
                                    RG_STORES.replace("q < nt", "q < 0 * nt"))),
        }
    if kernel == "ccg_solve":
        no_encode = tuple((b, b.replace(b[b.index("tab."):b.index(", zp")],
                                        "0.7f + 0.03f * k"))
                          for b in CCG_BASE)
        one_step = ((CCG_STEPS, CCG_STEPS.replace("pr.n_steps", "1")),)
        generic = (CCG_TABLE_K, CCG_TABLE_K.replace("5", "0"))
        return {"committed": src,
                "no_encode": edit(src, *no_encode),
                "one_step": edit(src, *one_step),
                "no_table_fill": edit(src, (CCG_FILL, "(void)pole_cost;")),
                "tables_only": edit(src, (CCG_TASKS, CCG_TASKS.replace(
                    "task < pr.M", "task < 0 * pr.M"))),
                "generic_no_encode": edit(src, generic, *no_encode),
                "generic_one_step": edit(src, generic, *one_step)}
    if kernel == "gate_cell":
        return {"committed": src,
                "no_weight_copy": edit(src, (GATE_WEIGHTS, "")),
                "no_recurrence": edit(src, *((loop, loop.replace(
                    "k < kM", "k < 0")) for loop in GATE_RECURRENCE)),
                "copies_only": edit(
                    src, *((loop, loop.replace("k < kM", "k < 0"))
                           for loop in GATE_RECURRENCE),
                    *((loop, loop.replace("k < d", "k < 0 * d"))
                      for loop in GATE_X)),
                "fma": edit(src, (GATE_MADD, "  return fmaf(x, w, acc);"))}
    if kernel == "gate_cell_bwd":
        no_phase1 = (BWD_STREAMS, BWD_STREAMS.replace("sf < rows",
                                                      "sf < 0 * rows"))
        no_phase2 = (BWD_ITEMS, BWD_ITEMS.replace("it < n_items",
                                                  "it < 0 * n_items"))
        no_weights = tuple((loop, loop.replace("i < ", "i < 0 * "))
                           for loop in BWD_WEIGHTS)
        return {"committed": src,
                "no_phase1": edit(src, no_phase1),
                "no_phase2": edit(src, no_phase2),
                "no_weights": edit(src, *no_weights),
                "reduce_only": edit(src, no_phase1, no_phase2, *no_weights)}
    if kernel == "c6_repair":
        return {"committed": src,
                "no_sort": edit(src, (REPAIR_SORT, "")),
                "no_early_stop": edit(src, (REPAIR_STOP, "if (round < 0) {"))}
    if kernel == "lpt_queue":
        return {"committed": src,
                "no_prefetch": edit(src, (AHEAD, "".join(
                    f"      t[4 * u + {k}] = times[i0 + 4 * u + {k}];\n"
                    for k in range(4)))),
                "no_walk": edit(src, *((w, "(tid < 0)") for w in WALKERS[:2]),
                                (WALKERS[2], "} else if (tid < 0) {"))}
    cuts = {"committed": src,
            "no_mma": edit(with_header(src), (MMA, NO_MMA)),
            "no_loads": edit(with_header(src), (CP_ASYNC, NO_LOADS))}
    if kernel == "flash_attention_bwd":
        return cuts
    return {
        **cuts,
        "no_stores": edit(src, (STORE_SKIP, STORE_SKIP.replace(
            "off < 0", "off < 0 || l[0] != -1.0f"))),
    }


class Library:
    """The kernel library with one entry point taken from a variant (named
    ``variant``)."""

    def __init__(self, base, name: str, fn, variant: str):
        self._base, self._name, self._fn = base, name, fn
        self.variant = variant

    def __getattr__(self, attr):
        return self._fn if attr == self._name else getattr(self._base, attr)


def build(kernels, diagnose: bool, baseline=None) -> dict:
    """Every variant of ``kernels`` built and loaded: {kernel: {variant:
    Library}}; with ``baseline`` (a checkout's root) also that checkout's
    source of each kernel, as the variant ``baseline``."""
    from repro_torch.kernels import _build

    base = _build.library()
    csrc = _build.CSRC
    out = ROOT / "build" / "kernel_variants"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc)]
    make = diagnostics if diagnose else variants
    procs = {}
    for kernel in kernels:
        sources = make(kernel, (csrc / source_file(kernel)).read_text())
        if baseline is not None:
            sources["baseline"] = (Path(baseline) / "src" / "repro_torch" /
                                   "kernels" / "csrc" /
                                   source_file(kernel)).read_text()
        for name, src in sources.items():
            cu = out / f"{kernel}_{name}.cu"
            cu.write_text(src)
            so = out / f"{kernel}_{name}.so"
            procs[kernel, name] = (so, subprocess.Popen(
                [*cmd, "-shared", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        entry = f"{kernel}_launch"
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs.setdefault(kernel, {})[name] = Library(base, entry, fn, name)
    return libs


def ptxas_report(log: str, symbol: str) -> dict:
    """Registers and stack/spill bytes of each kernel whose (mangled) name
    holds ``symbol``, from the ``-Xptxas -v`` lines of an nvcc log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "spill stores" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", line))
            out[name] = {"stack": stack, "spill_stores": stores,
                         "spill_loads": loads}
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
            name = None
    return {k: v for k, v in out.items() if symbol in k}


def _event_ms(torch, launch, reps: int) -> float:
    """Median over five CUDA-event timings of ``reps`` back-to-back
    launches, per launch."""
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def shared_layout(torch, rec_table):
    """The (P, F, 2^K) subset table as the table kernels hold it in shared
    memory (ccg_tables.cuh): rec[p][code][f] at row strides fs (options
    padded to a multiple of 32) and ps = 2^K·fs + 1 (each pole's slab
    padded by one float), zeros in the padding; (P, ps)."""
    n_p, n_f, n_c = rec_table.shape
    fs = (n_f + 31) // 32 * 32
    table = torch.zeros((n_p, n_c * fs + 1), dtype=rec_table.dtype,
                        device=rec_table.device)
    table[:, :n_c * fs].view(n_p, n_c, fs)[:, :, :n_f] = \
        rec_table.permute(0, 2, 1)
    return table


class CcgEncode:
    """``ccg_encode`` at M = 4096, launched through its entry point with
    sentinel outputs, so that a variant that skips a store cannot pass on
    memory an earlier variant left behind; timed by the profiler's device
    time (a launch is shorter than its host call), events beside it.  The
    ``copy_table`` variant is given the subset table in the table kernel's
    shared layout in place of the costs."""

    def __init__(self, torch, reps: int, device_ms):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.core.robust import RobustProblem
        from repro_torch.kernels import _build
        from repro_torch.kernels.ccg_encode.ops import ccg_encode
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps, self.device_ms = torch, reps, device_ms
        dev = self.dev = torch.device("cuda")
        sys_ = SystemConfig()
        prob = RobustProblem.build(sys_, dev)
        lat = prob.lat
        stream = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1)
        z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
        self.table = shared_layout(torch, prob.rec_table)
        self.want = ccg_encode(z, aq, lat.rn_flat, lat.pn_flat,
                               lat.tier_flat, prob.b2_scaled, prob.rec_table,
                               margin=sys_.acc_margin_robust,
                               num_versions=sys_.num_versions, force="ref")
        self.f, self.p = lat.n_flat, prob.poles.shape[0]
        b2s = prob.b2_scaled.permute(2, 0, 1).contiguous()       # (K, P, F)
        self.ins = [z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                    _build.all_ones(self.f, dev), b2s]
        self.sizes = [M, self.f, sys_.num_versions, self.p,
                      sys_.acc_margin_robust]

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, dev, f, p = self.torch, self.dev, self.f, self.p
        outs = [torch.full((M, f), -7, dtype=torch.int32, device=dev),
                torch.full((M, p, f), float("nan"), device=dev),
                torch.full((M,), -7, dtype=torch.int32, device=dev)]
        ins = self.ins[:-1] + [self.table if lib.variant == "copy_table"
                               else self.ins[-1]]
        call = [t.data_ptr() for t in ins + outs] + self.sizes + [
            _build.stream_ptr(dev)]
        fn = lib.ccg_encode_launch
        _build.check(fn(*call), "ccg_encode")
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(outs, self.want))
        if exact_required and not exact:
            return {"outside_tolerance": "differs from the plain version"}
        return {"ms": self.device_ms(torch, lambda: fn(*call),
                                     "ccg_encode_kernel", self.reps),
                "events_ms": _event_ms(torch, lambda: fn(*call), self.reps),
                "exact_vs_plain": exact}


class CcgMaster:
    """``ccg_master`` on the inputs of every master step of one warm solve
    (M = 4096, round 0 of the seeded stream warm-started from Stage 1, as
    ``chip_smoke.py``'s kernel phase), launched through its entry point
    with sentinel outputs; each step checked exactly and timed by the
    profiler's device time: the first step and the sum over the steps,
    events beside the first."""

    def __init__(self, torch, reps: int, chip_smoke):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.core.robust import RobustProblem
        from repro_torch.core.router import stage1_configure
        from repro_torch.kernels.ccg_master.ops import ccg_master
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps = torch, reps
        self.device_ms = chip_smoke.device_ms
        dev = self.dev = torch.device("cuda")
        sys_ = SystemConfig()
        prob = RobustProblem.build(sys_, dev)
        lat = prob.lat
        stream = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1)
        z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
        none = torch.full((M,), -1, dtype=torch.int64, device=dev)
        route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
        wy = lat.flatten_index(route, r, sys_.n_fps - 1)
        self.steps = chip_smoke.warm_solve_master_inputs(prob, z, aq, wy)
        self.want = [ccg_master(*a, force="ref") for a in self.steps]

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, dev = self.torch, self.dev
        fn = lib.ccg_master_launch
        calls, exact = [], True
        for (rec_all, scen, fs_ok, c1), want in zip(self.steps, self.want):
            m, p, f = rec_all.shape
            outs = [torch.full((m,), -7, dtype=torch.int32, device=dev),
                    torch.full((m,), float("nan"), device=dev)]
            call = [t.data_ptr() for t in (rec_all, scen, fs_ok, c1, *outs)]
            call += [m, p, f, _build.stream_ptr(dev)]
            _build.check(fn(*call), "ccg_master")
            torch.cuda.synchronize()
            exact &= all(torch.equal(g, w) for g, w in zip(outs, want))
            calls.append(call)
        if exact_required and not exact:
            return {"outside_tolerance": "differs from the plain version"}
        by_step = [self.device_ms(torch, lambda c=c: fn(*c),
                                  "ccg_master_kernel", self.reps)
                   for c in calls]
        return {"ms": by_step[0],
                "ms_per_warm_solve": (sum(by_step) if None not in by_step
                                      else None),
                "ms_by_step": by_step,
                "events_ms": _event_ms(torch, lambda: fn(*calls[0]),
                                       self.reps),
                "exact_vs_plain": exact}


class CcgSolve:
    """``ccg_solve`` at M = 4096 on round 0 of the seeded stream, warm-
    started from Stage 1 as on the main path, launched through its entry
    point with sentinel outputs; timed by the profiler's device time (a
    launch takes less time on the card than on the host, so back-to-back
    events would time the host), events beside it."""

    def __init__(self, torch, reps: int, device_ms):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.core.robust import RobustProblem
        from repro_torch.core.router import stage1_configure
        from repro_torch.kernels import _build
        from repro_torch.kernels.ccg_solve.ops import ccg_solve
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps, self.device_ms = torch, reps, device_ms
        dev = self.dev = torch.device("cuda")
        sys_ = SystemConfig()
        prob = RobustProblem.build(sys_, dev)
        lat = prob.lat
        stream = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1)
        z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
        none = torch.full((M,), -1, dtype=torch.int64, device=dev)
        route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
        wy = lat.flatten_index(route, r, sys_.n_fps - 1).to(torch.int32)
        k, p = sys_.num_versions, prob.u_all.shape[0]
        margin = sys_.acc_margin_robust
        self.want = ccg_solve(z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                              lat.b2_flat, prob.u_all, lat.c1_flat, wy,
                              margin=margin, num_versions=k, force="ref")
        self.ins = [z, aq, wy, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                    _build.all_ones(lat.n_flat, dev),
                    lat.b2_flat.t().contiguous(), prob.u_all.contiguous(),
                    lat.c1_flat]
        self.sizes = [M, lat.n_flat, k, p, min(8, p + 1), margin, 1e-4]

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, dev = self.torch, self.dev
        outs = [torch.full((M,), -7, dtype=dt, device=dev) for dt in
                (torch.int32, torch.int32, torch.float32, torch.float32,
                 torch.int32, torch.int32)]
        call = [t.data_ptr() for t in self.ins + outs] + self.sizes + [
            _build.stream_ptr(dev)]
        fn = lib.ccg_solve_launch
        _build.check(fn(*call), "ccg_solve")
        torch.cuda.synchronize()
        got = (*outs[:5], outs[5] > 0)
        exact = all(torch.equal(g, w) for g, w in zip(got, self.want))
        if exact_required and not exact:
            return {"outside_tolerance": "differs from the plain version"}
        # a launch is shorter than its host call: device time, not events
        return {"ms": self.device_ms(torch, lambda: fn(*call),
                                     "ccg_solve_kernel", self.reps),
                "events_ms": _event_ms(torch, lambda: fn(*call), self.reps),
                "exact_vs_plain": exact,
                "max_iters_in_run": int(self.want[4].max())}


class LptQueue:
    """``lpt_queue`` at M = 4096, launched through its entry point on the
    sorted order the wrapper computes, with a sentinel output: all-edge
    routes, as the main path's, and mixed ones."""

    def __init__(self, torch, reps: int):
        from repro_torch.kernels.lpt_queue.ops import lpt_queue

        self.torch, self.reps = torch, reps
        dev = self.dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(5)
        t = (torch.rand(M, generator=gen) * 0.5 + 0.001).to(dev)
        self.cases = {}
        for routes in ("all_edge", "mixed"):
            route = (torch.zeros(M, dtype=torch.int32) if routes == "all_edge"
                     else torch.randint(0, 2, (M,), generator=gen,
                                        dtype=torch.int32)).to(dev)
            self.cases[routes] = (t, route, torch.argsort(-t, stable=True),
                                  lpt_queue(t, route, 4, 1, force="ref"))

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, rec = self.torch, {}
        for routes, (t, route, order, want) in self.cases.items():
            start = torch.full_like(t, float("nan"))
            call = [t.data_ptr(), route.data_ptr(), order.data_ptr(), None,
                    start.data_ptr(), 1, M, 4, 1, _build.stream_ptr(self.dev)]
            fn = lib.lpt_queue_launch
            _build.check(fn(*call), "lpt_queue")
            torch.cuda.synchronize()
            exact = torch.equal(start, want)
            if exact_required and not exact:
                return {"outside_tolerance": f"{routes}: differs from the "
                                             f"plain version"}
            rec[routes] = {"ms": _event_ms(torch, lambda: fn(*call),
                                           self.reps),
                           "exact_vs_plain": exact}
        return rec


class GateCell:
    """``gate_cell`` at M = 4096, d = 35 on the stream's round-0 features,
    through its wrapper with the variant's library; timed by the
    profiler's device time, events beside it."""

    def __init__(self, torch, reps: int, device_ms):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.core.gating import GateConfig, init_gate_params
        from repro_torch.kernels.temporal_gate.ops import gate_cell
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps, self.device_ms = torch, reps, device_ms
        self.fn = gate_cell
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(7)
        p = init_gate_params(GateConfig(d_feature=35), gen, dev)
        p = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
             if k.startswith("b_") else v for k, v in p.items()}
        stream = Simulator(SystemConfig(), SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1,
                                                     feature_seed=1)
        self.args = (stream.dx[0].contiguous(),
                     (torch.rand((M, 32), generator=gen) * 2 - 1).to(dev),
                     (torch.rand((M,), generator=gen) * 2).to(dev), p)
        self.want = gate_cell(*self.args, force="ref")
        self.committed = gate_cell(*self.args, force="kernel")

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch = self.torch
        _build.library = lambda: lib
        call = lambda: self.fn(*self.args, force="kernel")
        got = call()
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, self.want))
        if exact_required and not err <= 1e-5:
            return {"outside_tolerance": f"max |diff| {err} > 1e-5"}
        return {"ms": self.device_ms(torch, call, "gate_cell_kernel",
                                     self.reps),
                "events_ms": _event_ms(torch, call, self.reps),
                "max_abs_err_vs_plain": err,
                "bit_equal_to_committed": all(
                    torch.equal(g, c) for g, c in zip(got, self.committed))}


class GateCellBwd:
    """``gate_cell_bwd`` at B = 4096, d = 35 on ``chip_smoke.py``'s
    kernel-row inputs (the stream's round-0 features, random h, vol and
    incoming gradients), through its wrapper with the variant's library:
    every gradient within ``chip_smoke.GRAD_TOL`` of max(1, its largest
    |entry|);
    timed by the profiler's device time of a call (both kernels)."""

    def __init__(self, torch, reps: int, chip_smoke):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.core.gating import GateConfig, init_gate_params
        from repro_torch.kernels.temporal_gate.ops import gate_cell_vjp
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps, self.smoke = torch, reps, chip_smoke
        self.fn = gate_cell_vjp
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(11)
        p = init_gate_params(GateConfig(d_feature=35), gen, dev)
        p = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
             if k.startswith("b_") else v for k, v in p.items()}
        stream = Simulator(SystemConfig(), SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1,
                                                     feature_seed=1)
        rand = lambda *shape: torch.randn(shape, generator=gen).to(dev)
        self.args = (stream.dx[0].contiguous(),
                     (torch.rand((M, 32), generator=gen) * 2 - 1).to(dev),
                     (torch.rand((M,), generator=gen) * 2).to(dev), p)
        self.kw = dict(dh_new=rand(M, 32), dtau=rand(M), dg_mean=rand(M))
        self.want = self._flat(gate_cell_vjp(*self.args, **self.kw,
                                             force="ref"))
        self.committed = self._flat(gate_cell_vjp(*self.args, **self.kw,
                                                  force="kernel"))

    @staticmethod
    def _flat(out):
        grads, dh = out
        return dict(grads, dh=dh)

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch = self.torch
        _build.library = lambda: lib
        call = lambda: self.fn(*self.args, **self.kw, force="kernel")
        got = self._flat(call())
        torch.cuda.synchronize()
        err = max(float((got[k] - w).abs().max()
                        / w.abs().max().clamp_min(1.0))
                  for k, w in self.want.items())
        if exact_required and not err <= self.smoke.GRAD_TOL:
            return {"outside_tolerance": f"{err} of the largest entry > "
                                         f"{self.smoke.GRAD_TOL}"}
        return {"ms": self.smoke.device_ms(torch, call, None, self.reps),
                "events_ms": _event_ms(torch, call, self.reps),
                "max_err_rel_to_max_1_largest": err,
                "bit_equal_to_committed": all(
                    torch.equal(got[k], c) for k, c in
                    self.committed.items())}


class C6Repair:
    """``c6_repair`` on ``chip_smoke.c6_repair_cases`` at M = 4096 (the
    main path's inputs and the demoting case) and on both tiled to
    ``BIG`` tasks (``chip_smoke.c6_repair_tiled``), through its wrapper with
    the variant's library; the ``per_round`` variant above 16,384 tasks
    through the per-round path (``repair_rounds`` on the variant's
    ``c6_tail``).  Timed by the profiler's device time of the kernel a
    launch (every activity of a call on the per-round path)."""

    BIG = (16385, 53248, 131072)

    def __init__(self, torch, reps: int, chip_smoke):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.kernels.c6_tail.ops import c6_repair
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps, self.smoke = torch, reps, chip_smoke
        self.fn = c6_repair
        dev = torch.device("cuda")
        stream = Simulator(SystemConfig(), SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1,
                                                     feature_seed=1)
        cases = chip_smoke.c6_repair_cases(torch, stream, dev)
        self.cases = {(what, m): cases[M, what] if m == M
                      else chip_smoke.c6_repair_tiled(cases, what, m)
                      for what in ("main_path", "demoting")
                      for m in (M, *self.BIG)}

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build
        from repro_torch.kernels.c6_tail.ops import REPAIR_CAP, c6_tail
        from repro_torch.kernels.c6_tail.ref import (
            compare_repairs,
            repair_rounds,
        )

        torch, rec = self.torch, {}
        _build.library = lambda: lib
        per_round = getattr(lib, "variant", None) == "per_round"

        def tail(*a, n_fps):
            return c6_tail(*a, n_fps=n_fps, force="kernel")

        for (what, m), (args, budget) in self.cases.items():
            def run(k, force, args=args, budget=budget, m=m):
                if force == "kernel" and per_round and m > REPAIR_CAP:
                    return repair_rounds(tail, *args, budget, 5, k)
                return self.fn(*args, budget, n_fps=5, rounds=k,
                               force=force)

            key = f"{what}@{m}"
            try:
                run(8, "kernel")
            except RuntimeError as e:        # a baseline's refused launch
                rec[key] = {"refused": str(e)}
                continue
            if exact_required:
                out = compare_repairs(lambda k: run(k, "kernel"),
                                      lambda k: run(k, "ref"), 8, args,
                                      budget, 5)
                if not out["within"]:
                    return {"outside_tolerance": f"{key}: {out}"}
            call = lambda: run(8, "kernel")
            # per launch of the kernel, counted in the trace; every
            # activity of a call on the per-round path
            symbol = ("c6_repair_kernel" if m <= REPAIR_CAP else None
                      if per_round else "c6_repair_cluster_kernel")
            rec[key] = {"ms": self.smoke.device_ms(torch, call, symbol,
                                                   self.reps),
                        "events_ms": _event_ms(torch, call, self.reps)}
        return rec


class FlashAttentionBwd:
    """``flash_attention_bwd`` in bf16 at the training shape, Qwen3-8B's
    GQA and D = 256 with a window, through its wrapper with the variant's
    library and the committed forward's LSE (given, so a call launches the
    backward kernels alone); timed by the profiler's device time of a
    call, events beside it."""

    CASES = {"qwen1.5-0.5b train": (8, 16, 16, 512, 64, None),
             "qwen3-8b gqa": (2, 32, 8, 512, 128, None),
             "d256 window 128": (2, 16, 1, 512, 256, 128)}

    def __init__(self, torch, reps: int, chip_smoke):
        from repro_torch.kernels.flash_attention import ops

        self.torch, self.reps, self.smoke = torch, reps, chip_smoke
        self.fn = ops.flash_attention_bwd
        dev = torch.device("cuda")
        gen = torch.Generator(dev).manual_seed(12)
        self.cases = {}
        for name, (b, h, kv, s, d, window) in self.CASES.items():
            n = lambda heads: torch.randn(
                (b, s, heads, d), generator=gen, device=dev).to(
                torch.bfloat16).transpose(1, 2)
            q, k, v, do = n(h), n(kv), n(kv), n(h)
            # the training launch's LSE at every D (the wrapper asks for it
            # only where the committed backward reads it)
            lse = ops._lse_buffer(q)
            o = ops._forward_launch(q, k, v, None, window, True, 1, lse)
            want = ops.attention_vjp_ref(q, k, v, do, window=window)
            self.cases[name] = ((q, k, v, o, do), dict(window=window,
                                                       lse=lse), want)

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, rec = self.torch, {}
        _build.library = lambda: lib
        for name, (args, kw, want) in self.cases.items():
            call = lambda: self.fn(*args, force="kernel", **kw)
            got, again = call(), call()
            torch.cuda.synchronize()
            err = max(float((g.double() - w.double()).abs().max())
                      / max(1.0, float(w.abs().max()))
                      for g, w in zip(got, want))
            if exact_required and not (
                    err <= self.smoke.BWD_TOL["bfloat16"]
                    and all(map(torch.equal, got, again))):
                return {"outside_tolerance": f"{name}: {err} of the largest "
                                             f"entry, or two launches differ"}
            rec[name] = {"ms": self.smoke.device_ms(torch, call, None,
                                                    self.reps),
                         "events_ms": _event_ms(torch, call, self.reps),
                         "max_err_of_largest": err}
        return rec


class SmokeRows:
    """``mamba_scan``, ``rglru_scan``, ``flash_attention`` or
    ``decode_attention`` through ``chip_smoke.py``'s checks and timings
    (``scan_rows`` / ``attention_rows``), or, for a diagnostic variant, its
    device time alone at the serving shapes."""

    KEYS = ("ms", "ms_from", "call_ms", "max_abs_err", "max_abs_err_float32")

    def __init__(self, torch, chip_smoke, kernel: str):
        from repro_torch.kernels.decode_attention.ops import decode_attention
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.mamba_scan.ops import selective_scan
        from repro_torch.kernels.rglru.ops import rglru_scan

        self.torch, self.chip_smoke, self.kernel = torch, chip_smoke, kernel
        self.fn = {"mamba_scan": selective_scan, "rglru_scan": rglru_scan,
                   "flash_attention": flash_attention,
                   "decode_attention": decode_attention}[kernel]
        dev = self.dev = torch.device("cuda")
        gen = torch.Generator(dev).manual_seed(13)

        def normal(*shape, dtype=torch.float32, scale=1.0):
            return (scale * torch.randn(shape, generator=gen,
                                        device=dev)).to(dtype)

        bf16 = torch.bfloat16
        if kernel == "decode_attention":
            # the slabs at ragged lengths 1..S, read through permuted views
            self.shapes = {}
            for tier, (h, kv, d, s) in {
                    "cloud": (32, 8, 128, 144), "edge": (16, 16, 64, 144),
                    "recurrentgemma": (16, 1, 256, 80)}.items():
                length = torch.randint(1, s + 1, (16,), generator=gen,
                                       device=dev, dtype=torch.int32)
                self.shapes[tier] = ((
                    normal(16, h, d, dtype=bf16),
                    normal(16, s, kv, d, dtype=bf16).permute(0, 2, 1, 3),
                    normal(16, s, kv, d, dtype=bf16).permute(0, 2, 1, 3),
                    length), {})
        elif kernel == "flash_attention":
            self.shapes = {
                tier: ((normal(8, 80, h, d, dtype=bf16).transpose(1, 2),
                        normal(8, 80, kv, d, dtype=bf16).transpose(1, 2),
                        normal(8, 80, kv, d, dtype=bf16).transpose(1, 2)), kw)
                for tier, (h, kv, d, kw) in {
                    "cloud": (32, 8, 128, {}), "edge": (16, 16, 64, {}),
                    "recurrentgemma": (16, 1, 256, {"window": 2048})}.items()}
        elif kernel == "rglru_scan":
            self.shapes = {
                what: ((normal(b, s, 4096, dtype=bf16),
                        torch.sigmoid(normal(b, s, 4096)),
                        torch.sigmoid(normal(b, s, 4096)),
                        -8.0 * torch.nn.functional.softplus(normal(4096)),
                        normal(b, 4096) if s == 1 else None), {})
                for what, (b, s) in {"decode": (16, 1),
                                     "prefill": (8, 80)}.items()}
        else:
            self.shapes = {
                what: ((normal(b, s, 8192, dtype=bf16),
                        torch.nn.functional.softplus(normal(b, s, 8192,
                                                            scale=0.5)),
                        normal(b, s, 16, dtype=bf16),
                        normal(b, s, 16, dtype=bf16),
                        -torch.exp(normal(8192, 16, scale=0.2)), normal(8192),
                        normal(b, 8192, 16) if s == 1 else None), {})
                for what, (b, s) in {"decode": (16, 1),
                                     "prefill": (8, 80)}.items()}

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, smoke, kernel = self.torch, self.chip_smoke, self.kernel
        _build.library = lambda: lib
        if not exact_required:
            return {what: smoke.device_ms(
                torch, lambda: self.fn(*args, force="kernel", **kw),
                f"{kernel}_kernel")
                for what, (args, kw) in self.shapes.items()}
        try:
            rows = (smoke.scan_rows(torch, self.dev, names=(kernel,))
                    if kernel.endswith("_scan")
                    else smoke.attention_rows(torch, self.dev))
        except AssertionError as err:
            return {"outside_tolerance": str(err)}
        row = rows[kernel]
        rec = {k: row[k] for k in self.KEYS}
        for sub in ("prefill", "edge", "recurrentgemma"):
            if sub in row:
                rec[sub] = {k: row[sub][k] for k in self.KEYS
                            if k in row[sub]}
        return rec


KERNELS = ("ccg_encode", "ccg_master", "mamba_scan", "flash_attention",
           "decode_attention", "lpt_queue", "rglru_scan", "ccg_solve",
           "gate_cell", "gate_cell_bwd", "c6_repair", "flash_attention_bwd")
EVENT_TIMED = {"lpt_queue": LptQueue}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=KERNELS, action="append")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--diagnose", action="store_true",
                    help="time the variants that drop one part of the work")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a checkout whose source of each kernel is built "
                         "and timed as the variant 'baseline'")
    ap.add_argument("--reps", type=int, default=200,
                    help="ccg_encode / ccg_master / ccg_solve / lpt_queue / "
                         "gate_cell / c6_repair launches per timing")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build

    kernels = args.kernel or list(KERNELS)
    libs = build(kernels, args.diagnose, args.baseline)
    library = _build.library
    if "flash_attention_bwd" in libs:
        out = ROOT / "build" / "kernel_variants"
        print(json.dumps({"ptxas": {
            name: ptxas_report((out / f"flash_attention_bwd_{name}.log")
                               .read_text(), "fa_bwd")
            for name in libs["flash_attention_bwd"]}}), flush=True)
    profiled = {"ccg_encode": lambda: CcgEncode(torch, args.reps,
                                                chip_smoke.device_ms),
                "ccg_master": lambda: CcgMaster(torch, args.reps, chip_smoke),
                "ccg_solve": lambda: CcgSolve(torch, args.reps,
                                              chip_smoke.device_ms),
                "gate_cell": lambda: GateCell(torch, args.reps,
                                              chip_smoke.device_ms),
                "gate_cell_bwd": lambda: GateCellBwd(torch, args.reps,
                                                     chip_smoke),
                "c6_repair": lambda: C6Repair(torch, args.reps, chip_smoke),
                "flash_attention_bwd": lambda: FlashAttentionBwd(
                    torch, 20, chip_smoke)}
    runs = {k: profiled[k]() if k in profiled
            else EVENT_TIMED[k](torch, args.reps)
            if k in EVENT_TIMED else SmokeRows(torch, chip_smoke, k)
            for k in kernels}
    try:
        for rnd in range(args.rounds):
            for kernel, by_name in libs.items():
                for name in list(by_name)[::-1 if rnd % 2 else 1]:
                    rec = {"round": rnd, "kernel": kernel, "variant": name}
                    rec.update(runs[kernel](by_name[name],
                                            exact_required=not args.diagnose))
                    print(json.dumps(rec), flush=True)
    finally:
        _build.library = library
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
