// Longest-processing-time packing of one round's tasks onto the edge and
// cloud server pools — one block per round, one thread for the serial walk.
//
// Not a TPU kernel: it replaces the lax.scan over the sorted tasks in
// src/repro/serving/simulator.py:_lpt_queue (a realization helper).  A plain
// PyTorch loop over that scan issues a handful of tiny launches per task,
// about 37k per round at M = 4096.
//
// What bounds it on the H100: the serial dependence.  Task i's server is the
// least-loaded one of its tier after tasks 0..i-1 are placed, and exactness
// needs the reference's sequential float32 loads[j] + t, so the walk is one
// chain of M steps; the data (5 B per task in, 4 B out) and the arithmetic
// are negligible.  A step's latency and its instruction count are what
// count: one thread executes them all.
//
// Design: the block gathers the round's tasks into shared memory in
// longest-first order (the stable argsort the wrapper computes; 256
// threads, sixteen tasks each in flight), the times as float and the tiers
// as one bit per task (a warp ballot per 32 tasks).  Each tier's loads live
// in registers of their own, specialised at compile time for the
// configuration the port runs (4 edge + 1 cloud servers) and padded with
// +inf in a generic instantiation of the same kernel for every other split
// of up to 8 servers; a task touches only its tier's loads.  A walk holds 32
// tasks in registers and reads the next 32 (eight 16-byte loads) before it
// walks the current ones; a batch's starts are stored over the batch's own
// times once they are walked, which keeps shared memory at 4.25 bytes a
// task.  The block then scatters each start to its task's position.
//
// Two walks, the same picks.  The sorted walk (times and starting loads
// >= 0 and a live cloud server, the common case) keeps each tier's loads
// sorted by (load, server index): the least-loaded server, first index on
// ties, is always the first entry, and a step is one add, one unsigned
// compare of the sum's bits per other entry (non-negative floats order as
// their bits; the entry's threshold is its bits + 1 where its index is the
// larger, so ties go to the lower index) and the selects that insert the
// sum back in order.  A tier's tasks touch no other tier, so thread 0 walks
// the edge tier and thread 32, in another warp, the cloud tier, side by
// side; in a round of both tiers each tier's times are first moved
// together (a prefix count of the tier bits gives each task its slot), so
// each walker reads only its own tasks.  The tree walk takes every other
// input (a negative or NaN time or load, or a cloud tier all at +inf, where
// the reference's argmin over all servers picks server 0, an edge server):
// one thread, both tiers, per task a balanced-tree argmin whose left
// (lower-index) operand wins ties — the reference's first-index argmin —
// and the add on the picked server.  Loads start at zero or at per-server
// values (the reference's `avail`: +inf for a dead server).  Logic is
// bitwise (& and | on bools): && and || compile to branches, which cost
// more than the walk.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// 256 threads: a larger block would cap the walking thread's registers
// (64 at 1024 threads) below its 32-task batches, which then spill
constexpr int kThreads = 256;
constexpr int kMaxServers = 8;
constexpr int kBatch = 32;      // tasks the walking thread holds at once
constexpr int kGatherPer = 16;  // tasks a thread gathers per pass

// argmin of x[0..N): a balanced tree, pairs at stride w = 1, 2, 4, ...; the
// left operand (lower indices) keeps a tie, so the pick is the first index
// of the minimum
template <int N>
__device__ __forceinline__ void tree_argmin(const float (&x)[N], float& best,
                                            int& pick) {
  float val[N];
  int idx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    val[i] = x[i];
    idx[i] = i;
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) {
      const bool right = val[i + w] < val[i];
      val[i] = right ? val[i + w] : val[i];
      idx[i] = right ? idx[i + w] : idx[i];
    }
  }
  best = val[0];
  pick = idx[0];
}

// loads x with server indices id, sorted by (load, index) in place
template <int N>
__device__ __forceinline__ void sort_loads(float (&x)[N], int (&id)[N]) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
#pragma unroll
    for (int j = 0; j + 1 < N; ++j) {
      const bool swap =
          (x[j + 1] < x[j]) | ((x[j + 1] == x[j]) & (id[j + 1] < id[j]));
      const float a = x[j], b = x[j + 1];
      const int ia = id[j], ib = id[j + 1];
      x[j] = swap ? b : a;
      x[j + 1] = swap ? a : b;
      id[j] = swap ? ib : ia;
      id[j + 1] = swap ? ia : ib;
    }
  }
}

// one task of time t >= 0 on the first of the sorted loads x: returns that
// load and inserts x[0] + t back in order (t = 0 leaves x as it is)
template <int N>
__device__ __forceinline__ float place_sorted(float (&x)[N], int (&id)[N],
                                              float t) {
  const float start = x[0];
  const float a = x[0] + t;
  const unsigned key = __float_as_uint(a);
  bool before[N] = {};            // (a, id[0]) sorts before (x[k], id[k])
#pragma unroll
  for (int k = 1; k < N; ++k)     // + 1 where id[0] < id[k]: the sign bit
    // (the sign bit by a high multiply: the walk is bound by the
    // integer/logic pipe's throughput, and this keeps the bit on the
    // multiply pipe)
    before[k] = key < __float_as_uint(x[k]) +
                          __umulhi((unsigned)(id[0] - id[k]), 2u);
  float nx[N];
  int nid[N];
#pragma unroll
  for (int k = 0; k + 1 < N; ++k) {
    const bool shifted = (k >= 1) & before[k];     // a sits below slot k
    nx[k] = before[k + 1] ? (shifted ? x[k] : a) : x[k + 1];
    nid[k] = before[k + 1] ? (shifted ? id[k] : id[0]) : id[k + 1];
  }
  nx[N - 1] = (N > 1) & before[N - 1] ? x[N - 1] : a;
  nid[N - 1] = (N > 1) & before[N - 1] ? id[N - 1] : id[0];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = nx[k];
    id[k] = nid[k];
  }
  return start;
}

// the walk over times[0, n) (n a multiple of 32) in batches of 32, the next
// batch read ahead; step(t, i0, st) walks the batch at i0 and returns the
// mask of the starts it wrote into st, which are stored over their times
template <typename Step>
__device__ __forceinline__ void walk(float* times, int n, Step step) {
  float4 next[kBatch / 4];
#pragma unroll
  for (int u = 0; u < kBatch / 4; ++u)
    next[u] = reinterpret_cast<const float4*>(times)[u];
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float t[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch / 4; ++u) {
      t[4 * u] = next[u].x;
      t[4 * u + 1] = next[u].y;
      t[4 * u + 2] = next[u].z;
      t[4 * u + 3] = next[u].w;
    }
    if (i0 + kBatch < n) {                           // read ahead
#pragma unroll
      for (int u = 0; u < kBatch / 4; ++u)
        next[u] = reinterpret_cast<const float4*>(times + i0 + kBatch)[u];
    }
    float st[kBatch];
    step(t, i0, st);
#pragma unroll
    for (int u = 0; u < kBatch / 4; ++u)
      reinterpret_cast<float4*>(times + i0)[u] =
          make_float4(st[4 * u], st[4 * u + 1], st[4 * u + 2], st[4 * u + 3]);
  }
}

// shared memory: the times (Mp + 32 floats), the tier bits and, per 32-task
// word, the cloud tasks before it (Mp / 32 words each), then two counts
__host__ __device__ inline size_t smem_bytes(int M) {
  const size_t Mp = (size_t)(M + kBatch - 1) / kBatch * kBatch;
  return 4 * (Mp + kBatch) + 8 * (Mp / 32) + 16;
}

// kE, kC: edge and cloud servers held in registers (n_edge <= kE,
// n_cloud <= kC; the rest start at +inf and are never picked)
template <int kE, int kC>
__global__ void __launch_bounds__(kThreads)
    lpt_queue_kernel(const float* __restrict__ t_comp,
                     const int* __restrict__ route,
                     const long long* __restrict__ order,
                     const float* __restrict__ init, float* __restrict__ start,
                     int M, int n_edge, int n_cloud) {
  extern __shared__ float smem[];
  const int Mp = (M + kBatch - 1) / kBatch * kBatch, words = Mp / 32;
  float* s_t = smem;                          // (Mp + 32,) times, starts
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + Mp + kBatch);
  unsigned* s_pre = s_bits + words;           // cloud tasks before a word
  const size_t base = (size_t)blockIdx.x * M;
  const int tid = threadIdx.x, lane = tid & 31;

  // the starting loads: zero or the caller's; the sorted walk needs every
  // time and load >= 0 and a live cloud server, else the tree walk runs
  const int n_srv = n_edge + n_cloud;
  const float* row = init ? init + (size_t)blockIdx.x * n_srv : nullptr;
  float e[kE], c[kC];
  bool odd = false, cloud_alive = false;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    e[j] = j < n_edge ? (row ? row[j] : 0.0f) : CUDART_INF_F;
    odd |= !(e[j] >= 0.0f) | (__float_as_uint(e[j]) >> 31);
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    c[j] = j < n_cloud ? (row ? row[n_edge + j] : 0.0f) : CUDART_INF_F;
    odd |= !(c[j] >= 0.0f) | (__float_as_uint(c[j]) >> 31);
    cloud_alive |= c[j] < CUDART_INF_F;
  }

  // gather in longest-first order; Mp is a multiple of 32, so every warp
  // takes whole 32-task words
  __shared__ int s_clouds;
  if (tid == 0) s_clouds = 0;
  __syncthreads();
  int clouds = 0;                             // this warp's, on lane 0
  for (int i0 = tid; i0 < Mp; i0 += kThreads * kGatherPer) {
    long long src[kGatherPer];
    float t[kGatherPer];
    bool cloud[kGatherPer];
#pragma unroll
    for (int u = 0; u < kGatherPer; ++u) {
      const int i = i0 + u * kThreads;
      src[u] = i < M ? order[base + i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kGatherPer; ++u) {
      t[u] = src[u] >= 0 ? t_comp[base + src[u]] : 0.0f;
      cloud[u] = (src[u] >= 0) & (route[base + src[u]] != 0);
      odd |= !(t[u] >= 0.0f) | (__float_as_uint(t[u]) >> 31);
    }
#pragma unroll
    for (int u = 0; u < kGatherPer; ++u) {
      const int i = i0 + u * kThreads;
      if (i < Mp) {                                    // warp-uniform
        s_t[i] = t[u];
        const unsigned bits = __ballot_sync(0xffffffffu, cloud[u]);
        if (lane == 0) s_bits[i >> 5] = bits;
        clouds += __popc(bits);
      }
    }
  }
  if ((lane == 0) & (clouds > 0)) atomicAdd(&s_clouds, clouds);
  odd = __syncthreads_or(odd);
  const int n_cloud_tasks = s_clouds;
  const bool sorted = !odd & cloud_alive;
  // a mixed round on the sorted walk: each tier's times moved together,
  // the edge tier's from 0, the cloud tier's from cbase (32-aligned, the
  // gaps zero), so each walker reads only its own tier's tasks
  const bool mixed = sorted & (n_cloud_tasks > 0) & (n_cloud_tasks < M);
  const int n_edge_tasks = M - n_cloud_tasks;
  const int cbase = (n_edge_tasks + kBatch - 1) / kBatch * kBatch;
  auto slot = [&](int i) {                    // sorted task i's time slot
    if (!mixed) return i;
    const unsigned w = s_bits[i >> 5], below = w & ((1u << (i & 31)) - 1u);
    const int ahead = s_pre[i >> 5] + __popc(below);   // cloud tasks
    return (w >> (i & 31)) & 1u ? cbase + ahead : i - ahead;
  };
  if (mixed) {
    if (tid < 32) {                           // cloud tasks before each word
      const int per = (words + 31) / 32;
      unsigned sum = 0;
      for (int w = tid * per; w < min(words, (tid + 1) * per); ++w)
        sum += __popc(s_bits[w]);
      unsigned run = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += v;
      }
      run -= sum;
      for (int w = tid * per; w < min(words, (tid + 1) * per); ++w) {
        s_pre[w] = run;
        run += __popc(s_bits[w]);
      }
    }
    __syncthreads();
    // the times again from device memory, to their tier's slots (s_t's
    // sorted copy is overwritten in place), and zeros in the gaps
    for (int i0 = tid; i0 < Mp + kBatch; i0 += kThreads * kGatherPer) {
      long long src[kGatherPer];
#pragma unroll
      for (int u = 0; u < kGatherPer; ++u) {
        const int i = i0 + u * kThreads;
        src[u] = i < M ? order[base + i] : -1;
      }
      float t[kGatherPer];
#pragma unroll
      for (int u = 0; u < kGatherPer; ++u)
        t[u] = src[u] >= 0 ? t_comp[base + src[u]] : 0.0f;
#pragma unroll
      for (int u = 0; u < kGatherPer; ++u) {
        const int i = i0 + u * kThreads;
        if (i < M) s_t[slot(i)] = t[u];
        const bool gap = ((i >= n_edge_tasks) & (i < cbase)) |
                         ((i >= cbase + n_cloud_tasks) & (i < Mp + kBatch));
        if (gap) s_t[i] = 0.0f;
      }
    }
  }
  __syncthreads();

  // thread 0 walks the edge tier (or, on the tree walk, both tiers), thread
  // 32, in another warp, the cloud tier: with each tier's loads sorted, a
  // task touches only its own tier, so the two walks run side by side
  if (sorted & (tid == 0) & (n_edge_tasks > 0)) {
    int eid[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) eid[j] = j;
    sort_loads(e, eid);
    walk(s_t, mixed ? cbase : Mp, [&](const float* t, int, float* st) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) st[u] = place_sorted(e, eid, t[u]);
    });
  } else if (sorted & (tid == 32) & (n_cloud_tasks > 0)) {
    int cid[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) cid[j] = j;
    sort_loads(c, cid);
    walk(s_t + (mixed ? cbase : 0),
         mixed ? (n_cloud_tasks + kBatch - 1) / kBatch * kBatch : Mp,
         [&](const float* t, int, float* st) {
#pragma unroll
           for (int u = 0; u < kBatch; ++u) st[u] = place_sorted(c, cid, t[u]);
         });
  } else if (!sorted & (tid == 0)) {
    walk(s_t, Mp, [&](const float* t, int i0, float* st) {
      const unsigned bits = s_bits[i0 >> 5];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // both tiers' argmins, no branch: a task updates only its own tier
        const bool cloud = (bits >> u) & 1u;
        float best_e, best_c;
        int pick_e, pick_c;
        tree_argmin(e, best_e, pick_e);
        tree_argmin(c, best_c, pick_c);
        const bool to_e0 = cloud & !(best_c < CUDART_INF_F);  // cloud +inf
        st[u] = !cloud ? best_e : to_e0 ? e[0] : best_c;
#pragma unroll
        for (int j = 0; j < kE; ++j)
          e[j] = (!cloud & (j == pick_e)) | ((j == 0) & to_e0) ? e[j] + t[u]
                                                              : e[j];
#pragma unroll
        for (int j = 0; j < kC; ++j)
          c[j] = cloud & !to_e0 & (j == pick_c) ? c[j] + t[u] : c[j];
      }
    });
  }
  __syncthreads();

  for (int i0 = tid; i0 < M; i0 += kThreads * kGatherPer) {
#pragma unroll
    for (int u = 0; u < kGatherPer; ++u) {
      const int i = i0 + u * kThreads;
      if (i < M) start[base + order[base + i]] = s_t[slot(i)];
    }
  }
}

template <int kE, int kC>
int launch(const void* t_comp, const void* route, const void* order,
           const void* init, void* start, int R, int M, int n_edge,
           int n_cloud, cudaStream_t stream) {
  const size_t smem = smem_bytes(M);
  auto kernel = lpt_queue_kernel<kE, kC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (R > 0 && M > 0) {
    kernel<<<R, kThreads, smem, stream>>>(
        (const float*)t_comp, (const int*)route, (const long long*)order,
        (const float*)init, (float*)start, M, n_edge, n_cloud);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// init: (R, n_edge + n_cloud) float32 starting loads, or null for zeros
extern "C" int lpt_queue_launch(const void* t_comp, const void* route,
                                const void* order, const void* init,
                                void* start, int R, int M, int n_edge,
                                int n_cloud, void* stream) {
  if (n_edge < 1 || n_cloud < 1 || n_edge + n_cloud > kMaxServers) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  // the configuration the port runs (SystemConfig / SimConfig), then every
  // other split of up to 8 servers
  auto fn = n_edge == 4 && n_cloud == 1 ? launch<4, 1>
                                        : launch<kMaxServers - 1, kMaxServers - 1>;
  return fn(t_comp, route, order, init, start, R, M, n_edge, n_cloud, st);
}
