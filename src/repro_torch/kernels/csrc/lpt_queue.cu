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
// of up to 8 servers, and in a wide one for up to 16 servers a tier (the
// stream-sharded session's whole pools, 16 edge + 8 cloud); a task touches
// only its tier's loads.  A walk holds 32
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
//
// Past one block (M > the one-block kernel's 54,656 tasks: the shared memory
// of 4.25 bytes a task is its only limit) lpt_queue_chunked_kernel walks the
// same way out of a device-memory scratch buffer that the wrapper allocates
// (per round the times in walk order, the tier bits and the cloud tasks
// before each 32-task word).  The block first gathers the round into it in
// longest-first order and moves each tier's times together, as above.  The
// walkers then read their lists one 4096-task chunk at a time from shared
// memory, two buffers a tier: while thread 0 and thread 32 walk chunk k, the
// other six warps store chunk k-1's starts back over its times and fill the
// freed buffer with chunk k+1 by cp.async (the same 16-byte pieces a
// thread, so no barrier between the two), and one block barrier ends each
// chunk.  A chunk of 4096 steps takes some 90 µs of walk against a few µs of
// copies, so the walkers never wait for data (all-edge at M = 65,536: 22.7
// ns a step against 22.2 in one block, H100 at 700 W).  The two kernels
// share the gather and tier partition (arrange_round), the tree step
// (tree_batch) and the scatter; the walks are the same code on the same
// sequence of times (zeros in the gaps), so the picks and the chain of
// float32 adds, and thus the starts, are those of the one-block kernel and
// of the plain version.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

// 256 threads: a larger block would cap the walking thread's registers
// (64 at 1024 threads) below its 32-task batches, which then spill
constexpr int kThreads = 256;
constexpr int kMaxServers = 8;  // the generic instantiation's servers
constexpr int kMaxTier = 16;    // the wide instantiation's servers a tier
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

// a round's tasks in walk order: the times (Mp + 32 floats, each walker's
// starts stored over its times), the tier bits and the cloud tasks before
// each 32-task word; in shared memory for the one-block kernel, in the
// device scratch for the chunked one
struct Round {
  float* t;
  unsigned* bits;
  unsigned* pre;
};

// how a round's tasks split: the sorted walk's inputs (times and loads
// >= 0, a live cloud server), a mixed round's tiers moved together (the
// edge tier's times from 0, the cloud tier's from cbase, 32-aligned, the
// gaps zero) so each walker reads only its own tier's tasks
struct Tiers {
  bool sorted, mixed;
  int n_edge_tasks, n_cloud_tasks, cbase;
};

// the starting loads: zero or the caller's, +inf past each tier's servers;
// a negative or NaN load sets odd (the sorted walk cannot take it)
template <int kE, int kC>
__device__ __forceinline__ void start_loads(const float* row, int n_edge,
                                            int n_cloud, float (&e)[kE],
                                            float (&c)[kC], bool& odd,
                                            bool& cloud_alive) {
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
}

// sorted task i's time slot
__device__ __forceinline__ int slot_of(const Round& R, const Tiers& T,
                                       int i) {
  if (!T.mixed) return i;
  const unsigned w = R.bits[i >> 5], below = w & ((1u << (i & 31)) - 1u);
  const int ahead = R.pre[i >> 5] + __popc(below);   // cloud tasks
  return (w >> (i & 31)) & 1u ? T.cbase + ahead : i - ahead;
}

// the whole block: the round's tasks gathered into R in longest-first order
// and, in a mixed round on the sorted walk, each tier's times moved
// together; odd as start_loads leaves it
__device__ __forceinline__ Tiers arrange_round(
    const float* __restrict__ t_comp, const int* __restrict__ route,
    const long long* __restrict__ order, size_t base, int M, const Round& R,
    int* s_clouds, bool odd, bool cloud_alive) {
  const int Mp = (M + kBatch - 1) / kBatch * kBatch, words = Mp / 32;
  const int tid = threadIdx.x, lane = tid & 31;
  // gather in longest-first order; Mp is a multiple of 32, so every warp
  // takes whole 32-task words
  if (tid == 0) *s_clouds = 0;
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
      // a padding slot (src -1) reads its round's task 0, never route[-1]:
      // `&` evaluates both sides, and the word before round 0's route may
      // lie outside its allocation
      const long long at = src[u] >= 0 ? src[u] : 0;
      t[u] = src[u] >= 0 ? t_comp[base + at] : 0.0f;
      cloud[u] = (src[u] >= 0) & (route[base + at] != 0);
      odd |= !(t[u] >= 0.0f) | (__float_as_uint(t[u]) >> 31);
    }
#pragma unroll
    for (int u = 0; u < kGatherPer; ++u) {
      const int i = i0 + u * kThreads;
      if (i < Mp) {                                    // warp-uniform
        R.t[i] = t[u];
        const unsigned bits = __ballot_sync(0xffffffffu, cloud[u]);
        if (lane == 0) R.bits[i >> 5] = bits;
        clouds += __popc(bits);
      }
    }
  }
  if ((lane == 0) & (clouds > 0)) atomicAdd(s_clouds, clouds);
  odd = __syncthreads_or(odd);
  Tiers T;
  T.n_cloud_tasks = *s_clouds;
  const bool sorted = !odd & cloud_alive;
  T.sorted = sorted;
  T.mixed = sorted & (T.n_cloud_tasks > 0) & (T.n_cloud_tasks < M);
  T.n_edge_tasks = M - T.n_cloud_tasks;
  T.cbase = (T.n_edge_tasks + kBatch - 1) / kBatch * kBatch;
  if (T.mixed) {
    if (tid < 32) {                           // cloud tasks before each word
      const int per = (words + 31) / 32;
      unsigned sum = 0;
      for (int w = tid * per; w < min(words, (tid + 1) * per); ++w)
        sum += __popc(R.bits[w]);
      unsigned run = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += v;
      }
      run -= sum;
      for (int w = tid * per; w < min(words, (tid + 1) * per); ++w) {
        R.pre[w] = run;
        run += __popc(R.bits[w]);
      }
    }
    __syncthreads();
    // the times again from device memory, to their tier's slots (the
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
        if (i < M) R.t[slot_of(R, T, i)] = t[u];
        const bool gap =
            ((i >= T.n_edge_tasks) & (i < T.cbase)) |
            ((i >= T.cbase + T.n_cloud_tasks) & (i < Mp + kBatch));
        if (gap) R.t[i] = 0.0f;
      }
    }
  }
  __syncthreads();
  return T;
}

// the tree walk's step over a batch of 32 tasks (tier bits `bits`): both
// tiers' argmins, no branch, a task updating only its own tier's loads
template <int kE, int kC>
__device__ __forceinline__ void tree_batch(float (&e)[kE], float (&c)[kC],
                                           unsigned bits, const float* t,
                                           float* st) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
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
}

// the whole block: each task's start from its slot to its position
__device__ __forceinline__ void scatter_starts(
    const long long* __restrict__ order, float* __restrict__ start,
    size_t base, int M, const Round& R, const Tiers& T) {
  for (int i0 = threadIdx.x; i0 < M; i0 += kThreads * kGatherPer) {
#pragma unroll
    for (int u = 0; u < kGatherPer; ++u) {
      const int i = i0 + u * kThreads;
      if (i < M) start[base + order[base + i]] = R.t[slot_of(R, T, i)];
    }
  }
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
  __shared__ int s_clouds;
  const int Mp = (M + kBatch - 1) / kBatch * kBatch, words = Mp / 32;
  const Round R{smem, reinterpret_cast<unsigned*>(smem + Mp + kBatch),
                reinterpret_cast<unsigned*>(smem + Mp + kBatch) + words};
  const size_t base = (size_t)blockIdx.x * M;
  const int tid = threadIdx.x;
  float e[kE], c[kC];
  bool odd = false, cloud_alive = false;
  start_loads(init ? init + (size_t)blockIdx.x * (n_edge + n_cloud) : nullptr,
              n_edge, n_cloud, e, c, odd, cloud_alive);
  const Tiers T = arrange_round(t_comp, route, order, base, M, R, &s_clouds,
                                odd, cloud_alive);
  const bool sorted = T.sorted, mixed = T.mixed;
  const int n_edge_tasks = T.n_edge_tasks, n_cloud_tasks = T.n_cloud_tasks;
  const int cbase = T.cbase;

  // thread 0 walks the edge tier (or, on the tree walk, both tiers), thread
  // 32, in another warp, the cloud tier: with each tier's loads sorted, a
  // task touches only its own tier, so the two walks run side by side
  if (sorted & (tid == 0) & (n_edge_tasks > 0)) {
    int eid[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) eid[j] = j;
    sort_loads(e, eid);
    walk(R.t, mixed ? cbase : Mp, [&](const float* t, int, float* st) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) st[u] = place_sorted(e, eid, t[u]);
    });
  } else if (sorted & (tid == 32) & (n_cloud_tasks > 0)) {
    int cid[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) cid[j] = j;
    sort_loads(c, cid);
    walk(R.t + (mixed ? cbase : 0),
         mixed ? (n_cloud_tasks + kBatch - 1) / kBatch * kBatch : Mp,
         [&](const float* t, int, float* st) {
#pragma unroll
           for (int u = 0; u < kBatch; ++u) st[u] = place_sorted(c, cid, t[u]);
         });
  } else if (!sorted & (tid == 0)) {
    walk(R.t, Mp, [&](const float* t, int i0, float* st) {
      tree_batch(e, c, R.bits[i0 >> 5], t, st);
    });
  }
  __syncthreads();
  scatter_starts(order, start, base, M, R, T);
}

template <int kE, int kC>
int launch(const void* t_comp, const void* route, const void* order,
           const void* init, void* start, int R, int M, int n_edge,
           int n_cloud, cudaStream_t stream) {
  const size_t smem = smem_bytes(M);
  auto kernel = lpt_queue_kernel<kE, kC>;
  // opt in to all the dynamic shared memory a block may take, once per
  // device: later launches (a captured one among them) are the launch alone
  static int opted_in = -1;   // the device whose limit this kernel took
  int dev = 0;
  cudaGetDevice(&dev);
  if (opted_in != dev) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = dev;
  }
  if (R > 0 && M > 0) {
    kernel<<<R, kThreads, smem, stream>>>(
        (const float*)t_comp, (const int*)route, (const long long*)order,
        (const float*)init, (float*)start, M, n_edge, n_cloud);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- past one block

constexpr int kChunk = 4096;    // tasks of a walker's shared-memory buffer
constexpr int kCopyFrom = 64;   // threads below are the walkers' warps

// the chunked kernel's device-memory scratch a round, in 4-byte words: the
// times (Mp + 64), then the tier bits and the cloud tasks before each word
// (Mp / 32 each, the pair padded to 32 words so each round starts on 128
// bytes)
__host__ __device__ inline size_t chunked_scratch_words(int M) {
  const size_t Mp = (size_t)(M + kBatch - 1) / kBatch * kBatch;
  return Mp + 2 * kBatch + (2 * (Mp / 32) + 31) / 32 * 32;
}

// shared memory of the chunked kernel: two buffers of kChunk floats a tier,
// then two of kChunk / 32 tier-bit words (the tree walk's)
constexpr size_t kChunkedSmem = 4 * (4 * kChunk + 2 * (kChunk / 32));

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// one copying thread's share of a buffer: its n_dst starts stored back over
// their times at dst, then n_src times copied in from src (n_dst, n_src
// multiples of 32): the same 16-byte pieces in both, so this thread reads a
// piece before its own copy overwrites it
__device__ __forceinline__ void cycle_chunk(float* buf, float* dst, int n_dst,
                                            const float* src, int n_src,
                                            int ct, int n_ct) {
  for (int x = 4 * ct; x < max(n_dst, n_src); x += 4 * n_ct) {
    if (x < n_dst)
      *reinterpret_cast<float4*>(dst + x) =
          *reinterpret_cast<const float4*>(buf + x);
    if (x < n_src) cp_async16(buf + x, src + x);
  }
}

template <int kE, int kC>
__global__ void __launch_bounds__(kThreads)
    lpt_queue_chunked_kernel(const float* __restrict__ t_comp,
                             const int* __restrict__ route,
                             const long long* __restrict__ order,
                             const float* __restrict__ init,
                             float* __restrict__ start, float* scratch, int M,
                             int n_edge, int n_cloud) {
  extern __shared__ float smem[];
  __shared__ int s_clouds;
  const int Mp = (M + kBatch - 1) / kBatch * kBatch, words = Mp / 32;
  float* g_t = scratch + (size_t)blockIdx.x * chunked_scratch_words(M);
  const Round R{g_t, reinterpret_cast<unsigned*>(g_t + Mp + 2 * kBatch),
                reinterpret_cast<unsigned*>(g_t + Mp + 2 * kBatch) + words};
  float* s_buf = smem;                        // [tier][buffer][kChunk]
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + 4 * kChunk);
  const size_t base = (size_t)blockIdx.x * M;
  const int tid = threadIdx.x;
  float e[kE], c[kC];
  bool odd = false, cloud_alive = false;
  start_loads(init ? init + (size_t)blockIdx.x * (n_edge + n_cloud) : nullptr,
              n_edge, n_cloud, e, c, odd, cloud_alive);
  const Tiers T = arrange_round(t_comp, route, order, base, M, R, &s_clouds,
                                odd, cloud_alive);

  // the walkers' lists in the scratch: thread 0's (the edge tier's, or
  // every task on the tree walk and in an all-edge round) from 0, thread
  // 32's (the cloud tier's) from cbase in a mixed round, else from 0;
  // lengths padded to the 32-task batch
  const bool walk_e = T.sorted ? T.n_edge_tasks > 0 : true;
  const bool walk_c = T.sorted & (T.n_cloud_tasks > 0);
  const int len[2] = {
      walk_e ? (T.mixed ? T.cbase : Mp) : 0,
      walk_c ? (T.mixed ? (T.n_cloud_tasks + kBatch - 1) / kBatch * kBatch
                        : Mp)
             : 0};
  const int from[2] = {0, T.mixed ? T.cbase : 0};
  const int chunks[2] = {(len[0] + kChunk - 1) / kChunk,
                         (len[1] + kChunk - 1) / kChunk};
  const int n_iter = max(chunks[0], chunks[1]);
  auto part = [&](int tier, int k) {          // floats of chunk k of a list
    return k < chunks[tier] ? min(kChunk, len[tier] - k * kChunk) : 0;
  };
  auto buf = [&](int tier, int k) {
    return s_buf + (2 * tier + (k & 1)) * kChunk;
  };
  auto list = [&](int tier, int k) {
    return g_t + from[tier] + (size_t)k * kChunk;
  };
  const int ct = tid - kCopyFrom, n_ct = kThreads - kCopyFrom;
  // the tier bits of chunk k (the tree walk's), kChunk / 32 words
  auto copy_bits = [&](int k) {
    const int n = part(0, k) / 32;
    unsigned* dst = s_bits + (k & 1) * (kChunk / 32);
    for (int w = ct; w < n; w += n_ct) dst[w] = R.bits[k * (kChunk / 32) + w];
  };
  if (tid >= kCopyFrom) {                     // chunk 0 of each list
    for (int tier = 0; tier < 2; ++tier)
      cycle_chunk(buf(tier, 0), nullptr, 0, list(tier, 0), part(tier, 0), ct,
                  n_ct);
    if (!T.sorted) copy_bits(0);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  int eid[kE], cid[kC];
#pragma unroll
  for (int j = 0; j < kE; ++j) eid[j] = j;
#pragma unroll
  for (int j = 0; j < kC; ++j) cid[j] = j;
  if (T.sorted & (tid == 0)) sort_loads(e, eid);
  if (T.sorted & (tid == 32)) sort_loads(c, cid);
  for (int k = 0; k < n_iter; ++k) {
    if (T.sorted & (tid == 0) & (k < chunks[0])) {
      walk(buf(0, k), part(0, k), [&](const float* t, int, float* st) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) st[u] = place_sorted(e, eid, t[u]);
      });
    } else if (T.sorted & (tid == 32) & (k < chunks[1])) {
      walk(buf(1, k), part(1, k), [&](const float* t, int, float* st) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) st[u] = place_sorted(c, cid, t[u]);
      });
    } else if ((tid == 0) & !T.sorted) {
      const unsigned* bits_k = s_bits + (k & 1) * (kChunk / 32);
      walk(buf(0, k), part(0, k), [&](const float* t, int i0, float* st) {
        tree_batch(e, c, bits_k[i0 >> 5], t, st);
      });
    } else if (tid >= kCopyFrom) {
      // the other buffer: chunk k-1's starts out, chunk k+1's times in
      for (int tier = 0; tier < 2; ++tier)
        cycle_chunk(buf(tier, k + 1), k >= 1 ? list(tier, k - 1) : nullptr,
                    k >= 1 ? part(tier, k - 1) : 0, list(tier, k + 1),
                    part(tier, k + 1), ct, n_ct);
      if (!T.sorted) copy_bits(k + 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
  }
  // the last chunk's starts out
  for (int tier = 0; tier < 2; ++tier) {
    if (chunks[tier] == n_iter) {
      const int k = n_iter - 1, n = part(tier, k);
      for (int x = 4 * tid; x < n; x += 4 * kThreads)
        *reinterpret_cast<float4*>(list(tier, k) + x) =
            *reinterpret_cast<const float4*>(buf(tier, k) + x);
    }
  }
  __syncthreads();
  scatter_starts(order, start, base, M, R, T);
}

template <int kE, int kC>
int launch_chunked(const void* t_comp, const void* route, const void* order,
                   const void* init, void* start, void* scratch, int R, int M,
                   int n_edge, int n_cloud, cudaStream_t stream) {
  auto kernel = lpt_queue_chunked_kernel<kE, kC>;
  static int opted_in = -1;   // the device whose limit this kernel took
  int dev = 0;
  cudaGetDevice(&dev);
  if (opted_in != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kChunkedSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = dev;
  }
  if (R > 0 && M > 0) {
    kernel<<<R, kThreads, kChunkedSmem, stream>>>(
        (const float*)t_comp, (const int*)route, (const long long*)order,
        (const float*)init, (float*)start, (float*)scratch, M, n_edge,
        n_cloud);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// M past one block's shared memory: the same walk out of scratch, a device
// buffer of R · chunked_scratch_words(M) 4-byte words (16-byte aligned;
// ops.py scratch_words)
extern "C" int lpt_queue_chunked_launch(const void* t_comp, const void* route,
                                        const void* order, const void* init,
                                        void* start, void* scratch, int R,
                                        int M, int n_edge, int n_cloud,
                                        void* stream) {
  if (n_edge < 1 || n_cloud < 1 || n_edge > kMaxTier || n_cloud > kMaxTier ||
      M < 0 || M > (1 << 30) || scratch == nullptr ||
      (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = n_edge == 4 && n_cloud == 1 ? launch_chunked<4, 1>
            : n_edge + n_cloud <= kMaxServers
                ? launch_chunked<kMaxServers - 1, kMaxServers - 1>
                : launch_chunked<kMaxTier, kMaxTier>;
  return fn(t_comp, route, order, init, start, scratch, R, M, n_edge, n_cloud,
            st);
}

// init: (R, n_edge + n_cloud) float32 starting loads, or null for zeros
extern "C" int lpt_queue_launch(const void* t_comp, const void* route,
                                const void* order, const void* init,
                                void* start, int R, int M, int n_edge,
                                int n_cloud, void* stream) {
  if (n_edge < 1 || n_cloud < 1 || n_edge > kMaxTier || n_cloud > kMaxTier) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  // the configuration the port runs (SystemConfig / SimConfig), every other
  // split of up to 8 servers, then up to 16 a tier
  auto fn = n_edge == 4 && n_cloud == 1 ? launch<4, 1>
            : n_edge + n_cloud <= kMaxServers
                ? launch<kMaxServers - 1, kMaxServers - 1>
                : launch<kMaxTier, kMaxTier>;
  return fn(t_comp, route, order, init, start, R, M, n_edge, n_cloud, st);
}
