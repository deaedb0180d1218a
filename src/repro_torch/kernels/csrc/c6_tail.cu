// C6 bandwidth repair: one demotion round's per-task tail (c6_tail_kernel,
// one thread per task), and the whole repair of every round with its
// demotion choice in one block (c6_repair_kernel).  Both call one tail
// function, tail_task, so the two cannot drift apart.
//
// Replaces: src/repro/kernels/c6_tail/kernel.py:c6_tail (Pallas body
// _tail_kernel), which keeps a (256, N·Z) panel tile in VMEM and folds the
// row gathers into one-hot max selects, a TPU workaround for dynamic gathers;
// c6_repair_kernel also replaces the selection around it in
// src/repro/core/router.py:enforce_bandwidth (the budget sum, the stable
// descending argsort, the prefix sum, the demotion and the lax.cond skip of
// dead rounds).
//
// What bounds it on the H100: launch latency and, for c6_repair, its serial
// chain.  Per task the tail reads six 4-byte lane inputs, the current panel
// entry and, only where a demotion is feasible, the demoted entry, and
// writes 12 bytes (at most 44 B, 180 KB at M = 4096: 54 ns at 3.35 TB/s);
// with a_max·sat tabulated once it does about 24 operations.  The repair's
// rounds depend on each other through the budget sum, the sort and the
// prefix sum: a chain of block reductions and barriers per round.
//
// c6_tail: the panel entries are read by direct index (no one-hot select),
// the demoted one only when its demotion is chosen; the N and Z coordinate
// vectors (5 floats each) are read through the read-only cache.  Lanes of a
// warp are neighbouring tasks, so the lane inputs and outputs are coalesced.
// Same float32 operations in the same order as the plain version, compiled
// with -fmad=false: exact on one card.
//
// c6_repair: one block of 1024 threads holds the whole repair for M up to
// kRepairCap tasks (thread t owns tasks t, t + 1024, ...): r and p of every
// task live in shared memory for all rounds, and nothing is read back to the
// host.  A round is one pass over the tasks (the draw, its block sum, the
// tail, and the compaction of the tasks with a positive gain into 64-bit
// keys: the gain's bits inverted above, the task's index and can_p below),
// then, if the repair is still active and over budget, a bitonic sort of the
// keys, an exclusive block scan of the sorted gains and the demotion of the
// prefix whose cumulative gain is short of the excess.  Only tasks with a
// positive gain can be demoted, and in the stable descending order every
// task before them has one too, so their prefix sums are the plain
// version's, summed in another order.  The keys are unique (the index is in
// them), so the sort needs no stability and ties fall in index order
// exactly.  Bitonic, not radix: on the main path the compacted list is
// usually empty (no sort at all) or short, a bitonic network over the next
// power of two has no data-dependent scatter, and its stages whose
// partners lie within 64 keys (57 of the 78 at 4096 keys) run in a warp's
// registers by shuffles, the others through shared memory.  A round that
// finds the repair inactive, within budget or with nothing to demote stops
// the loop and writes its draw for every later round: the reference's
// lax.cond skip, whose rounds leave (r, p) and so the draw unchanged.  An
// alive mask (slot-pool churn; null when every slot is live) makes a dead
// slot's draw and gain 0 in the pass: it adds 0 to its thread's partial sum
// (the order of the sums is unchanged) and never enters the compaction, the
// reference's repair on the compacted alive batch.
//
// c6_repair_cluster_kernel: above kRepairCap the one block's shared memory no
// longer holds the tasks, so one thread block cluster does (Hopper: blocks of a
// cluster run at once on neighbouring SMs and read each other's shared memory).
// What bounds it is the same serial chain, now with a cluster barrier in each
// link, and the sort: a round that demotes sorts up to kClusterTasks keys in
// each block, n·log²n work on 1024 threads.  So the cluster takes
// kClusterBlocks = 16 blocks of 1024 threads whatever M (the non-portable size;
// 8 is the portable one), the most the card schedules with this shared memory
// (cudaOccupancyMaxActiveClusters: 7 such clusters on the H100), so each block
// sorts as few keys as it can: 16 blocks of 8,192 tasks ran the demoting repair
// at M = 131,072 in 0.39–0.46 ms against 0.58–0.68 for 8 of 16,384 (H100 at
// 700 W, in turns, tools/kernel_variants.py).  Block b owns the contiguous tasks
// [b·T, (b+1)·T), T = ⌈M / B⌉ rounded up to 32, with their r, p and keys in its
// own shared memory for all rounds.  A round: each block's pass (the same
// tail_task, draw and compaction as the one-block kernel, its draw summed as
// block_sum sums it); a cluster barrier; every block adds the B draws and key
// counts in block order through distributed shared memory, so all hold the same
// total bit for bit and take the same early stop (the reference's lax.cond
// skip); each block sorts its own keys (bitonic_sort) and scans their gains as
// the one-block kernel does, keeping each key's exclusive prefix (and the
// block's total after the last) for its peers; a cluster barrier; then each
// key's gain before it in the cluster's order is the sum, in block order, of
// its own block's prefix and, for every other block, that block's prefix at the
// key's rank among its sorted keys.  The rank depends on the key's gain alone:
// a peer's keys of an equal gain all sort before it (a lower block's, lower
// indices) or all after (a higher block's).  Gains are differences of one
// 50-entry panel row, so a thread's contiguous ascending keys share few gains:
// each peer's rank is searched once a gain, galloping from the rank of the
// thread's previous gain, and kept for its keys of that gain; a key short of
// the excess demotes its own block's task; a last cluster barrier keeps every
// block's keys alive until its peers have read them.  The sums' order is thus:
// per block the one-block kernel's, then the blocks in order, not torch's: a
// task within the boundary exemption of the excess may be demoted on one side
// only (c6_tail/ref.py repair_boundary), as for the one-block kernel.  No float
// atomics: two launches, and a captured round and its uncaptured twin, give the
// same bits.
// Above kClusterTasks · kMaxClusterBlocks tasks the wrapper takes the
// per-round path (the c6_tail kernel and the selection in torch).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "accuracy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr float kBig = 1e9f;
constexpr int kRepairThreads = 1024;
constexpr int kRepairWarps = kRepairThreads / 32;
constexpr int kRepairCap = 16384;
constexpr int kClusterTasks = 16384;   // tasks a block of the cluster holds
constexpr int kMaxClusterBlocks = 16;  // the non-portable cluster size
constexpr int kClusterBlocks = 16;     // blocks a cluster launch takes
constexpr unsigned kFull = 0xffffffffu;

// one task's current draw, its preferred feasible demotion's gain (-BIG
// when neither the fps nor the resolution demotion stays feasible) and
// whether it is the fps drop; row is the task's (N·Z) panel row
__device__ __forceinline__ void tail_task(const float* __restrict__ row,
                                          int r, int p, float vf, float tf,
                                          float z, float thr,
                                          const float* __restrict__ rn,
                                          const float* __restrict__ pn, int Z,
                                          float& bw, float& gain,
                                          bool& can_p) {
  const int p_dn = p - 1 > 0 ? p - 1 : 0;
  const int r_dn = r - 1 > 0 ? r - 1 : 0;
  bw = __ldg(row + r * Z + p);
  const float f_pdn = accuracy(z, __ldg(rn + r), __ldg(pn + p_dn), vf, tf);
  const float f_rdn = accuracy(z, __ldg(rn + r_dn), __ldg(pn + p), vf, tf);
  can_p = p > 0 && f_pdn >= thr;
  const bool can_r = r > 0 && f_rdn >= thr;
  gain = -kBig;
  if (can_p) {
    gain = bw - __ldg(row + r * Z + p_dn);
  } else if (can_r) {
    gain = bw - __ldg(row + r_dn * Z + p);
  }
}

__global__ void c6_tail_kernel(const float* __restrict__ panel,
                               const int* __restrict__ r_in,
                               const int* __restrict__ p_in,
                               const int* __restrict__ v_in,
                               const int* __restrict__ route_in,
                               const float* __restrict__ z_in,
                               const float* __restrict__ thr_in,
                               const float* __restrict__ rn,
                               const float* __restrict__ pn,
                               float* __restrict__ bw_out,
                               float* __restrict__ gain_out,
                               int* __restrict__ can_p_out, int M, int N,
                               int Z) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= M) return;
  float bw, gain;
  bool can_p;
  tail_task(panel + (size_t)i * N * Z, r_in[i], p_in[i], (float)v_in[i],
            (float)route_in[i], z_in[i], thr_in[i], rn, pn, Z, bw, gain,
            can_p);
  bw_out[i] = bw;
  gain_out[i] = gain;
  can_p_out[i] = can_p ? 1 : 0;
}

// ---------------------------------------------------------------- c6_repair

struct Repair {
  const float* panel;
  const long long *r, *p, *v, *route;
  const float *z, *thr, *rn, *pn, *budget_ptr;
  const unsigned char* alive;   // one bool a task, or null: all alive
  long long *r_out, *p_out;
  float* hist;
  int M, N, Z, rounds;
  float budget;
};

// the sum of v over the block, every thread's partial summed by a butterfly
// in its warp, then the warps' sums by a butterfly in warp 0; every thread
// gets the result
__device__ __forceinline__ float block_sum(float v, float* s_warp,
                                           float* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < kRepairWarps ? s_warp[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(kFull, u, off);
    if (lane == 0) *s_out = u;
  }
  __syncthreads();
  return *s_out;
}

// inclusive Kogge-Stone scan across a warp (each lane adds the value
// `off` lanes below it, off = 1, 2, 4, 8, 16)
__device__ __forceinline__ float warp_scan(float v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = v + y;
  }
  return v;
}

// the exclusive prefix of v over the block's threads in thread order: the
// warp's exclusive scan plus the exclusive scan of the warps' totals
__device__ __forceinline__ float block_exclusive_scan(float v,
                                                      float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float incl = warp_scan(v);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w_incl = warp_scan(lane < kRepairWarps ? s_warp[lane] : 0.0f);
    float w_excl = __shfl_up_sync(kFull, w_incl, 1);
    __syncwarp();
    s_warp[lane] = lane == 0 ? 0.0f : w_excl;
  }
  __syncthreads();
  return s_warp[warp] + excl;
}

__device__ __forceinline__ float key_gain(unsigned long long key) {
  return __uint_as_float(~(unsigned)(key >> 32));
}

// bitonic stages of the sizes size_lo..size_hi (powers of two; strides
// min(size/2, 32) down to 1) on every 64-key window of keys[0, n), in
// registers: lane l holds the window's keys l and l + 32 and exchanges
// with lane l ^ stride by shuffles (stride 32: its own pair).  Keys past n
// (n < 64) are +inf pads, never stored.
__device__ void sort_windows(unsigned long long* keys, int n, int size_lo,
                             int size_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_eff = n < 64 ? 64 : n;
  for (int w0 = warp * 64; w0 < n_eff; w0 += kRepairWarps * 64) {
    const int e0 = w0 + lane, e1 = e0 + 32;
    unsigned long long a = e0 < n ? keys[e0] : ~0ull;
    unsigned long long b = e1 < n ? keys[e1] : ~0ull;
    for (int size = size_lo; size <= size_hi; size <<= 1) {
      for (int stride = size >= 64 ? 32 : size >> 1; stride > 0;
           stride >>= 1) {
        if (stride == 32) {
          const bool up = (e0 & size) == 0;
          const unsigned long long lo = a < b ? a : b, hi = a < b ? b : a;
          a = up ? lo : hi;
          b = up ? hi : lo;
        } else {
          const unsigned long long oa = __shfl_xor_sync(kFull, a, stride);
          const unsigned long long ob = __shfl_xor_sync(kFull, b, stride);
          const bool lower = (lane & stride) == 0;
          const bool min_a = lower == ((e0 & size) == 0);
          const bool min_b = lower == ((e1 & size) == 0);
          a = min_a == (oa < a) ? oa : a;
          b = min_b == (ob < b) ? ob : b;
        }
      }
    }
    if (e0 < n) keys[e0] = a;
    if (e1 < n) keys[e1] = b;
  }
  __syncthreads();
}

// ascending bitonic sort of keys[0, n), n a power of two: the stages whose
// partners lie within a 64-key window in registers (sort_windows), the
// others (stride >= 64) through shared memory, a block barrier each
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  sort_windows(keys, n, 2, 64);
  for (int size = 128; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int q = threadIdx.x; q < n / 2; q += kRepairThreads) {
        const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const unsigned long long a = keys[i], b = keys[j];
        if ((a > b) == up) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
    sort_windows(keys, n, size, size);
  }
}

// one round's pass over the tasks [lo, lo + n), whose r and p are rs[0, n)
// and ps[0, n): each task's draw added to its thread's partial (thread t
// takes tasks t, t + 1024, ... in turn), its tail, and the compaction of
// the tasks with a positive gain into keys (positions from *s_count: the
// gain's bits inverted above, the task's index and can_p below); returns
// the thread's partial draw.  An alive mask (slot-pool churn; null when
// every slot is live) makes a dead slot's draw and gain 0: it adds 0 to its
// thread's partial sum and never enters the compaction
__device__ __forceinline__ float repair_pass(const Repair& a,
                                             const unsigned char* rs,
                                             const unsigned char* ps, int lo,
                                             int n, unsigned long long* keys,
                                             int* s_count) {
  const int tid = threadIdx.x, lane = tid & 31, NZ = a.N * a.Z;
  float part = 0.0f;
  for (int base = 0; base < n; base += kRepairThreads) {
    const int j = base + tid, i = lo + j;
    bool flag = false;
    unsigned long long key = 0;
    if (j < n) {
      float bw, gain;
      bool can_p;
      tail_task(a.panel + (size_t)i * NZ, rs[j], ps[j], (float)a.v[i],
                (float)a.route[i], a.z[i], a.thr[i], a.rn, a.pn, a.Z, bw,
                gain, can_p);
      if (a.alive != nullptr && !a.alive[i]) {
        // a dead slot draws nothing and is never demoted
        bw = 0.0f;
        gain = 0.0f;
      }
      part = part + bw;
      flag = gain > 0.0f;
      key = ((unsigned long long)(~__float_as_uint(gain)) << 32) |
            (unsigned)(i << 1 | (can_p ? 1 : 0));
    }
    const unsigned ballot = __ballot_sync(kFull, flag);
    int pos = 0;
    if (lane == 0 && ballot != 0u) pos = atomicAdd(s_count, __popc(ballot));
    pos = __shfl_sync(kFull, pos, 0);
    if (flag) keys[pos + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
  return part;
}

// this thread's run [q0, q1) of the count sorted keys (contiguous runs of
// ⌈count/1024⌉) and the gain of every key before the run: the runs' sums,
// each from 0, scanned across the block
__device__ __forceinline__ float key_run(const unsigned long long* keys,
                                         int count, float* s_warp, int& q0,
                                         int& q1) {
  const int per = (count + kRepairThreads - 1) / kRepairThreads;
  q0 = threadIdx.x * per < count ? threadIdx.x * per : count;
  q1 = q0 + per < count ? q0 + per : count;
  float chunk = 0.0f;
  for (int q = q0; q < q1; ++q) chunk = chunk + key_gain(keys[q]);
  return block_exclusive_scan(chunk, s_warp);
}

__global__ void __launch_bounds__(kRepairThreads)
    c6_repair_kernel(const Repair a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_warp[32], s_sum;
  __shared__ int s_count;
  const int M = a.M;
  int n_keys = 1;
  while (n_keys < M) n_keys <<= 1;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned char* rs = smem_raw + sizeof(unsigned long long) * n_keys;
  unsigned char* ps = rs + M;
  const int tid = threadIdx.x;

  for (int i = tid; i < M; i += kRepairThreads) {
    rs[i] = (unsigned char)a.r[i];
    ps[i] = (unsigned char)a.p[i];
  }
  if (tid == 0) s_count = 0;
  const float budget = a.budget_ptr != nullptr ? *a.budget_ptr : a.budget;
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    // the draw, its sum, the tail and the compaction, in one pass
    const float part = repair_pass(a, rs, ps, 0, M, keys, &s_count);
    const float total = block_sum(part, s_warp, &s_sum);
    const int count = s_count;
    const float excess = total - budget;
    const float drawn = excess + budget;
    if (tid == 0) a.hist[round] = drawn;
    if (!(excess > 0.0f) || count == 0) {
      // nothing changes any more: every later round draws the same
      for (int k = round + 1 + tid; k < a.rounds; k += kRepairThreads) {
        a.hist[k] = drawn;
      }
      break;
    }
    int n = 1;
    while (n < count) n <<= 1;
    for (int q = count + tid; q < n; q += kRepairThreads) keys[q] = ~0ull;
    __syncthreads();
    bitonic_sort(keys, n);
    if (tid == 0) s_count = 0;      // every thread read it before the sort

    // exclusive scan of the sorted gains over contiguous chunks
    int q0, q1;
    float cum = key_run(keys, count, s_warp, q0, q1);
    for (int q = q0; q < q1; ++q) {
      const unsigned long long key = keys[q];
      if (cum < excess) {
        const int i = (int)((unsigned)key >> 1);
        if (key & 1ull) {
          ps[i] = ps[i] > 0 ? ps[i] - 1 : 0;
        } else {
          rs[i] = rs[i] > 0 ? rs[i] - 1 : 0;
        }
      }
      cum = cum + key_gain(key);
    }
    __syncthreads();
  }
  for (int i = tid; i < M; i += kRepairThreads) {
    a.r_out[i] = rs[i];
    a.p_out[i] = ps[i];
  }
}

size_t repair_smem(int M) {
  size_t n_keys = 1;
  while (n_keys < (size_t)M) n_keys <<= 1;
  return sizeof(unsigned long long) * n_keys + 2 * (size_t)M;
}

// -------------------------------------------------------- c6_repair, cluster

// the count of peer keys below key, at least pos of them known to be: a
// galloping search (steps 1, 2, 4, ... while they stay below, then halving)
__device__ __forceinline__ int rank_from(const unsigned long long* peer,
                                         int n, int pos,
                                         unsigned long long key) {
  int step = 1;
  while (pos + step <= n && peer[pos + step - 1] < key) {
    pos += step;
    step <<= 1;
  }
  for (step >>= 1; step > 0; step >>= 1) {
    if (pos + step <= n && peer[pos + step - 1] < key) pos += step;
  }
  return pos;
}

// one block of the cluster: tasks [b·T, b·T + T) ∩ [0, M)
__global__ void __launch_bounds__(kRepairThreads)
    c6_repair_cluster_kernel(const Repair a, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_warp[32], s_sum, s_draw;
  __shared__ int s_count, s_keys;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank(), B = (int)cluster.num_blocks();
  const int M = a.M;
  const int lo = b * T, n_own = min(M - lo, T);
  int n_keys = 1;
  while (n_keys < T) n_keys <<= 1;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);
  float* pre = reinterpret_cast<float*>(keys + n_keys);  // (T + 1,)
  unsigned char* rs = reinterpret_cast<unsigned char*>(pre + T + 1);
  unsigned char* ps = rs + T;
  const int tid = threadIdx.x;

  for (int j = tid; j < n_own; j += kRepairThreads) {
    rs[j] = (unsigned char)a.r[lo + j];
    ps[j] = (unsigned char)a.p[lo + j];
  }
  if (tid == 0) s_count = 0;
  const float budget = a.budget_ptr != nullptr ? *a.budget_ptr : a.budget;
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    // this block's draw, tail and compaction, as the one-block kernel's
    const float part = repair_pass(a, rs, ps, lo, n_own, keys, &s_count);
    const float own = block_sum(part, s_warp, &s_sum);
    if (tid == 0) {
      s_draw = own;
      s_keys = s_count;
    }
    cluster.sync();                  // every block's draw and keys counted
    float total = 0.0f;
    int count_all = 0;
    for (int c = 0; c < B; ++c) {    // in block order, the same everywhere
      const float d = *cluster.map_shared_rank(&s_draw, c);
      total = c == 0 ? d : total + d;
      count_all += *cluster.map_shared_rank(&s_keys, c);
    }
    const int count = s_keys;
    const float excess = total - budget;
    const float drawn = excess + budget;
    if (b == 0 && tid == 0) a.hist[round] = drawn;
    if (!(excess > 0.0f) || count_all == 0) {
      if (b == 0) {
        for (int k = round + 1 + tid; k < a.rounds; k += kRepairThreads) {
          a.hist[k] = drawn;
        }
      }
      cluster.sync();                // peers done reading the counts
      break;
    }
    int n_pad = 1;
    while (n_pad < count) n_pad <<= 1;
    for (int q = count + tid; q < n_pad; q += kRepairThreads) keys[q] = ~0ull;
    __syncthreads();
    bitonic_sort(keys, n_pad);
    if (tid == 0) s_count = 0;

    // this block's exclusive prefix of its sorted gains, as the one-block
    // kernel's, kept for its peers, and its total after the last key
    int q0, q1;
    float cum = key_run(keys, count, s_warp, q0, q1);
    for (int q = q0; q < q1; ++q) {
      pre[q] = cum;
      cum = cum + key_gain(keys[q]);
    }
    if (q0 < q1 && q1 == count) pre[count] = cum;
    if (count == 0 && tid == 0) pre[0] = 0.0f;
    cluster.sync();                  // every block's keys sorted, prefixes kept

    // each key's gain before it in the cluster's order: the blocks'
    // prefixes at its rank, in block order
    int at[kMaxClusterBlocks] = {};
    float term[kMaxClusterBlocks];
    unsigned gain_bits = 0u;         // no key's upper word (gains are > 0)
    for (int q = q0; q < q1; ++q) {
      const unsigned long long key = keys[q];
      if ((unsigned)(key >> 32) != gain_bits) {   // a new gain: its ranks
        gain_bits = (unsigned)(key >> 32);
        for (int c = 0; c < B; ++c) {
          if (c == b) continue;
          at[c] = rank_from(cluster.map_shared_rank(keys, c),
                            *cluster.map_shared_rank(&s_keys, c), at[c], key);
          term[c] = *cluster.map_shared_rank(pre + at[c], c);
        }
      }
      float before = 0.0f;
      for (int c = 0; c < B; ++c) {
        const float t = c == b ? pre[q] : term[c];
        before = c == 0 ? t : before + t;
      }
      if (before < excess) {
        const int j = (int)((unsigned)key >> 1) - lo;
        if (key & 1ull) {
          ps[j] = ps[j] > 0 ? ps[j] - 1 : 0;
        } else {
          rs[j] = rs[j] > 0 ? rs[j] - 1 : 0;
        }
      }
    }
    cluster.sync();                  // peers done reading this block's keys
  }
  for (int j = tid; j < n_own; j += kRepairThreads) {
    a.r_out[lo + j] = rs[j];
    a.p_out[lo + j] = ps[j];
  }
}

// a cluster block's dynamic shared memory for T tasks: the keys (the next
// power of two), the prefixes (T + 1 floats), r and p
size_t cluster_smem(int T) {
  size_t n_keys = 1;
  while (n_keys < (size_t)T) n_keys <<= 1;
  return sizeof(unsigned long long) * n_keys + 4 * ((size_t)T + 1) +
         2 * (size_t)T;
}

// the cluster's blocks for M tasks (kClusterBlocks, or more where their
// shared memory would not hold M) and the tasks each holds
void cluster_shape(int M, int& blocks, int& tasks) {
  const int need = (M + kClusterTasks - 1) / kClusterTasks;
  blocks = need > kClusterBlocks ? need : kClusterBlocks;
  tasks = ((M + blocks - 1) / blocks + 31) / 32 * 32;
}

// the launch attributes of the cluster kernel, once per device
cudaError_t cluster_opt_in() {
  static int opted_in = -1;   // the device whose limit this kernel took
  int dev = 0;
  cudaGetDevice(&dev);
  if (opted_in == dev) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      c6_repair_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cluster_smem(kClusterTasks));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(c6_repair_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  }
  if (e == cudaSuccess) opted_in = dev;
  return e;
}

cudaLaunchConfig_t cluster_config(int blocks, int tasks, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kRepairThreads, 1, 1);
  cfg.dynamicSmemBytes = cluster_smem(tasks);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int c6_tail_launch(const void* panel, const void* r, const void* p,
                              const void* v, const void* route, const void* z,
                              const void* acc_thr, const void* rn,
                              const void* pn, void* bw, void* gain,
                              void* can_p, int M, int N, int Z, void* stream) {
  if (M % kBlock != 0 || N < 1 || Z < 1) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    c6_tail_kernel<<<M / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
        (const float*)panel, (const int*)r, (const int*)p, (const int*)v,
        (const int*)route, (const float*)z, (const float*)acc_thr,
        (const float*)rn, (const float*)pn, (float*)bw, (float*)gain,
        (int*)can_p, M, N, Z);
  }
  return (int)cudaGetLastError();
}

// budget: a device pointer to one float, or null to take budget_value;
// alive: a device pointer to M bools (a slot pool's alive mask), or null.
// M <= kRepairCap: one block; up to kClusterTasks · kMaxClusterBlocks: one
// cluster
extern "C" int c6_repair_launch(const void* panel, const void* r,
                                const void* p, const void* v,
                                const void* route, const void* z,
                                const void* acc_thr, const void* rn,
                                const void* pn, const void* budget,
                                const void* alive, void* r_out, void* p_out,
                                void* hist, int M, int N, int Z, int rounds,
                                float budget_value, void* stream) {
  if (M < 0 || M > kClusterTasks * kMaxClusterBlocks || N < 1 || N > 256 ||
      Z < 1 || Z > 256 || rounds < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Repair a{(const float*)panel, (const long long*)r,
                 (const long long*)p, (const long long*)v,
                 (const long long*)route, (const float*)z,
                 (const float*)acc_thr, (const float*)rn, (const float*)pn,
                 (const float*)budget, (const unsigned char*)alive,
                 (long long*)r_out, (long long*)p_out, (float*)hist, M, N, Z,
                 rounds, budget_value};
  if (M > kRepairCap) {              // one cluster launch
    const cudaError_t e = cluster_opt_in();
    if (e != cudaSuccess) return (int)e;
    int blocks = 0, tasks = 0;
    cluster_shape(M, blocks, tasks);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(blocks, tasks, (cudaStream_t)stream, attr);
    const cudaError_t le =
        cudaLaunchKernelEx(&cfg, c6_repair_cluster_kernel, a, tasks);
    if (le != cudaSuccess) return (int)le;
    return (int)cudaGetLastError();
  }
  static int opted_in = -1;   // the device whose limit this kernel took
  int dev = 0;
  cudaGetDevice(&dev);
  if (opted_in != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        c6_repair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)repair_smem(kRepairCap));
    if (e != cudaSuccess) return (int)e;
    opted_in = dev;
  }
  c6_repair_kernel<<<1, kRepairThreads, repair_smem(M),
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// clusters of `blocks` full blocks (kClusterTasks tasks each) the device can
// hold at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error
extern "C" int c6_repair_max_clusters(int blocks) {
  cudaError_t e = cluster_opt_in();
  int n = 0;
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(blocks, kClusterTasks, nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(&n, c6_repair_cluster_kernel, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}
