// Decode attention: one query token per batch row against that row's KV
// cache, GQA, masked at a per-row length — the cache split across the
// blocks of one thread block cluster (flash-decoding), combined through
// distributed shared memory.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:decode_attention
// (Pallas body _decode_kernel), whose grid walks (B·KV, cache tiles) in
// order on one TPU core, keeps the online-softmax state (m, l, acc) in VMEM
// scratch across the tiles and skips the tiles past `length`.
//
// What bounds it on the H100: bytes, and at the serving slabs the latency
// of the trips to device memory.  Each (row, KV head) reads its first
// `length` cache entries of K and V once (2·length·D values) for 4·G·D
// operations per entry: about one operation per byte in bf16, far below
// the ~295 at which the tensor cores would bound it.  At the serving slab
// (B = 16, S = 144, Qwen3-8B's KV = 8, D = 128) a full cache is 9.4 MB per
// layer per step, ~2.8 µs at 3.35 TB/s; one block per (row, KV head) gave
// 128 blocks for 132 SMs, each walking its cache in dependent trips.
//
// Design: the grid is (splits, B·KV) with a cluster of `splits` (<= 8)
// blocks along x per (row, KV head); the wrapper chooses `splits` (about
// two blocks an SM, chunks of at least 16 entries).  Split i owns cache
// entries [i·chunk, (i+1)·chunk) ∩ [0, length), chunk = ceil(S / splits).
// A block starts every 16-byte cp.async of its chunk's K and then V at once
// (up to 64 KB of them; a longer chunk is staged in turns) and works through
// the staged entries in tiles of 32 with an online softmax across them.
// Softmax: one warp per query row, float32, scores in base 2 (scale·log2 e,
// so each exponential is one exp2), the split's own max; each probability
// is rounded to the value type for P·V, as the TPU kernel does (relative to
// the split's max here), and l sums the unrounded ones.  Products: aligned
// bf16 at D = 64, 128, 256 (the tiers' head dims) runs Q·Kᵀ and P·V on the
// tensor cores (decode_attention_kernel_mma below); every other input on the
// CUDA cores: L lanes hold one entry's D in 16-byte pieces (L = D/8 in bf16,
// at most 32), a warp scores 32/L entries at a time for all G rows, the L
// lanes' partial dots summed by shuffles, and threads own (row, piece)
// items of P·V, summed over a tile's entries in float32.  Combine: each
// block leaves its (m, l, acc) in its shared memory, the cluster syncs, and
// block r reads every split's partials through distributed shared memory
// for every splits-th output piece, adding them in split order (m = max mᵢ,
// l = Σ lᵢ·2^(mᵢ−m), acc = Σ accᵢ·2^(mᵢ−m)), so the result is the same from
// run to run; it stores acc / max(l, 1e-30) in 16-byte pieces; a second
// cluster sync keeps each block's shared memory alive until its peers have
// read it.  One launch, no global scratch, no atomics.  An empty split
// (past the row's length) leaves m = -1e30, l = 0, acc = 0, which the
// combine weighs to nothing; a row of length 0 gives zeros.  The caches are
// read by strides (only D is contiguous), so the model's (B, S, KV, D) slab
// is read in place.  Rows whose starts are not 16-byte aligned (or
// D·sizeof(T) not a multiple of 16) take the CUDA cores' generic
// instantiation: 4-byte pieces.  No product or shuffle sits under a branch:
// rows past G, items past G·D and key pieces past D repeat a valid one and
// are not stored (branches around them compiled to reconvergence barriers
// that cost more than the work).  Products run as explicit fused
// multiply-adds (the repository builds with -fmad=false); the kernel is
// held to a stated tolerance, not to the plain version's bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;       // entries scored at once: a lane each
constexpr int kStageBytes = 64 * 1024;  // K and V staged at once, at most
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kKeyFloats = 8;   // key values a lane holds while scoring
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Shared memory of one block, byte offsets: the staged K and V entries (as
// T), the query rows as float (then the block's P·V sums), the scores of a
// tile (then its rounded probabilities), and per query row the split's
// running max, sum and the last tile's correction.
struct Layout {
  int k, v, q, s, m, l, corr, total;
};

__host__ __device__ inline Layout make_layout(int G, int D, int tile,
                                              int elem_bytes) {
  Layout o;
  const int kv = (tile * D * elem_bytes + 15) / 16 * 16;
  o.k = 0;
  o.v = kv;
  o.q = 2 * kv;
  o.s = o.q + (G * D * 4 + 15) / 16 * 16;
  o.m = o.s + kMaxGroup * kTile * 4;
  o.l = o.m + kMaxGroup * 4;
  o.corr = o.l + kMaxGroup * 4;
  o.total = o.corr + kMaxGroup * 4;
  return o;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// kVec neighbouring values of T (one piece: 16 bytes, or 4 on the generic
// path) as float, from shared or global memory
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float* x) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (kVec % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kVec / 4; ++i) {
        const float4 a = reinterpret_cast<const float4*>(p)[i];
        x[4 * i] = a.x;
        x[4 * i + 1] = a.y;
        x[4 * i + 2] = a.z;
        x[4 * i + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = p[e];
    }
  } else {
    if constexpr (kVec == 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i) {
        const float2 f = Elem<T>::load2(p + 2 * i);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float* x) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) p[e] = x[e];
    }
  } else {
    if constexpr (kVec == 8) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec / 2; ++i)
        Elem<T>::store2(p + 2 * i, x[2 * i], x[2 * i + 1]);
    }
  }
}

// The cluster's combine: every block has left its split's (m, l) per row in
// m_s / l_s and its P·V sums, (G, D) float, in acc_s; block `split` adds
// every splits-th output piece of kVec values over the splits, in split
// order, and stores acc / max(l, 1e-30) into out (B, H, D)
template <typename T, int kVec>
__device__ __forceinline__ void combine_store(float* m_s, float* l_s,
                                              float* acc_s, T* out, int b,
                                              int kh, int H, int G, int D) {
  const int split = blockIdx.x, splits = gridDim.x, tid = threadIdx.x;
  const int C = D / kVec;
  cg::cluster_group cluster = cg::this_cluster();
  auto peer = [&](float* p, int r) { return cluster.map_shared_rank(p, r); };
  cluster.sync();                            // every split's partials ready

  // block `split` combines every splits-th output piece, in split order
  for (int o = split + splits * tid; o < G * C; o += splits * kThreads) {
    const int g = o / C, c = o % C;
    float m_i[kMaxSplits];
    float m = kAttnNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        m_i[r] = *peer(m_s + g, r);
        m = fmaxf(m, m_i[r]);
      }
    }
    float l = 0.0f, y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        const float w = exp2f(m_i[r] - m);
        l = __fmaf_rn(*peer(l_s + g, r), w, l);
        float a[kVec];
        load_vec<float, kVec>(peer(acc_s + g * D + c * kVec, r), a);
#pragma unroll
        for (int e = 0; e < kVec; ++e) y[e] = __fmaf_rn(a[e], w, y[e]);
      }
    }
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] *= inv_l;
    store_vec<T, kVec>(out + ((long long)b * H + kh * G + g) * D + c * kVec, y);
  }
  cluster.sync();                            // peers done reading this block
}

// kVec: values of T per piece, 16 bytes on the aligned path (8 bf16, 4
// float), 4 bytes on the generic one (a bf16 pair, one float)
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ length, T* __restrict__ out,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb,
                            long long v_sh, long long v_ss, int H, int KV,
                            int S, int D, int stage, float scale) {
  constexpr int kBytes = kVec * (int)sizeof(T);
  // (row, piece) items a thread: G·D/kVec over the block, at least one
  constexpr int kItems = (kMaxGroup * kMaxD / kVec + kThreads - 1) / kThreads;
  constexpr int kPieces = kKeyFloats / kVec;  // key pieces a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV, C = D / kVec;         // C pieces per row
  const Layout lay = make_layout(G, D, stage, sizeof(T));
  T* k_s = reinterpret_cast<T*>(smem + lay.k);
  T* v_s = reinterpret_cast<T*>(smem + lay.v);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* corr_s = reinterpret_cast<float*>(smem + lay.corr);

  // scores in base 2: s·log2(e), so exp(s - m) is one exp2
  const float scale2 = scale * 1.4426950408889634f;
  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y / KV, kh = blockIdx.y % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(length[b], 0), S);
  const int chunk = (S + splits - 1) / splits;
  const int c0 = split * chunk, c1 = min(c0 + chunk, len);
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // every copy of a stage started at once: K (one group), then V (another)
  auto copy_stage = [&](int t0, int n) {
    for (int i = tid; i < n * C; i += kThreads) {
      const int j = i / C, c = i % C;
      cp_async<kBytes>(k_s + j * D + c * kVec, kb + (t0 + j) * k_ss + c * kVec);
    }
    cp_async_commit();
    for (int i = tid; i < n * C; i += kThreads) {
      const int j = i / C, c = i % C;
      cp_async<kBytes>(v_s + j * D + c * kVec, vb + (t0 + j) * v_ss + c * kVec);
    }
    cp_async_commit();
  };
  if (c0 < c1) {
    copy_stage(c0, min(stage, c1 - c0));
    for (int i = tid; i < G * C; i += kThreads) {
      const int g = i / C, c = i % C;
      load_vec<T, kVec>(q + b * q_sb + (kh * G + g) * q_sh + c * kVec,
                        q_s + g * D + c * kVec);
    }
  }
  if (tid < G) {
    m_s[tid] = kAttnNegInf;
    l_s[tid] = 0.0f;
  }

  float acc[kItems][kVec];
#pragma unroll
  for (int it = 0; it < kItems; ++it)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[it][e] = 0.0f;

  // scoring: L lanes per entry (C if it is a power of two up to 32)
  const int L = C <= 32 && (C & (C - 1)) == 0 ? C : 32;
  const int per_warp = 32 / L, sub = lane / L, li = lane % L;

  for (int t0 = c0; t0 < c1; t0 += stage) {
    const int n_stage = min(stage, c1 - t0);
    cp_async_wait<1>();                      // this stage's K arrived
    __syncthreads();
    bool v_ready = false;
    // the stage in tiles of up to 32 entries, an online softmax across them
    for (int s0 = 0; s0 < n_stage; s0 += kTile) {
      const int n = min(kTile, n_stage - s0);
      const T* k_t = k_s + s0 * D;
      const T* v_t = v_s + s0 * D;
      for (int j0 = warp * per_warp; j0 < n; j0 += kWarps * per_warp) {
        const int j = j0 + sub;
        // key pieces past the row or the tile are zero, their query reads
        // clamped in range: no branch around the products or the shuffles
        float kf[kPieces][kVec];
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          const int c = li + L * i;
          if ((j < n) & (c < C)) {
            load_vec<T, kVec>(k_t + j * D + c * kVec, kf[i]);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) kf[i][e] = 0.0f;
          }
        }
        // every row's partial dot first, then their L-lane sums side by
        // side; rows past G repeat row G - 1 and are not stored
        float dot[kMaxGroup];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          const int row = min(g, G - 1);
          dot[g] = 0.0f;
#pragma unroll
          for (int i = 0; i < kPieces; ++i) {
            const int c = min(li + L * i, C - 1);
            float qv[kVec];
            load_vec<float, kVec>(q_s + row * D + c * kVec, qv);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              dot[g] = __fmaf_rn(qv[e], kf[i][e], dot[g]);
          }
        }
        for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        }
        if ((li == 0) & (j < n)) {
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < G) s_s[g * kTile + j] = dot[g] * scale2;
        }
      }
      if (!v_ready) {
        cp_async_wait<0>();                  // and the stage's V
        v_ready = true;
      }
      __syncthreads();
#pragma unroll
      for (int gi = 0; gi < kMaxGroup / kWarps; ++gi) {
        // row g = warp + kWarps·gi; a warp past G repeats row G - 1,
        // unstored
        const int g = min(warp + kWarps * gi, G - 1);
        const bool mine = warp + kWarps * gi < G;
        const float sc = lane < n ? s_s[g * kTile + lane] : kAttnNegInf;
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, warp_max(sc));
        const float p = lane < n ? exp2f(sc - m_new) : 0.0f;
        const float sum = warp_sum(p);
        if (mine & (lane < n)) s_s[g * kTile + lane] = Elem<T>::round(p);
        if (mine & (lane == 0)) {
          const float corr = exp2f(m_prev - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        // items past G·C repeat the last one and are never stored
        const int item = min(tid + kThreads * it, G * C - 1);
        const int g = item / C, c = item % C;
        const float corr = corr_s[g];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[it][e] *= corr;
        const float* p_row = s_s + g * kTile;
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          float vv[kVec];
          load_vec<T, kVec>(v_t + j * D + c * kVec, vv);
          const float p = p_row[j];
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[it][e] = __fmaf_rn(p, vv[e], acc[it][e]);
        }
      }
      __syncthreads();                       // the tile's scores are free
    }
    if (t0 + stage < c1) copy_stage(t0 + stage, min(stage, c1 - t0 - stage));
  }

  // this split's P·V sums into q_s, for the cluster to read
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + kThreads * it;
    if (item < G * C) {
      const int g = item / C, c = item % C;
#pragma unroll
      for (int e = 0; e < kVec; ++e) q_s[g * D + c * kVec + e] = acc[it][e];
    }
  }
  combine_store<T, kVec>(m_s, l_s, q_s, out, b, kh, H, G, D);
}

// ----------------------------------------- bfloat16 on the tensor cores
//
// The aligned bf16 path at D = 64, 128, 256: the same splits, stages, tiles,
// softmax and combine, with Q·Kᵀ and P·V as mma.sync m16n8k16 (bf16
// operands, float32 sums): the G <= 16 query rows are the 16 rows of the A
// operand (zero past G).  Scores: warp w takes entries 8w..8w+7 of a tile,
// Q and K fragments by ldmatrix from rows padded by 16 bytes.  P·V: the
// rounded probabilities, read back from shared memory, are the A operand
// (16 entries a step), V fragments by ldmatrix.trans; warp w owns D/4
// output columns.  Staged rows past the chunk are zero-filled, so padded
// entries add 0 · 0.

constexpr int kPad = 8;            // bf16 padding (16 bytes) of a shared row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; with in == false the 16 bytes are zero-filled
// (src-size 0) and src is not read
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 × 8, float32) += a (16 × 16, bf16, row) · b (16 × 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats (already bf16 values) as a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of the tensor-core kernel, byte offsets: Q's 16 rows and
// the staged K and V entries (bf16, rows padded), the split's P·V sums
// ((G, D) float, for the cluster), a tile's scores, then per row m, l and
// the tile's correction
struct MmaLayout {
  int q, k, v, acc, s, m, l, corr, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int G, int D,
                                                     int stage_rows) {
  const int row = (D + kPad) * 2;
  MmaLayout o;
  o.q = 0;
  o.k = 16 * row;
  o.v = o.k + stage_rows * row;
  o.acc = o.v + stage_rows * row;
  o.s = o.acc + (G * D * 4 + 15) / 16 * 16;
  o.m = o.s + kMaxGroup * kTile * 4;
  o.l = o.m + kMaxGroup * 4;
  o.corr = o.l + kMaxGroup * 4;
  o.total = o.corr + kMaxGroup * 4;
  return o;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel_mma(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
        __nv_bfloat16* __restrict__ out, long long q_sb, long long q_sh,
        long long k_sb, long long k_sh, long long k_ss, long long v_sb,
        long long v_sh, long long v_ss, int H, int KV, int S, int stage,
        float scale) {
  constexpr int LD = D + kPad, kChunks = D / 8;
  constexpr int kFrags = D / 8 / kWarps;    // 8-column output fragments a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int stage_rows = (stage + kTile - 1) / kTile * kTile;
  const MmaLayout lay = make_mma_layout(G, D, stage_rows);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.v);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* corr_s = reinterpret_cast<float*>(smem + lay.corr);

  const float scale2 = scale * 1.4426950408889634f;   // base-2 scores
  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y / KV, kh = blockIdx.y % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(length[b], 0), S);
  const int chunk = (S + splits - 1) / splits;
  const int c0 = split * chunk, c1 = min(c0 + chunk, len);
  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;

  // a stage's K (one group, with Q on the first) and V (another), its rows
  // rounded up to whole tiles, zero past n
  auto copy_stage = [&](int t0, int n) {
    const int rows = (n + kTile - 1) / kTile * kTile;
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      cp_async16z(k_s + j * LD + c * 8, j < n ? kb + (t0 + j) * k_ss + c * 8 : kb,
                  j < n);
    }
    cp_async_commit();
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      cp_async16z(v_s + j * LD + c * 8, j < n ? vb + (t0 + j) * v_ss + c * 8 : vb,
                  j < n);
    }
    cp_async_commit();
  };
  if (c0 < c1) {
    for (int i = tid; i < 16 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      cp_async16z(q_s + r * LD + c * 8,
                  r < G ? q + b * q_sb + (kh * G + r) * q_sh + c * 8 : q,
                  r < G);
    }
    copy_stage(c0, min(stage, c1 - c0));
  }
  for (int i = tid; i < kMaxGroup * kTile; i += kThreads) s_s[i] = 0.0f;
  if (tid < kMaxGroup) {
    m_s[tid] = kAttnNegInf;
    l_s[tid] = 0.0f;
    corr_s[tid] = 0.0f;
  }

  // this lane's rows gq and gq + 8 of a fragment, its columns 2·tq, 2·tq+1;
  // ldmatrix: matrix mi, row mr
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, mr = lane & 7;
  const uint32_t q_row =
      smem_addr(q_s + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
  float o[kFrags][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[f][e] = 0.0f;

  for (int t0 = c0; t0 < c1; t0 += stage) {
    const int n_stage = min(stage, c1 - t0);
    cp_async_wait<1>();                      // Q and this stage's K arrived
    __syncthreads();
    bool v_ready = false;
    for (int s0 = 0; s0 < n_stage; s0 += kTile) {
      const int n = min(kTile, n_stage - s0);
      // scores of entries s0 + 8·warp .. + 7 for the 16 rows
      if (8 * warp < n) {
        const __nv_bfloat16* kt = k_s + (s0 + 8 * warp) * LD;
        float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          uint32_t bk[4], a[4];       // K: d of steps kk and kk + 1
          ldmatrix_x4(bk, smem_addr(kt + mr * LD + kk * 16 + mi * 8));
          ldmatrix_x4(a, q_row + kk * 16 * 2);
          mma_bf16(sc, a, bk[0], bk[1]);
          ldmatrix_x4(a, q_row + (kk + 1) * 16 * 2);
          mma_bf16(sc, a, bk[2], bk[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gq + 8 * (e >> 1);
          if (row < G)
            s_s[row * kTile + 8 * warp + 2 * tq + (e & 1)] = sc[e] * scale2;
        }
      }
      if (!v_ready) {
        cp_async_wait<0>();                  // and the stage's V
        v_ready = true;
      }
      __syncthreads();
      for (int gi = 0; gi * kWarps < G; ++gi) {   // the same count in every warp
        const int g = min(warp + kWarps * gi, G - 1);
        const bool mine = warp + kWarps * gi < G;
        const float sc = lane < n ? s_s[g * kTile + lane] : kAttnNegInf;
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, warp_max(sc));
        const float p = lane < n ? exp2f(sc - m_new) : 0.0f;
        const float sum = warp_sum(p);
        if (mine) s_s[g * kTile + lane] = Elem<__nv_bfloat16>::round(p);
        if (mine & (lane == 0)) {
          const float corr = exp2f(m_prev - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // O = O·corr + P·V over the warp's output fragments
      const float corr_lo = corr_s[gq], corr_hi = corr_s[gq + 8];
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        o[f][0] *= corr_lo;
        o[f][1] *= corr_lo;
        o[f][2] *= corr_hi;
        o[f][3] *= corr_hi;
      }
      const __nv_bfloat16* vt = v_s + s0 * LD;
      for (int kc = 0; kc * 16 < n; ++kc) {
        const float* p_lo = s_s + gq * kTile + kc * 16 + 2 * tq;
        const float* p_hi = p_lo + 8 * kTile;
        const uint32_t a[4] = {pack_bf16(p_lo[0], p_lo[1]),
                               pack_bf16(p_hi[0], p_hi[1]),
                               pack_bf16(p_lo[8], p_lo[9]),
                               pack_bf16(p_hi[8], p_hi[9])};
        const uint32_t v_row = smem_addr(
            vt + (kc * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
#pragma unroll
        for (int f = 0; f < kFrags; f += 2) {
          uint32_t bv[4];   // columns of fragments f and f + 1, entries lo/hi
          ldmatrix_x4_trans(bv, v_row + (warp * kFrags + f) * 8 * 2);
          mma_bf16(o[f], a, bv[0], bv[1]);
          mma_bf16(o[f + 1], a, bv[2], bv[3]);
        }
      }
      __syncthreads();                       // the tile's scores are free
    }
    if (t0 + stage < c1) copy_stage(t0 + stage, min(stage, c1 - t0 - stage));
  }

  // this split's P·V sums, rows < G, for the cluster to read
#pragma unroll
  for (int f = 0; f < kFrags; ++f) {
    const int col = (warp * kFrags + f) * 8 + 2 * tq;
    if (gq < G) {
      acc_s[gq * D + col] = o[f][0];
      acc_s[gq * D + col + 1] = o[f][1];
    }
    if (gq + 8 < G) {
      acc_s[(gq + 8) * D + col] = o[f][2];
      acc_s[(gq + 8) * D + col + 1] = o[f][3];
    }
  }
  combine_store<__nv_bfloat16, 8>(m_s, l_s, acc_s, out, b, kh, H, G, D);
}

// one launch of `kernel` on a (splits, bkv) grid, each (row, KV head)'s
// `splits` blocks one thread block cluster along x
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int splits, int bkv,
                    int threads, int smem, cudaStream_t stream,
                    Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, bkv, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const void* length, void* out, long long q_sb, long long q_sh,
               long long k_sb, long long k_sh, long long k_ss, long long v_sb,
               long long v_sh, long long v_ss, int B, int H, int KV, int S,
               int splits, float scale, cudaStream_t stream) {
  const int chunk = (S + splits - 1) / splits;
  const int stage =
      min(chunk, max(kTile, kStageBytes / (4 * (D + kPad)) / kTile * kTile));
  const MmaLayout lay = make_mma_layout(H / KV, D,
                                        (stage + kTile - 1) / kTile * kTile);
  return launch_clusters(
      decode_attention_kernel_mma<D>, splits, B * KV, kThreads, lay.total,
      stream,
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)length, (__nv_bfloat16*)out, q_sb,
      q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, H, KV, S, stage, scale);
}

template <typename T, int kVec>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, long long q_sb, long long q_sh, long long k_sb,
           long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, int B, int H, int KV, int S, int D, int splits,
           float scale, cudaStream_t stream) {
  // a split's whole chunk staged at once where 64 KB of K and V hold it
  const int chunk = (S + splits - 1) / splits;
  const int stage = min(chunk, max(kTile, kStageBytes / (2 * D * (int)sizeof(T))));
  const Layout lay = make_layout(H / KV, D, stage, sizeof(T));
  return launch_clusters(
      decode_attention_kernel<T, kVec>, splits, B * KV, kThreads, lay.total,
      stream, (const T*)q, (const T*)k,
      (const T*)v, (const int*)length, (T*)out, q_sb, q_sh, k_sb, k_sh, k_ss,
      v_sb, v_sh, v_ss, H, KV, S, D, stage, scale);
}

// every row start of q, k, v (pointer and strides) and D on 16 bytes
bool aligned16(const void* q, const void* k, const void* v,
               const long long* strides, int n, int D, int elem_bytes) {
  if ((D * elem_bytes) % 16 || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
      (uintptr_t)v % 16)
    return false;
  for (int i = 0; i < n; ++i)
    if ((strides[i] * elem_bytes) % 16) return false;
  return true;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements; out is (B, H, D)
// contiguous; scale is D^-0.5 as the caller rounds it to float; splits:
// blocks (one cluster) per (row, KV head), 1..8 and at most S.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* length, void* out,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int B,
    int H, int KV, int S, int D, int splits, float scale, int dtype,
    void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup || D < 2 || D % 2 ||
      D > kMaxD || S < 1 || splits < 1 || splits > kMaxSplits || splits > S ||
      (long long)B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long strides[8] = {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool fast = aligned16(q, k, v, strides, 8, D, dtype == 0 ? 4 : 2);
  // aligned bf16 at the tiers' head dims: the tensor cores
  if (dtype == 1 && fast && (D == 64 || D == 128 || D == 256)) {
    auto fn = D == 64 ? launch_mma<64> : D == 128 ? launch_mma<128>
                                                  : launch_mma<256>;
    return fn(q, k, v, length, out, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh,
              v_ss, B, H, KV, S, splits, scale, st);
  }
  if (dtype == 0) {
    auto fn = fast ? launch<float, 4> : launch<float, 1>;
    return fn(q, k, v, length, out, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh,
              v_ss, B, H, KV, S, D, splits, scale, st);
  }
  auto fn = fast ? launch<__nv_bfloat16, 8> : launch<__nv_bfloat16, 2>;
  return fn(q, k, v, length, out, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh,
            v_ss, B, H, KV, S, D, splits, scale, st);
}
