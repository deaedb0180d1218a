// Backward of the fused temporal-gating cell (paper Eq. 5-6): the
// vector-Jacobian product of gate_cell for a batch of streams.
//
// Replaces: no TPU kernel.  The reference differentiates its jnp cell
// (src/repro/serving/session.py:255-258 takes the online finetune's
// gradient with force="ref": the Pallas gate_cell has no VJP).  The port
// runs no plain version on the card, so gate_cell's autograd.Function
// (kernels/temporal_gate/ops.py GateCellFn) and the finetune round take
// their gradient here.
//
// Inputs: dx (B, d), h (B, 32), vol (B,), the twelve gate parameters, and
// the incoming gradients dh_new (B, 32), dtau (B,), dg_mean (B,), each of
// them optional (a null pointer is a zero gradient).  Outputs: the
// gradient of every parameter, flat in gate_specs' order (w_g, u_g, b_g,
// alpha, w_r, u_r, b_r, w_h, u_h, b_h, w_o, b_o), and dh (B, 32) when its
// pointer is not null.
//
// What bounds it on the H100: operations.  Per stream it recomputes the
// forward (~13.9 kFLOP at d = 35), takes dh through three 32 x 32 products
// (~6.9 kFLOP) and adds its outer products to the weight gradients (two
// operations an element of the 6,562 gradients: ~13.1 kFLOP): ~34 kFLOP a
// stream, 139 MFLOP at B = 4096, 2.1 us at 67 TFLOP/s, against 2.2 MB of
// operands (0.66 us at 3.35 TB/s).  What held a first design back was
// shared memory: it read two operands from shared memory for every
// product, and one thread summed alpha's 32 x 32 terms (28.9 us a call at
// B = 4096 on an H100 80GB HBM3 at 700 W, against 20.4 us for this one).
//
// Design: one 512-thread block per tile of 32 streams.  The block copies
// the weights into shared memory (with the transposes of U_g, U_r and U_h
// that the backward's products over the hidden units read without bank
// conflicts) and its tile's dx, h and vol.  Phase 1: a warp takes 2
// streams of the tile side by side; lane j owns hidden unit j of both, so
// one shared load of a weight feeds both streams' products, and the
// streams' rows are read as 16-byte broadcasts.  Each stream's forward is
// recomputed in the forward kernel's order (k ascending, a multiply then an
// add: the same bits as gate_cell) and the chain rule leaves r·h, h_new,
// dtau's share and the three gates' input gradients of each stream in
// shared memory.  Phase 2: the weight gradients are three (rows × S) ·
// (S × 96) products over the tile's S streams (dx, h and r·h against the
// gates' input gradients), and a thread sums a 4 × 4 tile of entries from
// two 16-byte loads a stream; the small gradients (biases, alpha, w_o, b_o)
// take a thread each (alpha from each stream's Σ_j dL/dg_j·vol, a warp's
// butterfly sum in phase 1).  Every entry sums the tile's streams in order
// into the block's row of a (tiles, E) buffer, and a second kernel sums
// each entry's column: four threads an entry, each over a quarter of the
// tiles in order, then the quarters pairwise.  No float atomics: two
// launches on the same inputs give the same bits, on any card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kM = 32;                  // hidden units: one a lane
constexpr int kWarps = 16;              // warps a block
constexpr int kS = 2;                   // streams a warp, side by side
constexpr int kTile = kWarps * kS;      // streams a block
constexpr int kG = 3 * kM;              // the three gates' input gradients
constexpr int kMaxD = 64;
constexpr int kReduceThreads = 256;
constexpr int kParts = 4;                   // ranges of tiles an entry sums
constexpr int kReduceEntries = kReduceThreads / kParts;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// one term of a dot product: the product rounded, then the sum
__device__ __forceinline__ float madd(float acc, float x, float w) {
  return acc + x * w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// offsets of each parameter's gradient in the flat output
struct Flat {
  int wg, ug, bg, alpha, wr, ur, br, wh, uh, bh, wo, bo, total;
  __host__ __device__ explicit Flat(int d) {
    wg = 0;
    ug = wg + d * kM;
    bg = ug + kM * kM;
    alpha = bg + kM;
    wr = alpha + 1;
    ur = wr + d * kM;
    br = ur + kM * kM;
    wh = br + kM;
    uh = wh + d * kM;
    bh = uh + kM * kM;
    wo = bh + kM;
    bo = wo + kM;
    total = bo + 1;
  }
};

// shared memory, in floats (every section a multiple of 4 floats): the
// weights, then the tile's rows
struct Layout {
  int dp, wx, ugr, uh, ugt, urt, uht, vec, x, hh, rh, hn, dg3, vol, dao,
      ga, total;
  __host__ __device__ explicit Layout(int d) {
    dp = (d + 3) & ~3;                 // a dx row, padded to 16 bytes
    wx = 0;                            // row k: w_g[k] | w_r[k] | w_h[k]
    ugr = wx + d * kG;                 // row k: u_g[k] | u_r[k]
    uh = ugr + kM * 2 * kM;
    ugt = uh + kM * kM;                // transposes: ugt[j * 32 + k] = u_g[k][j]
    urt = ugt + kM * kM;
    uht = urt + kM * kM;
    vec = uht + kM * kM;               // w_o | b_g | b_r | b_h
    x = vec + 4 * kM;                  // the tile: dx rows of dp floats
    hh = x + kTile * dp;               // h
    rh = hh + kTile * kM;              // r·h
    hn = rh + kTile * kM;              // h_new
    dg3 = hn + kTile * kM;             // per stream: dL/d(the inputs of g |
                                       // r | the candidate), 96 floats
    vol = dg3 + kTile * kG;
    dao = vol + kTile;                 // dL/d(tau's input)
    ga = dao + kTile;                  // Σ_j dL/d(g_j's input)·vol
    total = ga + kTile;
  }
};

struct Args {
  const float *dx, *h, *vol, *w_g, *u_g, *b_g, *alpha, *w_r, *u_r, *b_r, *w_h,
      *u_h, *b_h, *w_o, *b_o;
  const float *dh_new, *dtau, *dg_mean;   // null: a zero gradient
  float *dh;                              // null: not wanted
  float *partial;                         // (tiles, Flat(d).total)
  int B, d;
};

// Phase 2's 4 × 4 tiles: rows of dx (i < d) or of h / r·h (k < 32) against
// 4 of the 96 gate-gradient columns; the tile's sums, streams in order
__device__ __forceinline__ void tile_products(const float* a, int lda,
                                              const float* g3, int rows,
                                              float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  for (int s = 0; s < rows; ++s) {
    const float4 a4 = load4(a + s * lda);
    const float4 b4 = load4(g3 + s * kG);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = madd(acc[u][v], av[u], bv[v]);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    gate_cell_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d;
  const Layout L(d);
  const int dp = L.dp;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * kTile;
  const int rows = a.B - s0 < kTile ? a.B - s0 : kTile;

  // the weights and the tile
  for (int i = tid; i < d * kM; i += nt) {
    const int k = i / kM, j = i - k * kM;
    float* row = smem + L.wx + k * kG;
    row[j] = a.w_g[i];
    row[kM + j] = a.w_r[i];
    row[2 * kM + j] = a.w_h[i];
  }
  for (int i = tid; i < kM * kM; i += nt) {
    const int k = i / kM, j = i - k * kM;
    smem[L.ugr + k * 2 * kM + j] = a.u_g[i];
    smem[L.ugr + k * 2 * kM + kM + j] = a.u_r[i];
    smem[L.uh + i] = a.u_h[i];
    smem[L.ugt + j * kM + k] = a.u_g[i];
    smem[L.urt + j * kM + k] = a.u_r[i];
    smem[L.uht + j * kM + k] = a.u_h[i];
  }
  for (int i = tid; i < kM; i += nt) {
    smem[L.vec + i] = a.w_o[i];
    smem[L.vec + kM + i] = a.b_g[i];
    smem[L.vec + 2 * kM + i] = a.b_r[i];
    smem[L.vec + 3 * kM + i] = a.b_h[i];
  }
  for (int i = tid; i < rows * d; i += nt) {
    const int s = i / d;
    smem[L.x + s * dp + (i - s * d)] = a.dx[(size_t)s0 * d + i];
  }
  for (int i = tid; i < rows * kM; i += nt) {
    smem[L.hh + i] = a.h[(size_t)s0 * kM + i];
  }
  for (int i = tid; i < rows; i += nt) smem[L.vol + i] = a.vol[s0 + i];
  __syncthreads();

  const float alpha = a.alpha[0], b_o = a.b_o[0];
  const float* s_wx = smem + L.wx;
  const float* s_ugr = smem + L.ugr;
  const float* s_uh = smem + L.uh;
  const float* s_ugt = smem + L.ugt;
  const float* s_urt = smem + L.urt;
  const float* s_uht = smem + L.uht;
  const float w_o = smem[L.vec + lane];
  const float b_g = smem[L.vec + kM + lane];
  const float b_r = smem[L.vec + 2 * kM + lane];
  const float b_h = smem[L.vec + 3 * kM + lane];

  // phase 1: the warp's 2 streams side by side (a stream past the tile's
  // rows computes on stale shared memory and reads and writes nothing
  // outside it: phase 2 sums only the tile's rows)
  const int sf = warp * kS;
  if (sf < rows) {                               // warp-uniform
    const float* xs = smem + L.x + sf * dp;
    const float* hs = smem + L.hh + sf * kM;
    float* rh = smem + L.rh + sf * kM;
    float* g3 = smem + L.dg3 + sf * kG;
    bool valid[kS];
    size_t b[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      valid[s] = sf + s < rows;
      b[s] = (size_t)s0 + sf + s;
    }

    // packed dx·W_x: columns j (g), m + j (r), 2m + j (candidate)
    float xg[kS], xr[kS], xh[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) xg[s] = xr[s] = xh[s] = 0.0f;
    const int d4 = d & ~3;
    for (int k = 0; k < d4; k += 4) {
      float wg[4], wr[4], wh[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = s_wx + (k + u) * kG;
        wg[u] = row[lane];
        wr[u] = row[kM + lane];
        wh[u] = row[2 * kM + lane];
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 x4 = load4(xs + s * dp + k);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xg[s] = madd(xg[s], xv[u], wg[u]);
          xr[s] = madd(xr[s], xv[u], wr[u]);
          xh[s] = madd(xh[s], xv[u], wh[u]);
        }
      }
    }
    for (int k = d4; k < d; ++k) {
      const float* row = s_wx + k * kG;
      const float wg = row[lane], wr = row[kM + lane], wh = row[2 * kM + lane];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float xv = xs[s * dp + k];
        xg[s] = madd(xg[s], xv, wg);
        xr[s] = madd(xr[s], xv, wr);
        xh[s] = madd(xh[s], xv, wh);
      }
    }
    // packed h·U_gr: columns j (g), m + j (r)
    float hg[kS], hr[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) hg[s] = hr[s] = 0.0f;
    for (int k = 0; k < kM; k += 4) {
      float wg[4], wr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = s_ugr + (k + u) * 2 * kM;
        wg[u] = row[lane];
        wr[u] = row[kM + lane];
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 h4 = load4(hs + s * kM + k);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          hg[s] = madd(hg[s], hv[u], wg[u]);
          hr[s] = madd(hr[s], hv[u], wr[u]);
        }
      }
    }
    float hj[kS], g[kS], r[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      hj[s] = hs[s * kM + lane];
      g[s] = sigmoidf_(xg[s] + hg[s] + b_g + alpha * smem[L.vol + sf + s]);
      r[s] = sigmoidf_(xr[s] + hr[s] + b_r);
      rh[s * kM + lane] = r[s] * hj[s];
    }
    __syncwarp();
    float c[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) c[s] = 0.0f;
    for (int k = 0; k < kM; k += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = s_uh[(k + u) * kM + lane];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 r4 = load4(rh + s * kM + k);
        c[s] = madd(c[s], r4.x, w[0]);
        c[s] = madd(c[s], r4.y, w[1]);
        c[s] = madd(c[s], r4.z, w[2]);
        c[s] = madd(c[s], r4.w, w[3]);
      }
    }

    // tau = σ(h_new·w_o + b_o); g_mean = mean_j g_j
    float dhn[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float cand = tanhf(xh[s] + c[s] + b_h);
      const float hn = (1.0f - g[s]) * hj[s] + g[s] * cand;
      smem[L.hn + (sf + s) * kM + lane] = hn;
      const float tau = sigmoidf_(warp_sum(hn * w_o) + b_o);
      const float da_o = valid[s] && a.dtau != nullptr
                             ? a.dtau[b[s]] * tau * (1.0f - tau)
                             : 0.0f;
      dhn[s] = (valid[s] && a.dh_new != nullptr ? a.dh_new[b[s] * kM + lane]
                                                : 0.0f) +
               da_o * w_o;
      const float dg =
          dhn[s] * (cand - hj[s]) +
          (valid[s] && a.dg_mean != nullptr ? a.dg_mean[b[s]] / (float)kM
                                            : 0.0f);
      const float dag = dg * g[s] * (1.0f - g[s]);
      const float ga = warp_sum(dag * smem[L.vol + sf + s]);
      g3[s * kG + lane] = dag;
      g3[s * kG + 2 * kM + lane] = dhn[s] * g[s] * (1.0f - cand * cand);
      if (lane == 0) {
        smem[L.dao + sf + s] = da_o;
        smem[L.ga + sf + s] = ga;
      }
    }
    __syncwarp();
    // d(r·h)_j = Σ_i dac_i · u_h[j][i]
    float drh[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) drh[s] = 0.0f;
    for (int i = 0; i < kM; i += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = s_uht[(i + u) * kM + lane];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float4 c4 = load4(g3 + s * kG + 2 * kM + i);
        drh[s] = madd(drh[s], c4.x, w[0]);
        drh[s] = madd(drh[s], c4.y, w[1]);
        drh[s] = madd(drh[s], c4.z, w[2]);
        drh[s] = madd(drh[s], c4.w, w[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      g3[s * kG + kM + lane] = drh[s] * hj[s] * r[s] * (1.0f - r[s]);
    }
    if (a.dh != nullptr) {
      __syncwarp();
      float tg[kS], tr[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) tg[s] = tr[s] = 0.0f;
      for (int i = 0; i < kM; i += 4) {
        float wg[4], wr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          wg[u] = s_ugt[(i + u) * kM + lane];
          wr[u] = s_urt[(i + u) * kM + lane];
        }
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const float4 g4 = load4(g3 + s * kG + i);
          const float4 r4 = load4(g3 + s * kG + kM + i);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            tg[s] = madd(tg[s], gv[u], wg[u]);
            tr[s] = madd(tr[s], rv[u], wr[u]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        if (valid[s]) {
          a.dh[b[s] * kM + lane] =
              dhn[s] * (1.0f - g[s]) + drh[s] * r[s] + tg[s] + tr[s];
        }
      }
    }
  }
  __syncthreads();

  // phase 2: this tile's share of every weight gradient, streams in order.
  // Items: 4 × 4 tiles of dx against the 96 gate-gradient columns, of h
  // (columns of g and r) or r·h (the candidate's) against them, then the
  // biases, alpha, w_o and b_o
  const Flat F(d);
  float* out = a.partial + (size_t)blockIdx.x * F.total;
  constexpr int kColTiles = kG / 4;
  const int n_x = dp / 4 * kColTiles, n_h = kM / 4 * kColTiles;
  const int n_items = n_x + n_h + kG + 1 + kM + 1;
  const float* G3 = smem + L.dg3;
  for (int it = tid; it < n_items; it += nt) {
    if (it < n_x + n_h) {
      const bool on_x = it < n_x;
      const int t = on_x ? it : it - n_x;
      const int row0 = t / kColTiles * 4, col0 = t % kColTiles * 4;
      const int gate = col0 / kM;            // 0 g, 1 r, 2 candidate
      const float* A = on_x ? smem + L.x + row0
                            : smem + (gate < 2 ? L.hh : L.rh) + row0;
      float acc[4][4];
      tile_products(A, on_x ? dp : kM, G3 + col0, rows, acc);
      const int base = on_x ? (gate == 0 ? F.wg : gate == 1 ? F.wr : F.wh)
                            : (gate == 0 ? F.ug : gate == 1 ? F.ur : F.uh);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (on_x && row0 + u >= d) break;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          out[base + (row0 + u) * kM + col0 % kM + v] = acc[u][v];
        }
      }
      continue;
    }
    const int e = it - n_x - n_h;
    float acc = 0.0f;
    if (e < kG) {                             // b_g, b_r, b_h
      for (int s = 0; s < rows; ++s) acc += G3[s * kG + e];
      const int gate = e / kM;
      out[(gate == 0 ? F.bg : gate == 1 ? F.br : F.bh) + e % kM] = acc;
    } else if (e == kG) {                     // alpha
      for (int s = 0; s < rows; ++s) acc += smem[L.ga + s];
      out[F.alpha] = acc;
    } else if (e < kG + 1 + kM) {             // w_o
      const int j = e - kG - 1;
      const float* HN = smem + L.hn;
      const float* DAO = smem + L.dao;
      for (int s = 0; s < rows; ++s) acc = madd(acc, HN[s * kM + j], DAO[s]);
      out[F.wo + j] = acc;
    } else {                                  // b_o
      for (int s = 0; s < rows; ++s) acc += smem[L.dao + s];
      out[F.bo] = acc;
    }
  }
}

// out[e] = Σ_t partial[t][e]: a thread sums a quarter of the tiles in
// order, then the quarters are added pairwise, (q0 + q1) + (q2 + q3)
__global__ void __launch_bounds__(kReduceThreads)
    gate_cell_bwd_reduce_kernel(const float* __restrict__ partial, int tiles,
                                int total, float* __restrict__ out) {
  static_assert(kParts == 4, "the quarters' pairing below");
  __shared__ float part[kParts][kReduceEntries];
  const int col = threadIdx.x % kReduceEntries;
  const int q = threadIdx.x / kReduceEntries;
  const int e = blockIdx.x * kReduceEntries + col;
  const int chunk = (tiles + kParts - 1) / kParts;
  const int t_end = tiles < (q + 1) * chunk ? tiles : (q + 1) * chunk;
  float acc = 0.0f;
  if (e < total) {
#pragma unroll 8
    for (int t = q * chunk; t < t_end; ++t) {
      acc += partial[(size_t)t * total + e];
    }
  }
  part[q][col] = acc;
  __syncthreads();
  if (q == 0 && e < total) {
    out[e] = (part[0][col] + part[1][col]) + (part[2][col] + part[3][col]);
  }
}

}  // namespace

// partial: at least (ceil(B / 32), E) floats, E the gradient's length
extern "C" int gate_cell_bwd_launch(
    const void* dx, const void* h, const void* vol, const void* w_g,
    const void* u_g, const void* b_g, const void* alpha, const void* w_r,
    const void* u_r, const void* b_r, const void* w_h, const void* u_h,
    const void* b_h, const void* w_o, const void* b_o, const void* dh_new,
    const void* dtau, const void* dg_mean, void* dh, void* partial,
    int partial_rows, void* grads, int B, int d, int m, void* stream) {
  const int tiles = (B + kTile - 1) / kTile;
  if (m != kM || d < 1 || d > kMaxD || B < 0 || partial_rows < tiles) {
    return (int)cudaErrorInvalidValue;
  }
  static int card = -1;                // the device opted in, once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != card) {
    const cudaError_t e = cudaFuncSetAttribute(
        gate_cell_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * (size_t)Layout(kMaxD).total));
    if (e != cudaSuccess) return (int)e;
    card = dev;
  }
  const int total = Flat(d).total;
  const Args a{(const float*)dx,     (const float*)h,      (const float*)vol,
               (const float*)w_g,    (const float*)u_g,    (const float*)b_g,
               (const float*)alpha,  (const float*)w_r,    (const float*)u_r,
               (const float*)b_r,    (const float*)w_h,    (const float*)u_h,
               (const float*)b_h,    (const float*)w_o,    (const float*)b_o,
               (const float*)dh_new, (const float*)dtau,   (const float*)dg_mean,
               (float*)dh,           (float*)partial,      B,
               d};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    gate_cell_bwd_kernel<<<tiles, kWarps * 32,
                           sizeof(float) * (size_t)Layout(d).total, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  gate_cell_bwd_reduce_kernel<<<(total + kReduceEntries - 1) / kReduceEntries,
                                kReduceThreads, 0, s>>>(
      (const float*)partial, tiles, total, (float*)grads);
  return (int)cudaGetLastError();
}
