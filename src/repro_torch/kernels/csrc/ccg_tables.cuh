// The task-independent tables of the CCG kernels that build them once per
// block (ccg_solve.cu, ccg_encode.cu): the per-option inputs, a_max·sat per
// (version, option) and the recourse of every version subset at every pole,
// rec[p][code][f] = the masked min over code's versions of the pole-scaled
// cost (kBig for the empty subset), each entry one fminf of the entry with
// its lowest bit cleared and that bit's cost: the bits of a K-fold masked
// min in any order, since a float min is exact.  Rows of options are padded
// to a multiple of 32 and each pole's (2^K, fs) slab by one float, so that
// neither walk is bank-conflicted: a lane reading its own option and subset
// at one pole, and a lane per pole reading one option and subset.
#pragma once

#include <cuda_runtime.h>

#include "accuracy.cuh"

namespace ccg {

constexpr float kBig = 1e9f;
constexpr int kMaxF = 64;   // options of a table kernel: two a lane

// The per-option inputs: option coordinates and availability.
struct OptionTable {
  float rn[kMaxF], pn[kMaxF], tier[kMaxF], ok[kMaxF];
};

__device__ inline void fill_options(OptionTable& s, const float* rn,
                                    const float* pn, const float* tier,
                                    const float* y_ok, int F) {
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    s.rn[i] = rn[i];
    s.pn[i] = pn[i];
    s.tier[i] = tier[i];
    s.ok[i] = y_ok[i];
  }
}

// the index of c's lowest set bit (c > 0), folded where c is a constant
__host__ __device__ constexpr int low_bit(int c) {
  int b = 0;
  while (!((c >> b) & 1)) ++b;
  return b;
}

// Row strides of the tables: options padded to a multiple of 32, each
// pole's (2^K, fs) slab by one float.
__host__ __device__ inline int table_fs(int F) { return (F + 31) / 32 * 32; }
__host__ __device__ inline int table_ps(int F, int K) {
  return (1 << K) * table_fs(F) + 1;
}
// floats of a_max·sat (K, fs) and the subset table (P, ps)
__host__ __device__ inline size_t table_floats(int F, int K, int P) {
  return (size_t)K * table_fs(F) + (size_t)P * table_ps(F, K);
}
__host__ __device__ inline size_t table_bytes(int F, int K, int P) {
  return sizeof(float) * table_floats(F, K, P);
}

// ams[k·fs + f] = a_max·sat of option f at version k, from the options'
// coordinates rn and tier (in shared or device memory); the block's
// threads share the work (a barrier must follow)
template <int kK>
__device__ void fill_ams(float* ams, const float* rn, const float* tier,
                         int F) {
  const int fs = table_fs(F);
  for (int i = threadIdx.x; i < kK * fs; i += blockDim.x) {
    const int k = i / fs, f = i % fs;
    if (f < F) ams[i] = accuracy_base(rn[f], (float)k, tier[f]);
  }
}

// The subsets of one (pole, option) column from its K costs: every subset
// from the one with its lowest bit cleared.
template <int kK>
__device__ __forceinline__ void write_subsets(float* col, int fs,
                                              const float (&c_k)[kK]) {
  float v[1 << kK];
  v[0] = kBig;
  col[0] = kBig;
#pragma unroll
  for (int c = 1; c < (1 << kK); ++c) {
    v[c] = fminf(v[c & (c - 1)], c_k[low_bit(c)]);
    col[c * fs] = v[c];
  }
}

// rec_tab[p·ps + c·fs + f] for every pole p < P, subset c < 2^kK and option
// f < F, where cost(k, p, f) is version k's pole-scaled cost: the block's
// threads take the P·F (pole, option) columns two at a time, both columns'
// costs read before either is written (a barrier must follow)
template <int kK, class Cost>
__device__ void fill_subsets(float* rec_tab, int F, int P, Cost cost) {
  const int fs = table_fs(F), ps = table_ps(F, kK);
  const int n = P * F;
  for (int i = threadIdx.x; i < n; i += 2 * blockDim.x) {
    const int i1 = i + blockDim.x;
    const bool two = i1 < n;
    const int p0 = i / F, f0 = i - p0 * F;
    const int p1 = two ? i1 / F : p0, f1 = two ? i1 - p1 * F : f0;
    float c0[kK], c1[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      c0[k] = cost(k, p0, f0);
      c1[k] = cost(k, p1, f1);
    }
    write_subsets<kK>(rec_tab + p0 * ps + f0, fs, c0);
    if (two) write_subsets<kK>(rec_tab + p1 * ps + f1, fs, c1);
  }
}

// The card's SMs and the dynamic shared memory a block may opt in to, read
// once per device (a launch then costs no attribute calls).
struct Card {
  int dev = -1, sms = 0, optin = 0;
};

inline const Card& current_card() {
  static Card card;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != card.dev) {
    cudaDeviceGetAttribute(&card.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&card.optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    card.dev = dev;
  }
  return card;
}

// Opts `kernel` in to `bytes` of dynamic shared memory once per device
// (`opted_in`: the kernel's own record of the device it opted in on).
template <class Kernel>
inline cudaError_t opt_in(Kernel kernel, const Card& card, int bytes,
                          int& opted_in) {
  if (opted_in == card.dev) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) opted_in = card.dev;
  return e;
}

}  // namespace ccg
