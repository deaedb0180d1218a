// C6 bandwidth-repair tail: one demotion round's per-task draw, candidate
// accuracies and reclaimable gain — one thread per task.
//
// Replaces: src/repro/kernels/c6_tail/kernel.py:c6_tail (Pallas body
// _tail_kernel), which keeps a (256, N·Z) panel tile in VMEM and folds the
// row gathers into one-hot max selects, a TPU workaround for dynamic gathers.
//
// What bounds it on the H100: memory, then launch latency.  Per task the
// function reads six 4-byte lane inputs, the current panel entry and, only
// where a demotion is feasible, the demoted entry, and writes 12 bytes (at
// most 44 B, 180 KB at M = 4096: 54 ns at 3.35 TB/s); with a_max·sat
// tabulated once it does about 24 operations; the launch costs more than
// either.
//
// Design: the panel entries are read by direct index (no one-hot select),
// the demoted one only when its demotion is chosen; the N and Z coordinate
// vectors (5 floats each) are read through
// the read-only cache.  Lanes of a warp are neighbouring tasks, so the lane
// inputs and outputs are coalesced.  Same float32 operations in the same
// order as the plain version, compiled with -fmad=false: exact on one card.
#include <cuda_runtime.h>

#include "accuracy.cuh"

namespace {

constexpr int kBlock = 256;
constexpr float kBig = 1e9f;

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
  const int r = r_in[i], p = p_in[i];
  const float vf = (float)v_in[i], tf = (float)route_in[i];
  const float z = z_in[i], thr = thr_in[i];
  const float* row = panel + (size_t)i * N * Z;
  const int p_dn = p - 1 > 0 ? p - 1 : 0;
  const int r_dn = r - 1 > 0 ? r - 1 : 0;
  const float bw = __ldg(row + r * Z + p);
  const float f_pdn = accuracy(z, __ldg(rn + r), __ldg(pn + p_dn), vf, tf);
  const float f_rdn = accuracy(z, __ldg(rn + r_dn), __ldg(pn + p), vf, tf);
  const bool can_p = p > 0 && f_pdn >= thr;
  const bool can_r = r > 0 && f_rdn >= thr;
  float gain = -kBig;
  if (can_p) {
    gain = bw - __ldg(row + r * Z + p_dn);
  } else if (can_r) {
    gain = bw - __ldg(row + r_dn * Z + p);
  }
  bw_out[i] = bw;
  gain_out[i] = gain;
  can_p_out[i] = can_p ? 1 : 0;
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
