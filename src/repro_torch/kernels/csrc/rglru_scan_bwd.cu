// Backward of the RG-LRU scan (RecurrentGemma's recurrent mixer): the
// vector-Jacobian product of rglru_scan.cu's a_t = exp(la ⊙ r_t),
// h_t = a_t ⊙ h_{t-1} + sqrt(max(1 − a_t², 1e-12)) ⊙ (i_t ⊙ x_t), y_t = h_t.
//
// Replaces: no TPU kernel.  src/repro/kernels/rglru/kernel.py:rglru_scan
// has no backward; the reference trains its jnp scan
// (src/repro/models/rglru.py:rglru_scan_ref) by JAX autodiff.  The port
// runs no plain version on the card, so RGLRUScanFn
// (kernels/rglru/ops.py) takes its gradient here.  The plain version is
// kernels/rglru/ref.py:rglru_scan_vjp_ref.
//
// Inputs: x (B, S, W) in float32 or bf16; r, i (B, S, W), la (W,), h0
// (B, W) or null, y (B, S, W) the forward's states, dy (B, S, W) and dh
// (B, W) or null the cotangents of y and of the final state, all float32.
// Outputs: dx (B, S, W) in x's dtype, dr, di (B, S, W), dla (W,) and dh0
// (B, W), float32.
//
// What bounds it on the H100: bytes.  Per (row, step, channel) it reads
// x, r, i, y and dy and writes dx, dr and di (28 bytes with bf16 x) for
// ~20 operations, an exponential, a square root and a division.
// RecurrentGemma-9B's training shape (B = 8, S = 512, W = 4096) moves
// ~470 MB, ~0.14 ms at 3.35 TB/s.
//
// Design.  Only the cotangent of the state is serial: g_t = dy_t + c_t,
// c_{t-1} = a_t·g_t, from c_{S-1} = dh.  A block owns kC = 32 channels of
// one row (1,024 blocks at the training shape, ~8 an SM) and walks tiles
// of kT = 32 steps from the last to the first.  For a tile, its 128
// threads stage x, r, i, y and dy by coalesced loads, and the state that
// enters the tile (y at the step before it, or h0); all threads take the
// tile's a_t off the chain; one thread per channel walks g down the tile in
// reverse; then all threads compute each (step, channel)'s gradients from
// g, a and h_{t-1} and store them coalesced, and leave the step's term of
// dla, (da·a)·r, in shared memory, which the channel's thread adds to its
// running sum in reverse step order.  dla's per-row sums go to a (B, W)
// buffer that a second kernel (fixed_sum.cuh) sums over the rows in order:
// no float atomics, so two launches give the same bits.  Built with the
// repository's -fmad=false: every operation rounds as the plain version's
// separate multiplies and adds, in its order, with the IEEE expf, sqrtf and
// division that torch calls, so dx, dr, di and dh0 equal the plain
// version's bits; dla sums in another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

namespace {

constexpr int kThreads = 128;     // threads of a block
constexpr int kC = 32;            // channels of a block
constexpr int kT = 32;            // steps of a tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ r,
                          const float* __restrict__ ig,
                          const float* __restrict__ la,
                          const float* __restrict__ h0,
                          const float* __restrict__ y,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh, T* __restrict__ dx,
                          float* __restrict__ dr, float* __restrict__ di,
                          float* __restrict__ part, float* __restrict__ dh0,
                          int S, int W) {
  __shared__ float r_s[kT][kC];   // r_t, then the term of dla
  __shared__ float i_s[kT][kC];
  __shared__ float x_s[kT][kC];
  __shared__ float y_s[kT][kC];   // h_t
  __shared__ float g_s[kT][kC];   // dy_t, then g_t
  __shared__ float a_s[kT][kC];
  __shared__ float la_s[kC];
  __shared__ float h_in[kC];      // h at the step before the tile

  const int row = blockIdx.x, c0 = blockIdx.y * kC, tid = threadIdx.x;
  const int wc = min(kC, W - c0);               // channels of this block
  const long long base = (long long)row * S * W + c0;
  const long long st = (long long)row * W + c0 + tid;
  if (tid < wc) la_s[tid] = la[c0 + tid];
  float carry = tid < wc && dh != nullptr ? dh[st] : 0.0f;
  float dla = 0.0f;

  for (int t0 = (S - 1) / kT * kT; t0 >= 0; t0 -= kT) {
    const int nt = min(kT, S - t0);
    __syncthreads();   // the previous tile is consumed
    for (int e = tid; e < nt * kC; e += kThreads) {
      const int t = e / kC, c = e % kC;
      if (c < wc) {
        const long long o = base + (long long)(t0 + t) * W + c;
        r_s[t][c] = r[o];
        i_s[t][c] = ig[o];
        x_s[t][c] = to_f(x[o]);
        y_s[t][c] = y[o];
        g_s[t][c] = dy[o];
      }
    }
    if (tid < wc)
      h_in[tid] = t0 > 0 ? y[base + (long long)(t0 - 1) * W + tid]
                         : (h0 != nullptr ? h0[st] : 0.0f);
    __syncthreads();
    // the gates, off the chain
    for (int e = tid; e < nt * kC; e += kThreads) {
      const int t = e / kC, c = e % kC;
      if (c < wc) a_s[t][c] = expf(la_s[c] * r_s[t][c]);
    }
    __syncthreads();
    // the chain: one thread per channel, the last step first
    if (tid < wc) {
#pragma unroll 8
      for (int t = nt - 1; t >= 0; --t) {
        const float g = g_s[t][tid] + carry;
        g_s[t][tid] = g;
        carry = a_s[t][tid] * g;
      }
    }
    __syncthreads();
    // each (step, channel)'s gradients, stored coalesced
    for (int e = tid; e < nt * kC; e += kThreads) {
      const int t = e / kC, c = e % kC;
      if (c < wc) {
        const float a = a_s[t][c], g = g_s[t][c], iv = i_s[t][c];
        const float xv = x_s[t][c];
        const float hp = t > 0 ? y_s[t - 1][c] : h_in[c];
        const float one_m = 1.0f - a * a;
        const float root = sqrtf(fmaxf(one_m, 1e-12f));
        const float gs = g * root;
        const float dsa = one_m > 1e-12f ? -a / root : 0.0f;
        const float da = g * hp + g * (iv * xv) * dsa;
        const float dla_r = da * a;
        const long long o = base + (long long)(t0 + t) * W + c;
        fixed_sum::store(dx + o, gs * iv);
        di[o] = gs * xv;
        dr[o] = dla_r * la_s[c];
        r_s[t][c] = dla_r * r_s[t][c];
      }
    }
    __syncthreads();
    if (tid < wc) {
      for (int t = nt - 1; t >= 0; --t) dla += r_s[t][tid];
    }
  }
  if (tid < wc) {
    if (dh0 != nullptr) dh0[st] = carry;
    part[st] = dla;
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* ig, const void* la,
           const void* h0, const void* y, const void* dy, const void* dh,
           void* dx, void* dr, void* di, void* part, void* dla, void* dh0,
           int B, int S, int W, cudaStream_t stream) {
  const dim3 grid(B, (W + kC - 1) / kC);
  rglru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const float*)r, (const float*)ig, (const float*)la,
      (const float*)h0, (const float*)y, (const float*)dy, (const float*)dh,
      (T*)dx, (float*)dr, (float*)di, (float*)part, (float*)dh0, S, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixed_sum::sum_leading<float>((const float*)part, B, W, W, W, (float*)dla,
                                nullptr, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and dx): 0 float32, 1 bfloat16.  x, r, i, y, dy, dx, dr and
// di (B, S, W), la and dla (W,), h0, dh, dh0 and part (a scratch of B·W
// floats) (B, W), all contiguous, all but x and dx float32; h0, dh and dh0
// may be null (zeros; dh0 not written).
extern "C" int rglru_scan_bwd_launch(const void* x, const void* r,
                                     const void* ig, const void* la,
                                     const void* h0, const void* y,
                                     const void* dy, const void* dh, void* dx,
                                     void* dr, void* di, void* part, void* dla,
                                     void* dh0, int B, int S, int W, int dtype,
                                     void* stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, r, ig, la, h0, y, dy, dh, dx, dr, di, part, dla,
                         dh0, B, S, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, ig, la, h0, y, dy, dh, dx, dr, di,
                                 part, dla, dh0, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
