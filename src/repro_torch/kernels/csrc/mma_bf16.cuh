// Tensor-core helpers shared by the bf16 prefill attention kernels
// (flash_attention.cu and its backward, flash_attention_bwd.cu): 16-byte
// cp.async staging into shared memory, ldmatrix fragment loads, the
// mma.sync m16n8k16 bf16 → float32 product and the packing of two floats
// into one bf16 pair of an A fragment.
//
// Fragments of m16n8k16 (lane = 4·gq + tq): A (16 × 16, row) holds rows gq
// and gq + 8 at columns 2·tq, 2·tq + 1 and those + 8; B (16 × 8, col) rows
// 2·tq, 2·tq + 1 and those + 8 of column gq; C (16 × 8) rows gq and gq + 8
// at columns 2·tq, 2·tq + 1.  So two neighbouring C fragments, rounded and
// packed, are one A fragment of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; with in == false the 16 bytes are zero-filled
// (src-size 0) and src is not read
static __device__ __forceinline__ void cp_async16(uint32_t dst,
                                                  const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                                   uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                         uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 × 8, float32) += a (16 × 16, bf16, row) · b (16 × 8, bf16, col)
static __device__ __forceinline__ void mma_bf16(float (&c)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of a 16 × 16 product from two neighbouring 16 × 8
// accumulator fragments (columns 0-7 and 8-15), rounded to bf16
static __device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                              const float (&lo)[4],
                                              const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
