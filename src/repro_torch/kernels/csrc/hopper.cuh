// PTX wrappers shared by the hand-written kernels (sm_80 and later; built
// for sm_90a): asynchronous global->shared copies, ldmatrix, the bf16
// mma.sync tensor-core product and the warp's transposing butterfly sum.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace codec {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy, cached in L2 only.  Bytes past `src_bytes`
// (0 or 16) are zero-filled and nothing is read from `src` for them.  The
// copies carry no memory clobber, so the compiler may interleave them with
// the compute of another stage; cp_async_wait (which has one) and a
// barrier order them against the reads of their own stage.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 8-byte asynchronous copy (for rows that are not 16-byte multiples).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b for one m16n8k16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2 (x in the low half), rounded to nearest; `lo` gets
// the bf16x2 of what rounding left over, so hi + lo carries ~16 bits of
// each value's mantissa.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// One round of the transposing butterfly over a warp: lanes whose offset
// bit O is set keep the upper N of the first 2N values, the others the
// lower N, and each adds its partner's copy of the half it kept.
template <int N, int O, int M>
__device__ __forceinline__ void xpose(float (&v)[M], int ln) {
  const bool up = (ln & O) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, O);
  }
}

// Sums N partial values (N a power of two) over the warp: rounds at
// offsets 16, 8, ... first halve the values a lane keeps (xpose), then add
// the last one, so lane ln ends with the sum of value ln >> (5 - log2 N).
// Every index is a constant, so the values stay in registers.
template <int N, int O, int M>
__device__ __forceinline__ void reduce_rounds(float (&v)[M], int ln) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      xpose<N / 2, O>(v, ln);
      reduce_rounds<N / 2, O / 2>(v, ln);
    } else {
      v[0] += __shfl_xor_sync(kFullMask, v[0], O);
      reduce_rounds<1, O / 2>(v, ln);
    }
  }
}

}  // namespace codec
