// PTX wrappers and helpers shared by the hand-written kernels (sm_80 and
// later; built for sm_90a): asynchronous global->shared copies, ldmatrix,
// the bf16 mma.sync tensor-core product, the warp's transposing butterfly
// sum, and vector loads and stores of a lane's columns.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace codec {

constexpr unsigned kFullMask = 0xffffffffu;

// The head dims the attention kernels take: multiples of 16 from 16 to
// 256.  A kernel runs d in an instance of more columns where it must, the
// columns past d masked: a lane's or a fragment's columns lie all below d
// or all past it.
__host__ __device__ constexpr bool head_dim_taken(int d) {
  return d >= 16 && d <= 256 && d % 16 == 0;
}

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

// Two bf16 (the low half first) as floats.
__device__ __forceinline__ float2 bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// C contiguous elements (16-byte aligned for C >= 4 at f32, 2C-byte
// aligned at bf16) as floats, in vector loads.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  } else if constexpr (C == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&x)[C]) {
  if constexpr (C == 1) {
    x[0] = __bfloat162float(*p);
  } else {
    uint32_t u[C / 2];
    if constexpr (C == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      u[0] = v.x;
      u[1] = v.y;
      u[2] = v.z;
      u[3] = v.w;
    } else if constexpr (C == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x;
      u[1] = v.y;
    } else {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float2 f = bf16x2(u[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// The same C elements written back (bf16 rounded to nearest even).
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <int C>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&x)[C]) {
  if constexpr (C == 1) {
    *p = __float2bfloat16(x[0]);
  } else {
    uint32_t u[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (C == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else if constexpr (C == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = u[0];
    }
  }
}

}  // namespace codec
