// CoDec POR (partial output reduction, paper Alg. 3) for Hopper (sm_90a):
// the pairwise merge, and the decode-attention epilogue built around it.
//
// 1. codec_por replaces the Pallas TPU kernel src/repro/kernels/por.py::por
//    (kernel body _por_kernel): the pairwise log-sum-exp merge of two flash
//    partials over the same queries,
//      m = max(m1, m2),  a_i = exp(m_i - m) * l_i,  l = a1 + a2,
//      o = (o1 * a1 + o2 * a2) / max(l, 1e-30).
//    One thread per (row, column) element of o, rows = N * h.  Each thread
//    recomputes its row's m, a1, a2 and l (two exps; the row stats stay in
//    L1) and the column-0 thread writes m and l.  A few FLOPs per element
//    against 12 bytes read and 4 written: HBM bytes (3.35 TB/s) bound it,
//    and at decode batch sizes a launch costs more than the traffic.  It is
//    the paper's primitive; the engine no longer calls it.
//
// 2. codec_por_epilogue is the engine's whole attention epilogue for one
//    layer, one launch where the plain route takes ~45 (the dead-slot
//    selects, the segment reduction's scatter_reduce and two index_add_,
//    the tail page's gather, einsums, mask and softmax, the POR merge and
//    the cast).  It replaces, besides POR, what the JAX package leaves to
//    XLA around it: ops.combine_partials_stats (the flattened segment
//    log-sum-exp, its "TPU-native form of the paper's parallel tree
//    reduction") and ops.single_page_attention (the growing tail page).
//    Per query b and head h, in this order, as the plain version computes
//    them:
//      - the segment: the query's live partial rows, from a CSR over the
//        backend's flattened partials (seg_offsets[b] .. seg_offsets[b+1]
//        of seg_rows, rows ascending).  m_f = max(their m, -1e30),
//        a_r = exp(m_r - m_f) * l_r, l_f = sum a_r,
//        o_f = (sum o_r * a_r) / max(l_f, 1e-30).  Rows outside the CSR
//        (dead task slots, the trash row) are never read, so they may hold
//        NaN.
//      - the tail page: token j of page tail_pages[b] sits at position
//        tail_base[b] + j and is visible when pos <= q_pos[b] (and
//        pos > q_pos[b] - window for a window); s = (q . k) * scale,
//        masked scores -1e30, m_t = max, p = exp(s - m_t), l_t = sum p,
//        o_t = (sum p v) / max(l_t, 1e-30).  Invisible tokens are never
//        read.
//      - POR of (o_f, m_f, l_f) and (o_t, m_t, l_t) as above, o written in
//        q's type (bf16 rounded to nearest even, as torch casts).
//    Products and sums of the reduction and the merge are rounded
//    separately (__fmul_rn / __fadd_rn), in the plain version's order: on
//    one query the segment is summed row by row, as index_add_ does on the
//    CPU.  Nothing is summed with atomics, so two launches give the same
//    bits.
//
//    What bounds it: at the serve's shapes (8 queries, 32 query heads over
//    8 KV heads, d = 128, f32 pool, ~12 live partial rows a query) it moves
//    ~1.6 MB of partial rows, ~1 MB of tail K/V and 0.13 MB of q and
//    output, ~0.8 us at 3.35 TB/s; its FLOPs are negligible.  Latency
//    bounds it: the launch, then a chain of dependent loads (CSR -> row
//    ids -> partial rows; tail page id -> tail K/V).  The design keeps
//    that chain short and overlaps its two branches:
//      - one block per (query, KV head), one warp per query head of the
//        group (1-8 warps); a lane holds d/32 contiguous columns of q, of
//        each partial row and of the output, read and written as vectors;
//      - the block first issues cp.async copies of the tail page's visible
//        K and V rows for its KV head into shared memory, straight from the
//        pool page (no gather copy), then does the segment while they fly;
//      - a warp reads up to 32 rows' m and l in one load and takes the
//        segment max with shuffles; the o rows of up to 64/(d/32) partials
//        are all issued before the weighted sum consumes them, the first
//        of them together with the m and l loads;
//      - the tail scores: each lane dots its columns of q with every
//        visible K row in shared memory, and one transposing butterfly (31
//        shuffles for 32 scores) leaves the score of token `lane` in lane
//        `lane`; p is broadcast back by shuffle for the V sum.
//    It takes d = 64, 128 and 256, groups of 1 to 8 query heads per KV
//    head, pages of 16 and 64 tokens, f32 or bf16 q and f32 or bf16 KV, and
//    refuses anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    por_kernel(const float* __restrict__ o1, const float* __restrict__ m1,
               const float* __restrict__ l1, const float* __restrict__ o2,
               const float* __restrict__ m2, const float* __restrict__ l2,
               float* __restrict__ o, float* __restrict__ m,
               float* __restrict__ l, long long rows, int d) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * d) return;
  const long long r = i / d;
  const int c = (int)(i - r * d);
  const float mr1 = m1[r], mr2 = m2[r];
  const float mx = fmaxf(mr1, mr2);
  const float a1 = __fmul_rn(expf(mr1 - mx), l1[r]);
  const float a2 = __fmul_rn(expf(mr2 - mx), l2[r]);
  const float ll = __fadd_rn(a1, a2);
  const float num = __fadd_rn(__fmul_rn(o1[i], a1), __fmul_rn(o2[i], a2));
  o[i] = __fdiv_rn(num, fmaxf(ll, 1e-30f));
  if (c == 0) {
    m[r] = mx;
    l[r] = ll;
  }
}

// ------------------------------------------------------------------------
// The decode-attention epilogue
// ------------------------------------------------------------------------

using codec::cp_async16;
using codec::cp_async_commit;
using codec::cp_async_wait;
using codec::kFullMask;
using codec::reduce_rounds;

constexpr float kMask = -1e30f;  // the plain versions' MASK_VALUE
constexpr int kMaxGroup = 8;     // query heads per KV head (warps a block)

struct EpiArgs {
  const void* q;                // (B, h_q, d), f32 or bf16
  const float* o_parts;         // (P, h_q, d) backend partials
  const float* m_parts;         // (P, h_q)
  const float* l_parts;         // (P, h_q)
  const int* seg_offsets;       // (B+1,) CSR over the live partial rows
  const int* seg_rows;          // (nnz,)
  const void* k_pool;           // (pages, page, n_kv, d), f32 or bf16
  const void* v_pool;
  const long long* tail_pages;  // (B,) each query's tail page
  const long long* tail_base;   // (B,) absolute position of its token 0
  const long long* q_pos;       // (B,) the query's position
  void* out;                    // (B, h_q, d) in q's type
  float* out_m;                 // (B, h_q) or null
  float* out_l;                 // (B, h_q) or null
  int h_q, n_kv, page, window;
  float scale;
};

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
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
    }
  }
}

template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&x)[C]) {
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

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 2) {
      *reinterpret_cast<float2*>(p + i) = make_float2(x[i], x[i + 1]);
    }
  }
}

template <int C>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&x)[C]) {
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Grid (n_kv, B), one warp per query head of the KV head's group.
template <int D, typename QT, typename KT>
__global__ void __launch_bounds__(kMaxGroup * 32)
    epilogue_kernel(const EpiArgs a) {
  constexpr int C = D / 32;                // columns of a lane
  constexpr int kInFlight = 64 / C;        // partial rows loaded at once
  constexpr int kPieces = D * (int)sizeof(KT) / 16;  // 16-byte row pieces
  constexpr int kPieceElems = 16 / (int)sizeof(KT);
  extern __shared__ __align__(16) unsigned char smem[];
  KT* ks = reinterpret_cast<KT*>(smem);
  KT* vs = ks + a.page * D;

  const int g = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int h = g * (blockDim.x >> 5) + (threadIdx.x >> 5);

  // 1. the tail page: visible tokens j0..j1, copied to shared memory
  const long long qp = a.q_pos[b];
  const long long base = a.tail_base[b];
  const long long hi = qp - base;
  const long long lo = a.window > 0 ? qp - a.window + 1 - base : 0;
  const int j1 = (int)(hi < a.page - 1 ? hi : a.page - 1);
  const int j0 = (int)(lo > 0 ? lo : 0);
  {
    const size_t row = (size_t)a.n_kv * D;
    const size_t first = ((size_t)a.tail_pages[b] * a.page * a.n_kv + g) * D;
    const KT* kp = static_cast<const KT*>(a.k_pool) + first;
    const KT* vp = static_cast<const KT*>(a.v_pool) + first;
    const int n = (j1 - j0 + 1) * kPieces;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = j0 + i / kPieces;
      const int c = (i % kPieces) * kPieceElems;
      cp_async16(ks + j * D + c, kp + j * row + c, 16);
      cp_async16(vs + j * D + c, vp + j * row + c, 16);
    }
    cp_async_commit();
  }

  float qv[C];
  {
    const QT* qr = static_cast<const QT*>(a.q) + ((size_t)b * a.h_q + h) * D +
                   lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) qv[c] = to_f32(qr[c]);
  }

  // 2. the segment of query b: max, then the weighted sums row by row.
  // The first kInFlight o rows are issued with the m and l loads: their
  // addresses need only the row ids, not the segment max.
  const int s0 = a.seg_offsets[b], s1 = a.seg_offsets[b + 1];
  int r0 = 0;
  float m0 = kMask, l0 = 0.f, mx = -INFINITY;
  if (s0 + lane < s1) {
    r0 = a.seg_rows[s0 + lane];
    m0 = a.m_parts[(size_t)r0 * a.h_q + h];
    l0 = a.l_parts[(size_t)r0 * a.h_q + h];
    mx = m0;
  }
  float ov[kInFlight][C];
  const auto issue_rows = [&](int r, int k0, int n) {
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int rk = __shfl_sync(kFullMask, r, (k0 + k) & 31);
      if (k0 + k < n) {
        load_cols<C>(a.o_parts + ((size_t)rk * a.h_q + h) * D + lane * C,
                     ov[k]);
      }
    }
  };
  issue_rows(r0, 0, min(32, s1 - s0));
  for (int s = s0 + 32; s < s1; s += 32) {
    if (s + lane < s1) {
      const int r = a.seg_rows[s + lane];
      mx = fmaxf(mx, a.m_parts[(size_t)r * a.h_q + h]);
    }
  }
  const float m_f = fmaxf(warp_max(mx), kMask);

  float l_f = 0.f, num[C];
#pragma unroll
  for (int c = 0; c < C; ++c) num[c] = 0.f;
  for (int s = s0; s < s1; s += 32) {
    const int n = min(32, s1 - s);
    int r = r0;
    float alpha = 0.f;
    if (s == s0) {
      if (lane < n) alpha = __fmul_rn(expf(m0 - m_f), l0);
    } else if (lane < n) {
      r = a.seg_rows[s + lane];
      alpha = __fmul_rn(expf(a.m_parts[(size_t)r * a.h_q + h] - m_f),
                        a.l_parts[(size_t)r * a.h_q + h]);
    }
    for (int k0 = 0; k0 < n; k0 += kInFlight) {
      if (s != s0 || k0 != 0) issue_rows(r, k0, n);
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const float w = __shfl_sync(kFullMask, alpha, (k0 + k) & 31);
        if (k0 + k < n) {
          l_f = __fadd_rn(l_f, w);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            num[c] = __fadd_rn(num[c], __fmul_rn(ov[k][c], w));
          }
        }
      }
    }
  }

  // 3. the tail page's partial, once its rows have landed
  cp_async_wait<0>();
  __syncthreads();
  float st[2] = {kMask, kMask};  // scores of tokens lane and 32 + lane
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    if (ch * 32 < a.page) {
      float part[32];
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const int j = ch * 32 + jj;
        part[jj] = 0.f;
        if (j >= j0 && j <= j1) {
          float kv[C];
          load_cols<C>(ks + j * D + lane * C, kv);
#pragma unroll
          for (int c = 0; c < C; ++c) part[jj] = fmaf(qv[c], kv[c], part[jj]);
        }
      }
      reduce_rounds<32, 16>(part, lane);
      const int j = ch * 32 + lane;
      if (j >= j0 && j <= j1) st[ch] = __fmul_rn(part[0], a.scale);
    }
  }
  const float m_t = warp_max(fmaxf(st[0], st[1]));
  float p[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const int j = ch * 32 + lane;
    p[ch] = (j >= j0 && j <= j1) ? expf(st[ch] - m_t) : 0.f;
  }
  const float l_t = warp_sum(p[0] + p[1]);
  float u[C];
#pragma unroll
  for (int c = 0; c < C; ++c) u[c] = 0.f;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const int jlo = max(j0 - ch * 32, 0), jhi = min(j1 - ch * 32, 31);
    for (int jj = jlo; jj <= jhi; ++jj) {
      const float pj = __shfl_sync(kFullMask, p[ch], jj);
      float vv[C];
      load_cols<C>(vs + (ch * 32 + jj) * D + lane * C, vv);
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = fmaf(pj, vv[c], u[c]);
    }
  }

  // 4. POR of the segment's and the tail's partials, written in q's type
  const float m = fmaxf(m_f, m_t);
  const float a1 = __fmul_rn(expf(m_f - m), l_f);
  const float a2 = __fmul_rn(expf(m_t - m), l_t);
  const float l = __fadd_rn(a1, a2);
  const float d_f = fmaxf(l_f, 1e-30f), d_t = fmaxf(l_t, 1e-30f);
  const float d = fmaxf(l, 1e-30f);
  float o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float o_f = __fdiv_rn(num[c], d_f);
    const float o_t = __fdiv_rn(u[c], d_t);
    o[c] = __fdiv_rn(__fadd_rn(__fmul_rn(o_f, a1), __fmul_rn(o_t, a2)), d);
  }
  const size_t row = (size_t)b * a.h_q + h;
  store_cols<C>(static_cast<QT*>(a.out) + row * D + lane * C, o);
  if (lane == 0 && a.out_m != nullptr) {
    a.out_m[row] = m;
    a.out_l[row] = l;
  }
}

template <int D, typename QT, typename KT>
cudaError_t launch_epilogue(const EpiArgs& a, int B, int group,
                            cudaStream_t stream) {
  static size_t allowed = 48 << 10;  // raised once past the default cap
  const size_t smem = 2 * (size_t)a.page * D * sizeof(KT);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        epilogue_kernel<D, QT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  epilogue_kernel<D, QT, KT>
      <<<dim3(a.n_kv, B), group * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t epilogue_for_types(const EpiArgs& a, int B, int group,
                               int q_bf16, int kv_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (q_bf16) {
    return kv_bf16 ? launch_epilogue<D, BF, BF>(a, B, group, s)
                   : launch_epilogue<D, BF, float>(a, B, group, s);
  }
  return kv_bf16 ? launch_epilogue<D, float, BF>(a, B, group, s)
                 : launch_epilogue<D, float, float>(a, B, group, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int codec_por(const void* o1, const void* m1, const void* l1,
                         const void* o2, const void* m2, const void* l2,
                         void* o, void* m, void* l, long long rows, int d,
                         void* stream) {
  const long long total = rows * d;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  por_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o1), static_cast<const float*>(m1),
      static_cast<const float*>(l1), static_cast<const float*>(o2),
      static_cast<const float*>(m2), static_cast<const float*>(l2),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      rows, d);
  return static_cast<int>(cudaGetLastError());
}

// The epilogue over B queries; out_m / out_l may be null.  Returns the
// cudaError_t of the launch (0 = success), cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int codec_por_epilogue(
    const void* q, int q_bf16, const void* o_parts, const void* m_parts,
    const void* l_parts, const void* seg_offsets, const void* seg_rows,
    const void* k_pool, const void* v_pool, int kv_bf16,
    const void* tail_pages, const void* tail_base, const void* q_pos,
    void* out, void* out_m, void* out_l, int B, int h_q, int n_kv, int d,
    int page, int window, float scale, void* stream) {
  const int group = n_kv > 0 ? h_q / n_kv : 0;
  if (n_kv <= 0 || h_q % n_kv || group < 1 || group > kMaxGroup ||
      (d != 64 && d != 128 && d != 256) || (page != 16 && page != 64) ||
      B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  EpiArgs a;
  a.q = q;
  a.o_parts = static_cast<const float*>(o_parts);
  a.m_parts = static_cast<const float*>(m_parts);
  a.l_parts = static_cast<const float*>(l_parts);
  a.seg_offsets = static_cast<const int*>(seg_offsets);
  a.seg_rows = static_cast<const int*>(seg_rows);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.tail_pages = static_cast<const long long*>(tail_pages);
  a.tail_base = static_cast<const long long*>(tail_base);
  a.q_pos = static_cast<const long long*>(q_pos);
  a.out = out;
  a.out_m = static_cast<float*>(out_m);
  a.out_l = static_cast<float*>(out_l);
  a.h_q = h_q;
  a.n_kv = n_kv;
  a.page = page;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64) {
    err = epilogue_for_types<64>(a, B, group, q_bf16, kv_bf16, s);
  } else if (d == 128) {
    err = epilogue_for_types<128>(a, B, group, q_bf16, kv_bf16, s);
  } else {
    err = epilogue_for_types<256>(a, B, group, q_bf16, kv_bf16, s);
  }
  return static_cast<int>(err);
}
