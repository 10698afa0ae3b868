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
//        group up to 8 warps; a wider group (16, 32) shares 8 warps (or the
//        largest divisor of the group below 8), each taking group / warps
//        heads in turn, so a thread keeps the registers of one head; a lane
//        holds d/32 contiguous columns of q, of each partial row and of the
//        output, read and written as vectors;
//      - the block first issues cp.async copies of the tail page's visible
//        K and V rows for its KV head into shared memory, straight from the
//        pool page (no gather copy), then does the first head's segment
//        while they fly.  K and V are staged whole where the page is at
//        most 128 tokens and both fit in 128 KB (every such page but f32
//        KV at d = 256 past 64 tokens); past that they go in passes of 128
//        tokens (64 for f32 KV at d = 256), re-staged for each of a warp's
//        heads, and the tail's softmax is carried online across the passes
//        (the sums scaled by exp(m_old - m_new)), so a page of any length
//        runs;
//      - a warp reads up to 32 rows' m and l in one load and takes the
//        segment max with shuffles; the o rows of up to 64/(d/32) partials
//        are all issued before the weighted sum consumes them, the first
//        of them together with the m and l loads;
//      - the tail scores: each lane dots its columns of q with every
//        visible K row in shared memory, and one transposing butterfly (31
//        shuffles for 32 scores) leaves the score of token `lane` in lane
//        `lane`, up to 4 such rounds for a page of up to 128 tokens (a
//        page that is not a multiple of 32 leaves the last round's lanes
//        past it at the mask); p is broadcast back by shuffle for the V
//        sum.
//    It takes every head dim d with d % 16 == 0 and 16 <= d <= 256 (64,
//    128 and 256 in instances of their own, any other in the 256-column
//    one: a lane whose columns lie past d holds q = 0, and reads and
//    writes nothing there),
//    any number of query heads per KV head, any page from 1 to 2^20 - 1
//    tokens (PAC's bound), f32 or bf16 q and f32 or bf16 KV, and refuses
//    anything else.
//
//    The mesh's two options (the sharded step runs the epilogue once per
//    shard and then merges the shards' partials across the data axis):
//      - owner (B,) int64, may be null: a query whose owner flag is 0 does
//        not have its tail page on this shard.  Its tail partial is the POR
//        identity (o_t = 0, m_t = -1e30, l_t = 0), no tail slot is staged
//        or read, and the POR below runs as for any query: the arithmetic
//        of the JAX package's sharded step, which selects the identity
//        after computing the tail over its trash page.
//      - out_f32: o is written in float32 whatever q's type, so the
//        cross-shard merge sees the unrounded partial; the cast comes
//        after it.
//
//    With tail = 0 (the speculative verify step, whose plan already covers
//    every page: tail pages and one-token draft pages included) it does the
//    segment and the cast only: o = o_f, m = m_f, l = l_f, the arithmetic of
//    ops.combine_partials_stats and nothing more.  No tail page is staged or
//    read (the pools, tail_pages, tail_base and q_pos may be null, and the
//    page size is not checked) and no POR follows: merging an empty tail
//    would divide o_f * l_f by l_f again and change the last bits.  A query
//    with an empty segment (a padded row) comes out 0 with m = -1e30, l = 0.
//
//
//    The mesh's cross-shard merge, codec_mesh_merge, lives in
//    mesh_merge.cu.

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
using codec::load_cols;
using codec::reduce_rounds;
using codec::store_cols;

constexpr float kMask = -1e30f;  // the plain versions' MASK_VALUE
constexpr int kMaxWarps = 8;     // warps a block (query heads at a time)
// shared memory for the tail page: a pass stages up to kTailPass tokens
// of K and V (a page up to that whole), or kTailChunk where kTailPass
// tokens of both would pass kTailSmem
constexpr size_t kTailSmem = 128 << 10;
constexpr int kTailPass = 128;
constexpr int kTailChunk = 64;
constexpr int kMaxPage = 1 << 20;  // PAC's bound too (20 bits of kvlen)

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
  const long long* owner;       // (B,) or null: 0 = tail not on this shard
  void* out;                    // (B, h_q, d) in q's type, or float32
  float* out_m;                 // (B, h_q) or null
  float* out_l;                 // (B, h_q) or null
  int h_q, n_kv, d, page, window;
  int tc;    // tail tokens staged a pass: the page, kTailPass or kTailChunk
  int tail;  // 0: segment and cast only (no tail page, no POR)
  int out_f32;  // 1: out is float32 whatever q's type
  float scale;
};

// o of one query head: columns lane*C.. of row `row` (rows of dd
// elements), in q's type or float32; nothing for a lane past d
template <int C, typename QT>
__device__ __forceinline__ void store_out(const EpiArgs& a, size_t row,
                                          int dd, int lane, bool live,
                                          const float (&o)[C]) {
  if (!live) return;
  if (a.out_f32) {
    store_cols<C>(static_cast<float*>(a.out) + row * dd + lane * C, o);
  } else {
    store_cols<C>(static_cast<QT*>(a.out) + row * dd + lane * C, o);
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

// Stages tokens s0..s1 (inclusive) of the tail page's rows for KV head g
// into shared memory, token j at row j - c0 (rows of D elements, of which
// the first dd, the head dim, are copied): every thread of the block
// issues its share of 16-byte cp.async copies, straight from the pool.
template <int D, typename KT>
__device__ __forceinline__ void stage_tail(const EpiArgs& a, int dd, KT* ks,
                                           KT* vs, int b, int g, int s0,
                                           int s1, int c0) {
  constexpr int kPieceElems = 16 / (int)sizeof(KT);
  const int pieces = dd / kPieceElems;  // 16-byte pieces of a row
  const size_t row = (size_t)a.n_kv * dd;
  const size_t first = ((size_t)a.tail_pages[b] * a.page * a.n_kv + g) * dd;
  const KT* kp = static_cast<const KT*>(a.k_pool) + first;
  const KT* vp = static_cast<const KT*>(a.v_pool) + first;
  const int n = (s1 - s0 + 1) * pieces;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = s0 + i / pieces;
    const int c = (i % pieces) * kPieceElems;
    cp_async16(ks + (j - c0) * D + c, kp + j * row + c, 16);
    cp_async16(vs + (j - c0) * D + c, vp + j * row + c, 16);
  }
}

// Grid (n_kv, B).  The block's warps share the KV head's group of query
// heads: nw warps (a divisor of the group, at most kMaxWarps), each taking
// group / nw heads one after another (heads g * group + it * nw + warp).
// kWide is false where a warp takes one head and the page (up to 64
// tokens) is staged whole: then the head loop and the tail's stage loop
// run once, known at compile time, and the tail takes two 32-token rounds.
// D is the head dim d (kExact) or, for any d other than 64, 128 and 256,
// 256: a lane holds D / 32 columns, and a lane whose columns lie past d
// (d % 16 == 0, so none straddles it) holds q = 0, reads nothing and
// writes nothing.  kExact keeps the row stride a constant and every lane
// live.
template <int D, typename QT, typename KT, bool kWide, bool kExact>
__global__ void __launch_bounds__(kMaxWarps * 32)
    epilogue_kernel(const EpiArgs a) {
  constexpr int C = D / 32;                // columns of a lane
  constexpr int kInFlight = C == 1 ? 32 : 64 / C;  // partial rows at once
  constexpr int kRounds = kWide ? kTailPass / 32 : 2;  // of the tail, a pass
  extern __shared__ __align__(16) unsigned char smem[];
  KT* ks = reinterpret_cast<KT*>(smem);
  KT* vs = ks + a.tc * D;

  const int g = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int group = a.h_q / a.n_kv;
  const int dd = kExact ? D : a.d;   // the rows' stride, the head dim
  const bool live = kExact || lane * C < dd;  // columns below d

  // 1. the tail page (tail mode, on the shard that holds it): visible
  // tokens j0..j1.  Its first tc tokens (the whole page where K and V fit
  // in shared memory together) are copied now and land while the first
  // head's segment is reduced.  A non-owner keeps j0 > j1: its tail
  // partial comes out as the POR identity.
  int j0 = 0, j1 = -1;
  if (a.tail && (a.owner == nullptr || a.owner[b] != 0)) {
    const long long qp = a.q_pos[b];
    const long long base = a.tail_base[b];
    const long long hi = qp - base;
    const long long lo = a.window > 0 ? qp - a.window + 1 - base : 0;
    j1 = (int)(hi < a.page - 1 ? hi : a.page - 1);
    j0 = (int)(lo > 0 ? lo : 0);
    stage_tail<D, KT>(a, dd, ks, vs, b, g, j0, min(j1, a.tc - 1), 0);
  }
  if (a.tail) cp_async_commit();

  const int heads = kWide ? group / nw : 1;
  for (int it = 0; it < heads; ++it) {
    const int h = g * group + it * nw + warp;
    float qv[C];
    {
      const QT* qr = static_cast<const QT*>(a.q) +
                     ((size_t)b * a.h_q + h) * dd + lane * C;
#pragma unroll
      for (int c = 0; c < C; ++c) qv[c] = live ? to_f32(qr[c]) : 0.f;
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
        if (k0 + k < n && live) {
          load_cols<C>(a.o_parts + ((size_t)rk * a.h_q + h) * dd + lane * C,
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

    const size_t row = (size_t)b * a.h_q + h;
    if (!a.tail) {
      // the segment alone, as ops.combine_partials_stats leaves it
      const float d_f = fmaxf(l_f, 1e-30f);
      float o[C];
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = __fdiv_rn(num[c], d_f);
      store_out<C, QT>(a, row, dd, lane, live, o);
      if (lane == 0 && a.out_m != nullptr) {
        a.out_m[row] = m_f;
        a.out_l[row] = l_f;
      }
      continue;
    }

    // 3. the tail page's partial, tc tokens at a time.  Where the page is
    // staged whole (tc = page) there is one pass, and its arithmetic is
    // the plain softmax: m_t the max, p = exp(s - m_t), l_t the sum of p.
    // Past that, each pass re-stages its tokens (every warp has finished
    // with the last ones at the barrier) and folds them in online: the
    // earlier sums are scaled by exp(m_old - m_new).  j0, j1, tc and the
    // head count are the block's, so every warp meets every barrier.
    float m_t = kMask, l_t = 0.f, u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = 0.f;
    for (int c0 = 0; kWide ? c0 < a.page : c0 == 0; c0 += a.tc) {
      const int cj0 = max(j0, c0), cj1 = min(j1, c0 + a.tc - 1);
      if (cj0 > cj1) continue;             // no visible token here
      if (kWide && a.tc < a.page && (it > 0 || c0 > 0)) {
        __syncthreads();
        stage_tail<D, KT>(a, dd, ks, vs, b, g, cj0, cj1, c0);
        cp_async_commit();
      }
      if (!kWide || a.tc < a.page || it == 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
      float st[kRounds];  // scores of tokens c0 + 32 ch + lane
#pragma unroll
      for (int ch = 0; ch < kRounds; ++ch) st[ch] = kMask;
#pragma unroll
      for (int ch = 0; ch < kRounds; ++ch) {
        if (c0 + ch * 32 <= cj1 && c0 + ch * 32 + 31 >= cj0) {
          float part[32];
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int j = c0 + ch * 32 + jj;
            part[jj] = 0.f;
            if (live && j >= cj0 && j <= cj1) {
              float kv[C];
              load_cols<C>(ks + (j - c0) * D + lane * C, kv);
#pragma unroll
              for (int c = 0; c < C; ++c) {
                part[jj] = fmaf(qv[c], kv[c], part[jj]);
              }
            }
          }
          reduce_rounds<32, 16>(part, lane);
          const int j = c0 + ch * 32 + lane;
          if (j >= cj0 && j <= cj1) st[ch] = __fmul_rn(part[0], a.scale);
        }
      }
      float sm = st[0];
#pragma unroll
      for (int ch = 1; ch < kRounds; ++ch) sm = fmaxf(sm, st[ch]);
      const float m_new = fmaxf(m_t, warp_max(sm));
      float p[kRounds], ps = 0.f;
#pragma unroll
      for (int ch = 0; ch < kRounds; ++ch) {
        const int j = c0 + ch * 32 + lane;
        p[ch] = (j >= cj0 && j <= cj1) ? expf(st[ch] - m_new) : 0.f;
        ps += p[ch];
      }
      if constexpr (kWide) {  // fold the earlier passes in: one pass alone
        const float alpha = expf(m_t - m_new);  // leaves them at 0
        l_t = l_t * alpha + warp_sum(ps);
#pragma unroll
        for (int c = 0; c < C; ++c) u[c] *= alpha;
      } else {
        l_t = warp_sum(ps);
      }
#pragma unroll
      for (int ch = 0; ch < kRounds; ++ch) {
        const int jlo = max(cj0 - c0 - ch * 32, 0);
        const int jhi = min(cj1 - c0 - ch * 32, 31);
        for (int jj = jlo; jj <= jhi; ++jj) {
          const float pj = __shfl_sync(kFullMask, p[ch], jj);
          if (live) {
            float vv[C];
            load_cols<C>(vs + (ch * 32 + jj) * D + lane * C, vv);
#pragma unroll
            for (int c = 0; c < C; ++c) u[c] = fmaf(pj, vv[c], u[c]);
          }
        }
      }
      m_t = m_new;
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
    store_out<C, QT>(a, row, dd, lane, live, o);
    if (lane == 0 && a.out_m != nullptr) {
      a.out_m[row] = m;
      a.out_l[row] = l;
    }
  }
}

template <int D, typename QT, typename KT, bool kWide, bool kExact>
cudaError_t launch_epilogue_as(const EpiArgs& a, int B, int warps,
                               cudaStream_t stream) {
  static size_t allowed = 48 << 10;  // raised once past the default cap
  const size_t smem = a.tail ? 2 * (size_t)a.tc * D * sizeof(KT) : 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        epilogue_kernel<D, QT, KT, kWide, kExact>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  epilogue_kernel<D, QT, KT, kWide, kExact>
      <<<dim3(a.n_kv, B), warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// d 64, 128 and 256 run in their own instances; any other d in the
// general (wide) 256-column one, the lanes past d masked.
template <int D, typename QT, typename KT>
cudaError_t launch_epilogue(const EpiArgs& a, int B, int warps,
                            cudaStream_t stream) {
  if constexpr (D == 256) {
    if (a.d != D) {
      return launch_epilogue_as<D, QT, KT, true, false>(a, B, warps,
                                                        stream);
    }
  }
  const bool wide = a.h_q / a.n_kv != warps || a.tc != a.page ||
                    a.page > 64;
  return wide ? launch_epilogue_as<D, QT, KT, true, true>(a, B, warps, stream)
              : launch_epilogue_as<D, QT, KT, false, true>(a, B, warps,
                                                           stream);
}

template <int D>
cudaError_t epilogue_for_types(const EpiArgs& a, int B, int warps,
                               int q_bf16, int kv_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (q_bf16) {
    return kv_bf16 ? launch_epilogue<D, BF, BF>(a, B, warps, s)
                   : launch_epilogue<D, BF, float>(a, B, warps, s);
  }
  return kv_bf16 ? launch_epilogue<D, float, BF>(a, B, warps, s)
                 : launch_epilogue<D, float, float>(a, B, warps, s);
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

// The epilogue over B queries; out_m / out_l and owner may be null, and with
// tail = 0 so may k_pool, v_pool, tail_pages, tail_base and q_pos.  out is
// float32 when out_f32 is 1, else of q's type.  Returns the
// cudaError_t of the launch (0 = success), cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int codec_por_epilogue(
    const void* q, int q_bf16, const void* o_parts, const void* m_parts,
    const void* l_parts, const void* seg_offsets, const void* seg_rows,
    const void* k_pool, const void* v_pool, int kv_bf16,
    const void* tail_pages, const void* tail_base, const void* q_pos,
    const void* owner, void* out, int out_f32, void* out_m, void* out_l,
    int B, int h_q, int n_kv, int d,
    int page, int window, int tail, float scale, void* stream) {
  const int group = n_kv > 0 ? h_q / n_kv : 0;
  if (n_kv <= 0 || h_q % n_kv || group < 1 || !codec::head_dim_taken(d) ||
      (tail && (page < 1 || page >= kMaxPage)) || B < 0) {
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
  a.owner = static_cast<const long long*>(owner);
  a.out = out;
  a.out_f32 = out_f32 ? 1 : 0;
  a.out_m = static_cast<float*>(out_m);
  a.out_l = static_cast<float*>(out_l);
  a.h_q = h_q;
  a.n_kv = n_kv;
  a.d = d;
  a.page = tail ? page : 1;
  // the instance: d's own at 64, 128 and 256, else the 256-column one
  const int D = d == 64 || d == 128 ? d : 256;
  // a pass stages the whole page where it fits, else kTailPass or
  // kTailChunk tokens of rows of the instance's D columns
  const size_t row = 2 * (size_t)D * (kv_bf16 ? 2 : 4);
  a.tc = a.page <= kTailPass && a.page * row <= kTailSmem ? a.page
         : kTailPass * row <= kTailSmem                  ? kTailPass
                                                         : kTailChunk;
  a.window = window;
  a.tail = tail ? 1 : 0;
  a.scale = scale;
  // a warp a query head up to kMaxWarps; a wider group shares the
  // block's warps, each taking group / warps heads in turn
  int warps = group < kMaxWarps ? group : kMaxWarps;
  while (group % warps) --warps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = epilogue_for_types<64>(a, B, warps, q_bf16, kv_bf16, s);
  } else if (D == 128) {
    err = epilogue_for_types<128>(a, B, warps, q_bf16, kv_bf16, s);
  } else {
    err = epilogue_for_types<256>(a, B, warps, q_bf16, kv_bf16, s);
  }
  return static_cast<int>(err);
}
