// FlashDecoding baseline (dense-batch decode attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:91
// (flash_decode, kernel body _fd_kernel): row b's single query attends over
// its own KV positions [max(0, kv_len_b - window), min(kv_len_b, L)) of
// dense (B, L, n_kv, d) K and V (no window: from 0); GQA is folded per KV
// head (query head h reads KV head h / group); the softmax is an f32 online
// softmax with scale 1/sqrt(d) and mask value -1e30 (never -inf); the output
// has q's type and an empty row gives 0.  q and KV types are independent
// (f32 or bf16 each).  Like the TPU kernel it takes any group h_q / n_kv;
// the head dim is any d with d % 16 == 0 and 16 <= d <= 256, run in the
// instance of the next of 32, 64, 128 and 256 columns (instance_dim)
// with the columns past d masked.
//
// What bounds it on the H100: bytes.  It must read
//   sum_b visible_b * n_kv * d * esize * 2
// bytes of K and V, plus q and the output, and does 4 * group FLOPs per
// (K, V) element pair: far below the card's ridge (about 295 FLOPs a byte
// in bf16), so HBM at 3.35 TB/s is the bound, and every visible KV byte is
// read from HBM once.  The tensor cores here take the arithmetic off the
// CUDA cores; they are not there to reach the card's peak.
//
// Design.
//  * Work split by each row's own length.  A block takes T consecutive
//    visible positions (the wrapper's `split`, a multiple of kTile) of one
//    (row, KV head): row b gets ceil(visible_b / T) live blocks, each with
//    the same work, and the grid (n_kv x chunks, S, B) is sized from L
//    (S = ceil(min(L, window) / T)), which the host knows; a block past
//    its row's range exits at once.  Grid x runs over the KV heads, so the
//    blocks that run together read every head of the same positions.  The
//    wrapper picks T from the batch and the SM count (split_tokens in
//    flash_decode.py).  Pass 2 merges only a row's live pieces by
//    log-sum-exp, so a short row costs its own blocks, not the longest
//    row's.
//  * Staged copies.  A ring of kStages tiles in dynamic shared memory,
//    each kTile tokens of K and V of the block's KV head, filled by 16-byte
//    cp.async copies kStages - 1 tiles ahead of the tile being computed
//    (as pac.cu does); one barrier a tile publishes the landed tile and
//    frees the stage the next copy refills.  Tokens past the block's range
//    are zero-filled by the copy itself (nothing is read for them), so NaN
//    past kv_len cannot reach a product; columns past d are never copied
//    and never read.
//  * bf16 KV: tensor cores over the whole group of the KV head.  A team of
//    4 warps holds up to 16 query heads (N = 8 or 16: one or two n-tiles
//    of 8 heads) and computes S^T = K_tile . Q^T with mma.sync m16n8k16
//    (tokens along M, 16 a warp; heads along N; k = d): K by ldmatrix from
//    the stage, Q from shared memory, where the block stages it once.  The
//    team's column (head) maxima meet in shared memory, so its four warps
//    share one online softmax; each warp writes its P into shared memory,
//    and O^T = V^T . P^T runs on the tensor cores too, the warps splitting
//    d's 16-row m-tiles (V and P by ldmatrix.trans).  Each K/V byte of the
//    block's range is read once from HBM whatever the group: no idle-head
//    arithmetic past the n-tile (a group of 5 or 7 pads to 8 columns, not
//    to 8 heads of FFMA), no re-read chunks for groups up to 32, no
//    per-token shuffle butterflies.  A group wider than 16 takes a second
//    team over the same staged tile (256 threads: 32 heads, fig13's widest
//    group, in one block; two 16-head teams measured faster than one
//    32-head team at group 32, tools/kernel_ab.py); past 32 the group is
//    cut into chunks of 32 heads, each its own block over the same range.
//    An f32 q, and the f32 P of the PV product, enter as bf16 hi + lo terms
//    (codec::split_bf16, as PAC does): two products each, so the only
//    rounding left is ~2^-17 of each value; K and V are exact in bf16.  (A
//    form with a softmax of its own in each warp, P moved into PV's operand
//    by movmatrix and no barrier but the ring's, measured 5-12% slower.)
//  * f32 KV: CUDA cores (TF32 would break the 1e-5 parity), in the same
//    staged, token-tiled structure.  A block of 4 warps holds HG query
//    heads (1, 2, 4 or 8: the group rounded up to a power of two, at most
//    4 at d = 256, wider groups in chunks of HG), a lane C = D / 32
//    columns of each head's q and accumulator.  Each warp takes its kTW
//    tokens of every tile (kTW * HG = up to 32 scores): partial dot
//    products from the stage, one transposing butterfly (31 shuffles for
//    32 scores, codec::reduce_rounds), the row max over the head's lanes,
//    p through the warp's 32 floats of shared memory, and the P V
//    products from the stage; each warp keeps its own (m, l, acc), and the
//    block merges its warps by log-sum-exp at the end.
//  * Each block writes one partial (o normalised, m, l) per live query
//    head.  Pass 2 takes a (row, head) a block: its live pieces' m and l
//    into shared memory, their max and weighted sum, then a thread a
//    column sums the weighted pieces, every load independent.  A row with
//    no visible position ends 0 / max(0, 1e-30) = 0, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using codec::cp_async16;
using codec::cp_async_commit;
using codec::cp_async_wait;
using codec::reduce_rounds;

constexpr float kMask = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 64;        // the split T is a multiple of this
constexpr int kWarps = 4;        // warps of a team (bf16) or a block (f32)
constexpr int kMaxTeams = 2;     // teams of up to 16 heads a bf16 block
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory cap

struct FdArgs {
  const void* q;        // (B, h_q, d) float32 or bfloat16
  const void* k;        // (B, L, n_kv, d)
  const void* v;
  const int* kv_lens;   // (B,)
  float* o_part;        // (B, S, h_q, d)
  float* m_part;        // (B, S, h_q)
  float* l_part;
  void* out;            // (B, h_q, d) in q's type
  int q_bf16, L, h_q, n_kv, d, window;
  int split;            // T: visible positions a block takes
  int num_splits;       // S: grid x
  int group;            // h_q / n_kv
  int chunks;           // blocks a KV head: grid y = n_kv * chunks
  int heads;            // query heads a block holds
  float scale;
};

// The visible positions [lo, hi) of pass-1 block `split` of row b (empty
// past the row's range).
__device__ __forceinline__ void block_range(const FdArgs& a, int b,
                                            int split, int& lo, int& hi) {
  const int kv_len = a.kv_lens[b];
  const int vis_hi = min(kv_len, a.L);
  const int vis_lo = a.window > 0 ? max(0, kv_len - a.window) : 0;
  lo = vis_lo + split * a.split;
  hi = min(lo + a.split, vis_hi);
}

// Copies tile tokens [t0, t0 + TOK) of the block's range [.., hi) of row b,
// KV head kv, into a stage: K rows then V rows of LD elements, the first d
// of the instance's D columns of each.  Tokens at or past hi are
// zero-filled, reading nothing.
template <typename KVT, int TOK, int D, int LD>
__device__ __forceinline__ void load_tile(const FdArgs& a, int b, int kv,
                                          int t0, int hi, KVT* ks) {
  constexpr int kVec = 16 / (int)sizeof(KVT);
  constexpr int kPer = D / kVec;  // 16-byte pieces of an instance row
  KVT* vs = ks + TOK * LD;
  const size_t tok_stride = (size_t)a.n_kv * a.d;
  const size_t base = ((size_t)b * a.L * a.n_kv + kv) * a.d;
  const KVT* kp = static_cast<const KVT*>(a.k) + base;
  const KVT* vp = static_cast<const KVT*>(a.v) + base;
  for (int i = threadIdx.x; i < TOK * kPer; i += blockDim.x) {
    const int j = i / kPer, c = (i % kPer) * kVec;
    if (c >= a.d) continue;  // columns past d: never copied, never read
    const bool in = t0 + j < hi;
    const size_t off = in ? (size_t)(t0 + j) * tok_stride + c : 0;
    cp_async16(ks + j * LD + c, kp + off, in ? 16 : 0);
    cp_async16(vs + j * LD + c, vp + off, in ? 16 : 0);
  }
}

__device__ __forceinline__ float load_q(const FdArgs& a, size_t off) {
  return a.q_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
             : static_cast<const float*>(a.q)[off];
}

// The instance d runs in: the next of 32, 64, 128 and 256 columns.
__host__ __device__ constexpr int instance_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// C consecutive floats of shared memory (16-byte aligned for C >= 4), or
// zeros for a lane whose columns lie past d
template <int C>
__device__ __forceinline__ void ld_cols(const float* p, bool in,
                                        float (&x)[C]) {
  if (!in) {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = 0.f;
  } else if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      x[c] = v.x;
      x[c + 1] = v.y;
      x[c + 2] = v.z;
      x[c + 3] = v.w;
    }
  } else if constexpr (C == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// ------------------------------------------------------------------------
// bf16 KV: tensor cores
// ------------------------------------------------------------------------

// The layout of a bf16 block (host and device): D columns, NT n-tiles of
// 8 heads a team, qlo when q is f32 (split into hi + lo).  Rows of K, V
// and Q are padded by 16 bytes (ldmatrix is conflict-free), P's rows of NH
// heads to an odd number of 16-byte units.
__host__ __device__ constexpr int mma_ld(int D) { return D + 8; }
__host__ __device__ constexpr int mma_ldp(int NH) {
  return ((NH + 8) / 8) % 2 ? NH + 8 : NH + 16;
}
__host__ __device__ constexpr int mma_stages(int D) { return D >= 256 ? 2 : 3; }
__host__ __device__ constexpr size_t mma_ring_bytes(int D) {
  return (size_t)mma_stages(D) * 2 * kTile * mma_ld(D) * 2;
}
// a team: Q hi (and lo), P hi and lo, its warps' column maxima / sums
__host__ __device__ constexpr size_t mma_team_bytes(int D, int NT, bool qlo) {
  return (size_t)8 * NT * mma_ld(D) * 2 * (qlo ? 2 : 1) +
         (size_t)kTile * mma_ldp(8 * NT) * 2 * 2 + (size_t)kWarps * 8 * NT * 4;
}

template <int D, int NT, bool QLO>
struct MmaLayout {
  static constexpr int NH = 8 * NT;                  // heads a team
  static constexpr int kLd = mma_ld(D);
  static constexpr int kLdP = mma_ldp(NH);
  static constexpr int kStages = mma_stages(D);
  static constexpr int kStageElems = 2 * kTile * kLd;  // K then V
  static constexpr int kQElems = NH * kLd;
  static constexpr int kPElems = kTile * kLdP;
  static constexpr size_t kRingBytes = mma_ring_bytes(D);
  static constexpr size_t kTeamBytes = mma_team_bytes(D, NT, QLO);
  static constexpr int kMt = D / 16;                      // m-tiles of O^T
  static constexpr int kMtW = (kMt + kWarps - 1) / kWarps;  // a warp's
};

template <int D, int NT, bool QLO>
__global__ void __launch_bounds__(kMaxTeams * kWarps * 32)
    fd_mma_kernel(FdArgs a) {
  using Lay = MmaLayout<D, NT, QLO>;
  constexpr int NH = Lay::NH, kLd = Lay::kLd, kLdP = Lay::kLdP;
  constexpr int kStages = Lay::kStages;
  using BF = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.y, b = blockIdx.z;
  const int kv = blockIdx.x / a.chunks, chunk = blockIdx.x % a.chunks;
  int lo, hi;
  block_range(a, b, split, lo, hi);
  if (lo >= hi) return;  // past the row's range: the same for the block

  const int team = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int ln = threadIdx.x & 31, g4 = ln >> 2, t4 = ln & 3;
  // the team's heads: `first` .. first + live - 1 of the KV head's group
  const int first = chunk * a.heads + team * NH;
  const int live = max(0, min(NH, a.group - first));
  const int h0 = kv * a.group + first;
  const int nks = a.d / 16;  // k-steps of QK and m-tiles of PV below d

  BF* ring = reinterpret_cast<BF*>(smem);
  unsigned char* tm = smem + Lay::kRingBytes + team * Lay::kTeamBytes;
  BF* qh = reinterpret_cast<BF*>(tm);
  BF* ql = qh + (QLO ? Lay::kQElems : 0);
  BF* ph = ql + Lay::kQElems;
  BF* pl = ph + Lay::kPElems;
  float* red = reinterpret_cast<float*>(pl + Lay::kPElems);

  const int ntiles = (hi - lo + kTile - 1) / kTile;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) {
      load_tile<BF, kTile, D, kLd>(a, b, kv, lo + i * kTile, hi,
                                   ring + i * Lay::kStageElems);
    }
    cp_async_commit();
  }

  // the team's queries, as bf16 hi (+ lo): rows past the live heads and
  // columns past d are 0
  for (int i = threadIdx.x & 127; i < NH * D / 2; i += 128) {
    const int hh = i / (D / 2), c = (i - hh * (D / 2)) * 2;
    float x = 0.f, y = 0.f;
    if (hh < live && c < a.d) {
      const size_t off = ((size_t)b * a.h_q + h0 + hh) * a.d + c;
      x = load_q(a, off);
      y = load_q(a, off + 1);
    }
    uint32_t hi2, lo2;
    codec::split_bf16(x, y, hi2, lo2);
    *reinterpret_cast<uint32_t*>(qh + hh * kLd + c) = hi2;
    if (QLO) *reinterpret_cast<uint32_t*>(ql + hh * kLd + c) = lo2;
  }

  // the online softmax of the columns (heads) nt * 8 + 2 t4 + j this lane
  // holds, alike in every lane and warp of the team
  float m[NT][2], l[NT][2];
  float acc[Lay::kMtW][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[nt][j] = kMask;
      l[nt][j] = 0.f;
    }
#pragma unroll
    for (int mw = 0; mw < Lay::kMtW; ++mw) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mw][nt][e] = 0.f;
    }
  }

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed everywhere; tile t-1's stage is free
    if (t + kStages - 1 < ntiles) {
      load_tile<BF, kTile, D, kLd>(
          a, b, kv, lo + (t + kStages - 1) * kTile, hi,
          ring + ((t + kStages - 1) % kStages) * Lay::kStageElems);
    }
    cp_async_commit();
    const BF* ks = ring + (t % kStages) * Lay::kStageElems;
    const BF* vs = ks + kTile * kLd;
    const int t0 = lo + t * kTile;

    // S^T = K Q^T over the warp's 16 tokens: element e of n-tile nt is
    // token warp * 16 + g4 + 8 (e / 2), head nt * 8 + 2 t4 + e % 2
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    // A (K): matrix ln / 8 = (token half, column half)
    const BF* krow = ks + (warp * 16 + ((ln >> 3) & 1) * 8 + (ln & 7)) * kLd +
                     (ln >> 4) * 8;
    if constexpr (NT == 1) {
      // B (Q): one x4 load covers two k-steps of the 8 heads
      const int qoff = (ln & 7) * kLd + (ln >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        if (kk < nks) {
          uint32_t bq[4], bl[4], af[4];
          codec::ldmatrix_x4(bq, qh + qoff + kk * 16);
          if (QLO) codec::ldmatrix_x4(bl, ql + qoff + kk * 16);
          codec::ldmatrix_x4(af, krow + kk * 16);
          codec::mma_bf16(s[0], af, bq[0], bq[1]);
          if (QLO) codec::mma_bf16(s[0], af, bl[0], bl[1]);
          if (kk + 1 < nks) {
            codec::ldmatrix_x4(af, krow + (kk + 1) * 16);
            codec::mma_bf16(s[0], af, bq[2], bq[3]);
            if (QLO) codec::mma_bf16(s[0], af, bl[2], bl[3]);
          }
        }
      }
    } else {
      // B (Q): one x4 load covers one k-step of two n-tiles
      const int qoff =
          ((ln >> 4) * 8 + (ln & 7)) * kLd + ((ln >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk < nks) {
          uint32_t af[4];
          codec::ldmatrix_x4(af, krow + kk * 16);
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            uint32_t bq[4];
            codec::ldmatrix_x4(bq, qh + qoff + nt * 8 * kLd + kk * 16);
            codec::mma_bf16(s[nt], af, bq[0], bq[1]);
            codec::mma_bf16(s[nt + 1], af, bq[2], bq[3]);
            if (QLO) {
              codec::ldmatrix_x4(bq, ql + qoff + nt * 8 * kLd + kk * 16);
              codec::mma_bf16(s[nt], af, bq[0], bq[1]);
              codec::mma_bf16(s[nt + 1], af, bq[2], bq[3]);
            }
          }
        }
      }
    }

    // scores and the warp's column maxima over its 16 tokens
    const bool vis0 = t0 + warp * 16 + g4 < hi;
    const bool vis1 = t0 + warp * 16 + g4 + 8 < hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = (e < 2 ? vis0 : vis1) ? s[nt][e] * a.scale : kMask;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(s[nt][j], s[nt][j + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        if (g4 == 0) red[warp * NH + nt * 8 + 2 * t4 + j] = mx;
      }
    }
    __syncthreads();  // every warp's maxima are in

    // the new maxima, p, the sums; P as bf16 hi + lo, [token][head]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float alpha[2], mn[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t4 + j;
        float mx = m[nt][j];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w * NH + col]);
        mn[j] = mx;
        alpha[j] = expf(m[nt][j] - mx);
        m[nt][j] = mx;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (e < 2 ? vis0 : vis1) ? expf(s[nt][e] - mn[e & 1]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[nt][j] = l[nt][j] * alpha[j] + p[j] + p[j + 2];
      }
#pragma unroll
      for (int mw = 0; mw < Lay::kMtW; ++mw) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mw][nt][e] *= alpha[e & 1];
      }
      const int r0 = (warp * 16 + g4) * kLdP + nt * 8 + 2 * t4;
      uint32_t hw, lw;
      codec::split_bf16(p[0], p[1], hw, lw);
      *reinterpret_cast<uint32_t*>(ph + r0) = hw;
      *reinterpret_cast<uint32_t*>(pl + r0) = lw;
      codec::split_bf16(p[2], p[3], hw, lw);
      *reinterpret_cast<uint32_t*>(ph + r0 + 8 * kLdP) = hw;
      *reinterpret_cast<uint32_t*>(pl + r0 + 8 * kLdP) = lw;
    }
    __syncthreads();  // P of all 64 tokens is in

    // O^T += V^T P^T: the warp's m-tiles of d (rows) x the team's heads
#pragma unroll
    for (int kk = 0; kk < kTile / 16; kk += (NT == 1 ? 2 : 1)) {
      // B (P^T) by ldmatrix.trans of P [token][head]
      uint32_t bh[NT == 1 ? 1 : NT / 2][4], bl[NT == 1 ? 1 : NT / 2][4];
      if constexpr (NT == 1) {
        const int off = (kk * 16 + (ln >> 3) * 8 + (ln & 7)) * kLdP;
        codec::ldmatrix_x4_trans(bh[0], ph + off);
        codec::ldmatrix_x4_trans(bl[0], pl + off);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off =
              (kk * 16 + ((ln >> 3) & 1) * 8 + (ln & 7)) * kLdP +
              np * 16 + (ln >> 4) * 8;
          codec::ldmatrix_x4_trans(bh[np], ph + off);
          codec::ldmatrix_x4_trans(bl[np], pl + off);
        }
      }
#pragma unroll
      for (int mw = 0; mw < Lay::kMtW; ++mw) {
        const int mt = warp + kWarps * mw;
        if (mt < nks) {
          // A (V^T) by ldmatrix.trans: matrix ln / 8 = (column half,
          // token half) of the stage's [token][column] rows
#pragma unroll
          for (int ks2 = 0; ks2 < (NT == 1 ? 2 : 1); ++ks2) {
            uint32_t av[4];
            codec::ldmatrix_x4_trans(
                av, vs + ((kk + ks2) * 16 + (ln >> 4) * 8 + (ln & 7)) * kLd +
                        mt * 16 + ((ln >> 3) & 1) * 8);
            if constexpr (NT == 1) {
              codec::mma_bf16(acc[mw][0], av, bh[0][2 * ks2],
                              bh[0][2 * ks2 + 1]);
              codec::mma_bf16(acc[mw][0], av, bl[0][2 * ks2],
                              bl[0][2 * ks2 + 1]);
            } else {
#pragma unroll
              for (int np = 0; np < NT / 2; ++np) {
                codec::mma_bf16(acc[mw][2 * np], av, bh[np][0], bh[np][1]);
                codec::mma_bf16(acc[mw][2 * np], av, bl[np][0], bl[np][1]);
                codec::mma_bf16(acc[mw][2 * np + 1], av, bh[np][2],
                                bh[np][3]);
                codec::mma_bf16(acc[mw][2 * np + 1], av, bl[np][2],
                                bl[np][3]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the sums over the team's tokens: this warp's lanes, then its warps
  // (red's last readers passed the P barrier above)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float x = l[nt][j];
      x += __shfl_xor_sync(kFull, x, 4);
      x += __shfl_xor_sync(kFull, x, 8);
      x += __shfl_xor_sync(kFull, x, 16);
      if (g4 == 0) red[warp * NH + nt * 8 + 2 * t4 + j] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = nt * 8 + 2 * t4 + j;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += red[w * NH + col];
      l[nt][j] = x;
      if (warp == 0 && g4 == 0 && col < live) {
        const size_t row =
            ((size_t)b * a.num_splits + split) * a.h_q + h0 + col;
        a.m_part[row] = m[nt][j];
        a.l_part[row] = x;
      }
    }
  }
  // o: element e of (m-tile mt, n-tile nt) is column mt * 16 + g4 +
  // 8 (e / 2) of head nt * 8 + 2 t4 + e % 2
#pragma unroll
  for (int mw = 0; mw < Lay::kMtW; ++mw) {
    const int mt = warp + kWarps * mw;
    if (mt < nks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          if (col < live) {
            const size_t row =
                ((size_t)b * a.num_splits + split) * a.h_q + h0 + col;
            a.o_part[row * a.d + mt * 16 + g4 + 8 * (e >> 1)] =
                acc[mw][nt][e] / fmaxf(l[nt][e & 1], 1e-30f);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// f32 KV: CUDA cores
// ------------------------------------------------------------------------

// The layout of an f32 block (host and device): D columns, HG heads, kTW
// tokens a warp a tile (kTW * HG <= 32 scores a butterfly).
__host__ __device__ constexpr int simt_tw(int D, int HG) {
  return (HG == 8 || D == 256) ? 4 : 8;
}
__host__ __device__ constexpr size_t simt_smem(int D, int HG) {
  return (size_t)3 * 2 * kWarps * simt_tw(D, HG) * D * 4 + kWarps * 32 * 4;
}

template <int D, int HG>
struct SimtLayout {
  static constexpr int C = D / 32;
  static constexpr int kTW = simt_tw(D, HG);
  static constexpr int kTok = kWarps * kTW;  // tokens a tile
  static constexpr int kN = kTW * HG;        // scores a warp a tile
  static constexpr int kStages = 3;
  static constexpr int kStageElems = 2 * kTok * D;
  static constexpr size_t kRingBytes = (size_t)kStages * kStageElems * 4;
  static_assert(kRingBytes + kWarps * 32 * 4 == simt_smem(D, HG), "layout");
  // the warps' merge (acc, m, l), over the ring once it is drained
  static_assert((size_t)kWarps * HG * (D + 2) * 4 <= kRingBytes, "merge");
};

template <int D, int HG>
__global__ void __launch_bounds__(kWarps * 32) fd_simt_kernel(FdArgs a) {
  using Lay = SimtLayout<D, HG>;
  constexpr int C = Lay::C, kTW = Lay::kTW, kTok = Lay::kTok;
  constexpr int kN = Lay::kN, kStages = Lay::kStages;
  constexpr int kShift = 5 - ilog2(kN);  // lane ln holds score ln >> kShift
  constexpr int kRowLanes = 32 / HG;     // lanes of one head's scores
  constexpr int kDup = 32 / kN;          // lanes holding each score
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.y, b = blockIdx.z;
  const int kv = blockIdx.x / a.chunks, chunk = blockIdx.x % a.chunks;
  int lo, hi;
  block_range(a, b, split, lo, hi);
  if (lo >= hi) return;

  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int first = chunk * HG;
  const int live = max(0, min(HG, a.group - first));
  const int h0 = kv * a.group + first;
  float* ring = reinterpret_cast<float*>(smem);
  float* pw = reinterpret_cast<float*>(smem + Lay::kRingBytes) + 32 * warp;

  const int ntiles = (hi - lo + kTok - 1) / kTok;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) {
      load_tile<float, kTok, D, D>(a, b, kv, lo + i * kTok, hi,
                                   ring + i * Lay::kStageElems);
    }
    cp_async_commit();
  }

  const bool col_live = ln * C < a.d;  // this lane's columns lie below d
  float q[HG][C], acc[HG][C];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q[g][c] = g < live && col_live
                    ? load_q(a, ((size_t)b * a.h_q + h0 + g) * a.d + ln * C + c)
                    : 0.f;
      acc[g][c] = 0.f;
    }
  }
  // the online softmax of the head whose scores this lane holds
  float m = kMask, l = 0.f;
  const int idx = ln >> kShift, my_u = idx % kTW;
  const bool mine = (ln & (kDup - 1)) == 0;

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed everywhere; tile t-1's stage is free
    if (t + kStages - 1 < ntiles) {
      load_tile<float, kTok, D, D>(
          a, b, kv, lo + (t + kStages - 1) * kTok, hi,
          ring + ((t + kStages - 1) % kStages) * Lay::kStageElems);
    }
    cp_async_commit();
    const float* ks = ring + (t % kStages) * Lay::kStageElems +
                      warp * kTW * D;
    const float* vs = ks + kTok * D;
    float v[kN];
#pragma unroll
    for (int u = 0; u < kTW; ++u) {
      float kk[C];
      ld_cols<C>(ks + u * D + ln * C, col_live, kk);
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        float x = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) x += q[g][c] * kk[c];
        v[g * kTW + u] = x;
      }
    }
    reduce_rounds<kN, 16>(v, ln);
    const bool vis = lo + t * kTok + warp * kTW + my_u < hi;
    const float sv = vis ? v[0] * a.scale : kMask;
    float mx = sv;
#pragma unroll
    for (int o = kDup; o < kRowLanes; o <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    }
    const float m_new = fmaxf(m, mx);
    const float p = vis ? expf(sv - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + (mine ? p : 0.f);
    m = m_new;
    if (mine) pw[idx] = p;  // p of (head g, token u) at g * kTW + u
    __syncwarp();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float al = __shfl_sync(kFull, alpha, g * kRowLanes);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] *= al;
    }
#pragma unroll
    for (int u0 = 0; u0 < kTW; u0 += 4) {
      float4 ps[HG];
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        ps[g] = *reinterpret_cast<const float4*>(pw + g * kTW + u0);
      }
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        float vv[C];
        ld_cols<C>(vs + (u0 + uu) * D + ln * C, col_live, vv);
#pragma unroll
        for (int g = 0; g < HG; ++g) {
          const float pg = uu == 0 ? ps[g].x : uu == 1 ? ps[g].y
                         : uu == 2 ? ps[g].z : ps[g].w;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[g][c] += pg * vv[c];
        }
      }
    }
    __syncwarp();  // pw is rewritten next tile
  }

  // merge the warps' states through shared memory (over the drained ring):
  // a warp with no visible token holds m = -1e30, l = 0, acc = 0 and
  // weighs exactly 0
  float lsum = l;
#pragma unroll
  for (int o = 1; o < kRowLanes; o <<= 1) {
    lsum += __shfl_xor_sync(kFull, lsum, o);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* sm_acc = ring;                              // [warp][g][D]
  float* sm_m = ring + kWarps * HG * D;              // [warp][g]
  float* sm_l = sm_m + kWarps * HG;
#pragma unroll
  for (int g = 0; g < HG; ++g) {
#pragma unroll
    for (int c = 0; c < C; ++c) sm_acc[(warp * HG + g) * D + ln * C + c] =
        acc[g][c];
  }
  if (ln % kRowLanes == 0) {
    sm_m[warp * HG + ln / kRowLanes] = m;
    sm_l[warp * HG + ln / kRowLanes] = lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < live * a.d; i += blockDim.x) {
    const int g = i / a.d, c = i - g * a.d;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * HG + g]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w * HG + g] - mx);
      ll += wt * sm_l[w * HG + g];
      o += wt * sm_acc[(w * HG + g) * D + c];
    }
    const size_t row = ((size_t)b * a.num_splits + split) * a.h_q + h0 + g;
    a.o_part[row * a.d + c] = o / fmaxf(ll, 1e-30f);
    if (c == 0) {
      a.m_part[row] = mx;
      a.l_part[row] = ll;
    }
  }
}

// ------------------------------------------------------------------------
// Pass 2: a row's live pieces, one block per (row, head)
// ------------------------------------------------------------------------

// The block loads every live piece's m and l once into shared memory (a
// thread a piece), reduces their max and weighted sum across the block,
// then each thread sums one column's weighted pieces with all of their
// loads independent.  Threads: 32 * ceil(d / 32); shared memory: 2 *
// num_splits + 8 floats.
__global__ void __launch_bounds__(256) fd_merge_kernel(FdArgs a) {
  extern __shared__ float sm_w[];           // m, then the weights
  float* sm_l = sm_w + a.num_splits;
  float* red = sm_l + a.num_splits;         // a float a warp
  const int bh = blockIdx.x;
  const int b = bh / a.h_q, h = bh - b * a.h_q;
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int kv_len = a.kv_lens[b];
  const int vis_hi = min(kv_len, a.L);
  const int vis_lo = a.window > 0 ? max(0, kv_len - a.window) : 0;
  const int n = (max(0, vis_hi - vis_lo) + a.split - 1) / a.split;
  const size_t row0 = (size_t)b * a.num_splits * a.h_q + h;
  float mx = kMask;
  for (int s = tid; s < n; s += blockDim.x) {
    const float m = a.m_part[row0 + (size_t)s * a.h_q];
    sm_w[s] = m;
    sm_l[s] = a.l_part[row0 + (size_t)s * a.h_q];
    mx = fmaxf(mx, m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  if (ln == 0) red[warp] = mx;
  __syncthreads();
  mx = kMask;
  for (int w = 0; w < nw; ++w) mx = fmaxf(mx, red[w]);
  float ll = 0.f;
  for (int s = tid; s < n; s += blockDim.x) {
    const float x = expf(sm_w[s] - mx) * sm_l[s];
    sm_w[s] = x;
    ll += x;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ll += __shfl_xor_sync(kFull, ll, o);
  __syncthreads();  // every weight is in; red's maxima have been read
  if (ln == 0) red[warp] = ll;
  __syncthreads();
  ll = 0.f;
  for (int w = 0; w < nw; ++w) ll += red[w];
  if (tid >= a.d) return;
  const float* op = a.o_part + row0 * a.d + tid;
  float o = 0.f;
#pragma unroll 16
  for (int s = 0; s < n; ++s) o += sm_w[s] * op[(size_t)s * a.h_q * a.d];
  const float res = o / fmaxf(ll, 1e-30f);
  const size_t off = (size_t)bh * a.d + tid;
  if (a.q_bf16) {
    static_cast<__nv_bfloat16*>(a.out)[off] = __float2bfloat16(res);
  } else {
    static_cast<float*>(a.out)[off] = res;
  }
}

// ------------------------------------------------------------------------
// Host side: the block's shape for (d, group, types), and the launches
// ------------------------------------------------------------------------

struct FdShape {
  bool mma;      // bf16 KV: tensor cores
  int width;     // NT (mma) or HG (f32)
  int heads;     // query heads a block holds
  int chunks;    // blocks a KV head
  int threads;
  size_t smem;
};

FdShape shape_for(int d, int group, int kv_bf16, int q_bf16) {
  const int D = instance_dim(d);
  FdShape s{};
  if (kv_bf16) {
    const int nt = group <= 8 ? 1 : 2;
    const int slices = (group + 8 * nt - 1) / (8 * nt);
    int teams = slices < kMaxTeams ? slices : kMaxTeams;
    while (teams > 1 &&
           mma_ring_bytes(D) + teams * mma_team_bytes(D, nt, !q_bf16) >
               kMaxSmem) {
      --teams;
    }
    s.mma = true;
    s.width = nt;
    s.heads = teams * 8 * nt;
    s.chunks = (slices + teams - 1) / teams;
    s.threads = teams * kWarps * 32;
    s.smem = mma_ring_bytes(D) + teams * mma_team_bytes(D, nt, !q_bf16);
  } else {
    const int cap = D == 256 ? 4 : 8;
    int hg = 1;
    while (hg < group && hg < cap) hg *= 2;
    s.mma = false;
    s.width = hg;
    s.heads = hg;
    s.chunks = (group + hg - 1) / hg;
    s.threads = kWarps * 32;
    s.smem = simt_smem(D, hg);
  }
  return s;
}

// Raises a kernel's dynamic shared memory cap to `smem` the first time a
// launch needs more than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// x: the KV heads (and head chunks) of one (split, row), so the blocks
// that run together read every head of the same positions
dim3 pass1_grid(const FdArgs& a, int B) {
  return dim3(a.n_kv * a.chunks, a.num_splits, B);
}

template <int D, int NT, bool QLO>
cudaError_t launch_mma(const FdArgs& a, const FdShape& s, int B,
                       cudaStream_t stream) {
  static size_t allowed = 48 << 10;
  const cudaError_t err =
      allow_smem(fd_mma_kernel<D, NT, QLO>, s.smem, allowed);
  if (err != cudaSuccess) return err;
  fd_mma_kernel<D, NT, QLO>
      <<<pass1_grid(a, B), s.threads, s.smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int HG>
cudaError_t launch_simt(const FdArgs& a, const FdShape& s, int B,
                        cudaStream_t stream) {
  static size_t allowed = 48 << 10;
  const cudaError_t err = allow_smem(fd_simt_kernel<D, HG>, s.smem, allowed);
  if (err != cudaSuccess) return err;
  fd_simt_kernel<D, HG>
      <<<pass1_grid(a, B), s.threads, s.smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool QLO>
cudaError_t launch_mma_nt(const FdArgs& a, const FdShape& s, int B,
                          cudaStream_t stream) {
  return s.width == 1 ? launch_mma<D, 1, QLO>(a, s, B, stream)
                      : launch_mma<D, 2, QLO>(a, s, B, stream);
}

template <int D>
cudaError_t launch_pass1(const FdArgs& a, const FdShape& s, int B,
                         cudaStream_t stream) {
  if (s.mma) {
    return a.q_bf16 ? launch_mma_nt<D, false>(a, s, B, stream)
                    : launch_mma_nt<D, true>(a, s, B, stream);
  }
  if (s.width == 1) return launch_simt<D, 1>(a, s, B, stream);
  if (s.width == 2) return launch_simt<D, 2>(a, s, B, stream);
  if (s.width == 4) return launch_simt<D, 4>(a, s, B, stream);
  if constexpr (D < 256) return launch_simt<D, 8>(a, s, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Blocks a KV head takes (each holding a chunk of its query heads) for
// head dim d, `group` query heads per KV head and the types; 0 for a shape
// the kernel does not take.  The wrapper sizes its split with it.
extern "C" int codec_flash_decode_chunks(int d, int group, int kv_bf16,
                                         int q_bf16) {
  if (!codec::head_dim_taken(d) || group < 1) return 0;
  return shape_for(d, group, kv_bf16, q_bf16).chunks;
}

// Launches both passes on `stream`.  A pass-1 block takes `split` visible
// positions (a multiple of 64) of one row and KV head; num_splits blocks a
// row must cover min(L, window or L) positions.  o_part / m_part / l_part
// are scratch of (B, num_splits, h_q[, d]) floats; only the live pieces
// are written and read.  Returns the first cudaError_t (0 = ok).
extern "C" int codec_flash_decode(const void* q, int q_bf16, const void* k,
                                  const void* v, int kv_bf16,
                                  const void* kv_lens, void* o_part,
                                  void* m_part, void* l_part, void* out,
                                  int B, int L, int h_q, int n_kv, int d,
                                  int window, int split, int num_splits,
                                  float scale, void* stream) {
  if (n_kv <= 0 || h_q % n_kv || !codec::head_dim_taken(d) || split <= 0 ||
      split % kTile || num_splits <= 0 || B < 0 || L < 0 ||
      (long long)num_splits * split < (window > 0 && window < L ? window : L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = h_q / n_kv;
  if (group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const FdShape s = shape_for(d, group, kv_bf16, q_bf16);
  if (num_splits > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  FdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.o_part = static_cast<float*>(o_part);
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.out = out;
  a.q_bf16 = q_bf16;
  a.L = L;
  a.h_q = h_q;
  a.n_kv = n_kv;
  a.d = d;
  a.window = window;
  a.split = split;
  a.num_splits = num_splits;
  a.group = group;
  a.chunks = s.chunks;
  a.heads = s.heads;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (instance_dim(d)) {
    case 32:
      err = launch_pass1<32>(a, s, B, st);
      break;
    case 64:
      err = launch_pass1<64>(a, s, B, st);
      break;
    case 128:
      err = launch_pass1<128>(a, s, B, st);
      break;
    default:
      err = launch_pass1<256>(a, s, B, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_merge_kernel<<<B * h_q, 32 * ((d + 31) / 32),
                    (2 * (size_t)num_splits + 8) * sizeof(float), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
