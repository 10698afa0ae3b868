// The mesh's cross-shard merge for Hopper (sm_90a), around CoDec POR
// (partial output reduction, paper Alg. 3).
//
// codec_mesh_merge is the mesh's cross-shard merge for one layer, in one
// launch.  It replaces the Pallas TPU kernel
// src/repro/kernels/por.py::por in its role inside por_subgroup_merge
// (src/repro/kernels/por.py:121, called by the JAX package's sharded
// step, src/repro/distributed/step_fn.py:175-183), together with what
// surrounds it there: the row gather, the packing, the ppermute of each
// round, the scatter back and the cast.  Inputs are the D data shards'
// stats-mode epilogue outputs, o (D, M, B, h, hd) and m, l (D, M, B, h)
// float32, as the epilogues wrote them; merge_gather / merge_scatter
// (Bm,) int64 (gather padded with 0, scatter with B) and contrib (D,)
// int64 0/1 flags.  It writes shard 0's view, (M, B, h, hd) in the
// model's type:
//   - a row b that no scatter slot names is o[0, :, b] cast;
//   - the row b = merge_scatter[j] is shard 0's result of the subgroup
//     butterfly over the D shards' partials of row merge_gather[j]:
//     anchor = the first contributor, xall = max over contributors of
//     (shard ^ anchor); round `shift` (1, 2, .., D/2) merges when
//     xall >= shift, else copies (shard s keeps its own value when
//     s / shift == anchor / shift, else takes shard s ^ shift's).  Shard
//     0's final value needs, before round `shift`, the shards that are
//     multiples of `shift`, so the kernel runs the D - 1 merges of that
//     tree in round order, each one POR of codec_por's arithmetic (por.cu:
//     expf, __fmul_rn, __fadd_rn, __fdiv_rn, the lower shard's side as
//     the local operand): its rows are bitwise those of the stacked
//     butterfly on codec_por, and a lone contributor's partials pass
//     through copy rounds as selects, verbatim.
// A padded slot's scatter index is B, which names no row: nothing is
// written for it.  Optional out_m / out_l (M, B, h) take shard 0's m
// and l the same way.
//
// What bounds it: at the serve's 2x1 mesh (32 heads, hd 128, 8 rows, all
// merged, bf16 output) it reads ~0.53 MB of partials and writes 64 KB:
// ~0.2 us at 3.35 TB/s, with a few FLOPs a byte.  Its launch bounds it.
// The composition it replaces took ~39 small kernels a layer (stack,
// gathers, pack, the XOR exchange copy, slice copies, codec_por, the
// selects, the scatter, the cast), each a launch and a round trip
// through HBM; here the D shards' rows are loaded once into registers,
// straight from where the epilogues wrote them, and the output is
// written once.  Grid (B, M, head blocks of up to 8 warps), one warp per
// query head, a lane holding hd/32 contiguous columns of each shard's
// row; every warp finds its row's slot by scanning merge_scatter with a
// ballot and reads contrib itself, on the device (no host sync, so it
// runs inside a CUDA graph).  Up to 16 shards every round runs on
// registers (o[D][hd/32] a lane: 184 registers at D = 16, hd 256).  A
// wider axis runs in blocks of 16 shards, each block's four rounds in
// registers as above, and the blocks' results are combined in the
// tree's order as they come (a binary counter over the blocks, one
// stacked result a level in local memory): each merge and each copy is
// the one the butterfly makes, on the same operands, so the rows stay
// bitwise those of the stacked route.  It takes any power-of-two D up
// to 2^19 and every hd that the epilogue takes (hd % 16 == 0, 16 to
// 256: 64, 128 and 256 in instances of their own, any other in the next
// of 32-256 columns, the lanes past hd reading and writing nothing), and
// writes float32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using codec::kFullMask;
using codec::load_cols;
using codec::store_cols;

constexpr int kMergeWarps = 8;  // query heads (warps) a block
constexpr int kMergeLeaf = 16;  // shards whose rounds run in registers

struct MergeArgs {
  const float* o;              // (D, M, B, h, hd)
  const float* m;              // (D, M, B, h)
  const float* l;              // (D, M, B, h)
  const long long* gather;     // (Bm,) rows merged (padding 0)
  const long long* scatter;    // (Bm,) where they go (padding B)
  const long long* contrib;    // (D,) 1 for shards with partials
  void* out;                   // (M, B, h, hd) float32 or bf16
  float* out_m;                // (M, B, h) or null
  float* out_l;                // (M, B, h) or null
  int D, M, B, h, hd, Bm;
};

// codec_por's arithmetic on one lane's columns: (o1, m1, l1) is the local
// operand and takes the result
template <int C>
__device__ __forceinline__ void por_merge(float (&o1)[C], float& m1,
                                          float& l1, const float (&o2)[C],
                                          float m2, float l2) {
  const float mx = fmaxf(m1, m2);
  const float a1 = __fmul_rn(expf(m1 - mx), l1);
  const float a2 = __fmul_rn(expf(m2 - mx), l2);
  const float ll = __fadd_rn(a1, a2);
  const float den = fmaxf(ll, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    o1[c] = __fdiv_rn(__fadd_rn(__fmul_rn(o1[c], a1), __fmul_rn(o2[c], a2)),
                      den);
  }
  m1 = mx;
  l1 = ll;
}

// Rounds SHIFT, 2 SHIFT, .. ND/2 of the butterfly over the ND shards
// base .. base + ND - 1, on the shards whose values the block's first
// shard still needs (the multiples of SHIFT).
template <int ND, int C, int SHIFT>
__device__ __forceinline__ void butterfly(float (&o)[ND][C], float (&m)[ND],
                                          float (&l)[ND], int xall,
                                          int anchor, int base) {
  if constexpr (SHIFT < ND) {
    if (xall >= SHIFT) {
#pragma unroll
      for (int s = 0; s < ND; s += 2 * SHIFT) {
        por_merge<C>(o[s], m[s], l[s], o[s + SHIFT], m[s + SHIFT],
                     l[s + SHIFT]);
      }
    } else {
      // a copy round: a select, no arithmetic
#pragma unroll
      for (int s = 0; s < ND; s += 2 * SHIFT) {
        if ((base + s) / SHIFT != anchor / SHIFT) {
#pragma unroll
          for (int c = 0; c < C; ++c) o[s][c] = o[s + SHIFT][c];
          m[s] = m[s + SHIFT];
          l[s] = l[s + SHIFT];
        }
      }
    }
    butterfly<ND, C, 2 * SHIFT>(o, m, l, xall, anchor, base);
  }
}

// Loads the ND shards base .. base + ND - 1 of one row and runs their
// rounds: (res, mr, lr) is the block's result, what shard `base` holds
// after round ND / 2.
template <int ND, int C, bool kExact>
__device__ __forceinline__ void merge_block(const MergeArgs& a, int mi,
                                            long long g, int hh, int lane,
                                            int xall, int anchor, int base,
                                            float (&res)[C], float& mr,
                                            float& lr) {
  const int hd = kExact ? 32 * C : a.hd;
  float o[ND][C], m[ND], l[ND];
#pragma unroll
  for (int s = 0; s < ND; ++s) {
    const size_t r = (((size_t)(base + s) * a.M + mi) * a.B + g) * a.h + hh;
    if (kExact || lane * C < hd) {
      load_cols<C>(a.o + r * hd + lane * C, o[s]);
    } else {  // columns past hd: never read, never written
#pragma unroll
      for (int c = 0; c < C; ++c) o[s][c] = 0.f;
    }
    m[s] = a.m[r];
    l[s] = a.l[r];
  }
  butterfly<ND, C, 1>(o, m, l, xall, anchor, base);
#pragma unroll
  for (int c = 0; c < C; ++c) res[c] = o[0][c];
  mr = m[0];
  lr = l[0];
}

// Grid (B, M, ceil(h / kMergeWarps)), one warp per query head.  ND = D up
// to kMergeLeaf shards; past that (kWide) the D shards run in blocks of
// ND = kMergeLeaf, each block's rounds in registers, and the blocks'
// results are combined in the tree's order by a binary counter: after
// block i, while bit k of i is set, the stacked result of the block pair
// to its left (shards i * ND - 2^k ND .. ) takes round 2^k ND with it.
// The stack holds one result a level (log2(D / ND) levels), in local
// memory.  kExact: hd = 32 C, the rows' stride a constant and every lane
// live; otherwise the lanes past hd read and write nothing.
template <int ND, int C, typename OT, bool kWide, bool kExact>
__global__ void __launch_bounds__(kMergeWarps * 32)
    mesh_merge_kernel(const MergeArgs a) {
  const int b = blockIdx.x, mi = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int hd = kExact ? 32 * C : a.hd;   // the rows' stride
  const bool live = kExact || lane * C < hd;  // columns below hd
  const int h = blockIdx.z * kMergeWarps + (threadIdx.x >> 5);
  if (h >= a.h) return;  // whole warps only

  // the merge slot that scatters to row b, if any (padding scatters to B)
  int slot = -1;
  for (int j0 = 0; j0 < a.Bm; j0 += 32) {
    const int j = j0 + lane;
    const unsigned hit =
        __ballot_sync(kFullMask, j < a.Bm && a.scatter[j] == b);
    if (hit) {
      slot = j0 + __ffs(hit) - 1;
      break;
    }
  }
  const size_t orow = ((size_t)mi * a.B + b) * a.h + h;  // = shard 0's row
  float res[C];
  float mr, lr;
  if (slot < 0 || (!kWide && ND == 1)) {
#pragma unroll
    for (int c = 0; c < C; ++c) res[c] = 0.f;
    if (live) load_cols<C>(a.o + orow * hd + lane * C, res);
    mr = a.m[orow];
    lr = a.l[orow];
  } else {
    // anchor = the first contributor (0 if none), xall = max over the
    // contributors of (shard ^ anchor): one ballot up to 16 shards, past
    // that 32 shards a ballot
    int anchor = -1, xall = 0;
    if constexpr (!kWide) {
      const bool is_c = lane < ND && a.contrib[lane] > 0;
      const unsigned cm = __ballot_sync(kFullMask, is_c);
      anchor = cm ? __ffs(cm) - 1 : 0;
      xall = (int)__reduce_max_sync(
          kFullMask, is_c ? (unsigned)(lane ^ anchor) : 0u);
    } else {
      for (int s0 = 0; s0 < a.D && anchor < 0; s0 += 32) {
        const unsigned cm = __ballot_sync(
            kFullMask, s0 + lane < a.D && a.contrib[s0 + lane] > 0);
        if (cm) anchor = s0 + __ffs(cm) - 1;
      }
      if (anchor < 0) anchor = 0;
      for (int s0 = 0; s0 < a.D; s0 += 32) {
        const int s = s0 + lane;
        const bool is_c = s < a.D && a.contrib[s] > 0;
        xall = max(xall, (int)__reduce_max_sync(
                             kFullMask, is_c ? (unsigned)(s ^ anchor) : 0u));
      }
    }
    const long long g = a.gather[slot];
    if constexpr (!kWide) {
      merge_block<ND, C, kExact>(a, mi, g, h, lane, xall, anchor, 0, res, mr,
                                 lr);
    } else {
      constexpr int kLevels = 16;  // D up to ND * 2^15
      float so[kLevels][C], sm[kLevels], sl[kLevels];
      int top = 0;
      for (int i = 0; i < a.D / ND; ++i) {
        merge_block<ND, C, kExact>(a, mi, g, h, lane, xall, anchor, i * ND,
                                   res, mr, lr);
        int size = ND, lo = i * ND, k = 0;
        while ((i >> k) & 1) {
          // the left half, shards lo - size .. lo - 1, is the local operand
          const int left = lo - size;
          float lo_o[C];
#pragma unroll
          for (int c = 0; c < C; ++c) lo_o[c] = so[k][c];
          float lo_m = sm[k], lo_l = sl[k];
          if (xall >= size) {
            por_merge<C>(lo_o, lo_m, lo_l, res, mr, lr);
          } else if (left / size != anchor / size) {
            // a copy round: the left half takes the right half's result
#pragma unroll
            for (int c = 0; c < C; ++c) lo_o[c] = res[c];
            lo_m = mr;
            lo_l = lr;
          }
#pragma unroll
          for (int c = 0; c < C; ++c) res[c] = lo_o[c];
          mr = lo_m;
          lr = lo_l;
          lo = left;
          size *= 2;
          ++k;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) so[k][c] = res[c];
        sm[k] = mr;
        sl[k] = lr;
        top = k;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) res[c] = so[top][c];
      mr = sm[top];
      lr = sl[top];
    }
  }
  if (live) store_cols<C>(static_cast<OT*>(a.out) + orow * hd + lane * C, res);
  if (lane == 0 && a.out_m != nullptr) {
    a.out_m[orow] = mr;
    a.out_l[orow] = lr;
  }
}

template <int ND, int C, bool kWide, bool kExact>
cudaError_t launch_merge(const MergeArgs& a, int out_bf16,
                         cudaStream_t stream) {
  const int warps = a.h < kMergeWarps ? a.h : kMergeWarps;
  const dim3 grid(a.B, a.M, (a.h + kMergeWarps - 1) / kMergeWarps);
  if (out_bf16) {
    mesh_merge_kernel<ND, C, __nv_bfloat16, kWide, kExact>
        <<<grid, warps * 32, 0, stream>>>(a);
  } else {
    mesh_merge_kernel<ND, C, float, kWide, kExact>
        <<<grid, warps * 32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// hd 64, 128 and 256 run in instances of their own; any other in the
// next of 32, 64, 128 and 256 columns, the lanes past hd masked
template <int ND, bool kWide = false>
cudaError_t merge_for_dim(const MergeArgs& a, int hd, int out_bf16,
                          cudaStream_t s) {
  if (hd == 64) return launch_merge<ND, 2, kWide, true>(a, out_bf16, s);
  if (hd == 128) return launch_merge<ND, 4, kWide, true>(a, out_bf16, s);
  if (hd == 256) return launch_merge<ND, 8, kWide, true>(a, out_bf16, s);
  if (hd <= 32) return launch_merge<ND, 1, kWide, false>(a, out_bf16, s);
  if (hd <= 64) return launch_merge<ND, 2, kWide, false>(a, out_bf16, s);
  if (hd <= 128) return launch_merge<ND, 4, kWide, false>(a, out_bf16, s);
  return launch_merge<ND, 8, kWide, false>(a, out_bf16, s);
}

}  // namespace

// The mesh's cross-shard merge of one layer: o (D, M, B, h, hd), m / l
// (D, M, B, h) float32; gather / scatter (Bm,) and contrib (D,) int64; out
// (M, B, h, hd) bf16 when out_bf16, else float32; out_m / out_l (M, B, h)
// float32 or null.  Returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int codec_mesh_merge(const void* o, const void* m, const void* l,
                                const void* gather, const void* scatter,
                                const void* contrib, void* out, int out_bf16,
                                void* out_m, void* out_l, int D, int M, int B,
                                int h, int hd, int Bm, void* stream) {
  if (D < 1 || (D & (D - 1)) || D > (kMergeLeaf << 15) ||
      !codec::head_dim_taken(hd) || M < 1 || h < 1 || B < 0 ||
      Bm < 0 || M > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  MergeArgs a;
  a.o = static_cast<const float*>(o);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.gather = static_cast<const long long*>(gather);
  a.scatter = static_cast<const long long*>(scatter);
  a.contrib = static_cast<const long long*>(contrib);
  a.out = out;
  a.out_m = static_cast<float*>(out_m);
  a.out_l = static_cast<float*>(out_l);
  a.D = D;
  a.M = M;
  a.B = B;
  a.h = h;
  a.hd = hd;
  a.Bm = Bm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1:
      err = merge_for_dim<1>(a, hd, out_bf16, s);
      break;
    case 2:
      err = merge_for_dim<2>(a, hd, out_bf16, s);
      break;
    case 4:
      err = merge_for_dim<4>(a, hd, out_bf16, s);
      break;
    case 8:
      err = merge_for_dim<8>(a, hd, out_bf16, s);
      break;
    case kMergeLeaf:
      err = merge_for_dim<kMergeLeaf>(a, hd, out_bf16, s);
      break;
    default:
      err = merge_for_dim<kMergeLeaf, true>(a, hd, out_bf16, s);
  }
  return static_cast<int>(err);
}
