// FlashDecoding baseline (dense-batch decode attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:91
// (flash_decode, kernel body _fd_kernel): row b's single query attends over
// its own KV positions [0, kv_len_b) of dense (B, L, n_kv, d) K and V, with
// an optional window keeping only positions p > kv_len_b - 1 - window; GQA
// is folded per KV head (query head h reads KV head h / group); the softmax
// is an f32 online softmax with scale 1/sqrt(d); the output has q's type.
// q and KV types are independent (f32 or bf16 each).  Like the TPU kernel
// it takes any group h_q / n_kv (its scratch is (n_kv, group, d)); the head
// dim is 64, 128 or 256.
//
// What bounds it on the H100: bytes.  It must read
//   sum_b min(kv_len_b, window or inf) * n_kv * d * esize * 2
// bytes of K and V, plus q and the output, and does 4 * group FLOPs per
// (K, V) element pair: at group = 4 that is 2 FLOP per f32 byte, far below
// the card's ridge, so it is a memory-bound GEMV and HBM at 3.35 TB/s is the
// bound.  Every visible KV byte is read exactly once when one block holds
// the whole group (see the head chunks below).
//
// Design (a simple first version on CUDA cores; cp.async / TMA double
// buffering, and wgmma where the group is wide, are left for later):
//  * On the TPU the chunk axis ran in order per row and batch x KV head
//    gave the parallelism.  Here the KV is split across blocks, as
//    FlashDecoding does.  Pass 1 runs one block per (split, KV head x head
//    chunk, row): at 8 rows x 8 KV heads, 8 splits make 512 blocks for the
//    132 SMs.
//  * Head chunks: a block holds G query heads of its KV head in registers,
//    G a power of two (1, 2, 4 or 8; at most 2 at d = 256, where a lane
//    holds 8 columns of each: 4 there took 10% longer at gemma3-1b's 4
//    over 1, tools/kernel_ab.py).  A group of up to that size takes one chunk
//    and the smallest G that covers it: groups 3, 5, 6 and 7 run with the
//    heads past the group idle (q = 0, nothing written).  A wider group
//    (16, 32, or 4 at d = 256) is cut into ceil(group / G) chunks, each its
//    own block over the same KV range: the chunks of one KV head run at
//    the same time, so after the first the KV comes mostly from L2.
//  * A block's range is its share of the row's visible range
//    [max(0, kv_len - window), min(kv_len, L)), cut into num_splits equal
//    pieces.  Positions outside it are never read, so NaN padding past
//    kv_len (or before the window) cannot reach the accumulator.
//  * A lane holds C = d / 32 consecutive columns of the chunk's queries, of
//    their accumulators and of every K and V row it loads, so a warp reads
//    one whole row per load (d * esize bytes).  Each warp takes kTok
//    consecutive tokens at a time, issues all 2 * kTok row loads before
//    using any, reduces the scores with warp shuffles and keeps m, l and
//    acc in registers in f32.  The kernel is compiled for 4 blocks an SM
//    (128 registers a thread): at phase 4's shape its 512 blocks then
//    run in one wave.  The 8-head build spills under that cap, but
//    without it (196 registers, 2 blocks an SM) or at 3 blocks an SM it
//    took 16-22% longer at group 8, and two 4-head chunks 63% longer
//    (tools/kernel_ab.py).  kTok is 4 where a lane holds 32 or more
//    accumulators (8 heads at d = 128) or 8 columns (d = 256), 6 at 16
//    (4 heads at d = 128), else 8; 8 at 16 with bf16 KV took 4% longer.
//  * The block's warps merge by log-sum-exp through shared memory (4 x G x
//    d floats: 16 KB at most, static) and write one partial (o normalised,
//    m, l) per query head to scratch.  A split with no visible position
//    writes m = -1e30 (never -inf), l = 0, o = 0.
//  * Pass 2 merges a row's splits by log-sum-exp, one thread per (row, head,
//    column): empty splits weigh exp(m_s - M) * 0 = 0 exactly, and a row
//    with no visible position at all ends 0 / max(0, 1e-30) = 0, as on the
//    TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kMask = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// blocks an SM the split kernel is compiled for: at most 128 registers a
// thread, so phase 4's 512 blocks (8 rows x 8 KV heads x 8 splits) are
// all resident at once on the 132 SMs
constexpr int kMinBlocks = 4;
constexpr unsigned kFull = 0xffffffffu;

// C consecutive elements as floats: f32 in float4 / float2 loads (16- or
// 8-byte aligned), bf16 in 16-, 8- or 4-byte loads
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
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  }
}

__device__ __forceinline__ float2 bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
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

struct FdArgs {
  const void* q;        // (B, h_q, d) float32 or bfloat16
  const void* k;        // (B, L, n_kv, d)
  const void* v;
  const int* kv_lens;   // (B,)
  float* o_part;        // (B, S, h_q, d)
  float* m_part;        // (B, S, h_q)
  float* l_part;
  void* out;            // (B, h_q, d) in q's type
  int q_bf16, L, h_q, n_kv, d, window, num_splits;
  int group;            // h_q / n_kv
  int chunks;           // head chunks a KV head: ceil(group / G)
  float scale;
};

// Pass 1: one block per (split, KV head x head chunk, row), grid
// (S, n_kv * chunks, B).  The block's heads are kv * group + chunk * G + g
// for g < G, of which the first `live` exist.
template <typename KVT, int D, int G, int kTok>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fd_split_kernel(FdArgs a) {
  constexpr int C = D / 32;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ __align__(16) float sm_acc[kWarps][G][D];
  // the block's first head and its live heads, read back after the KV
  // loop, so they hold no register through it
  __shared__ int sm_heads[2];

  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / a.chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this split's share of the row's visible range
  const int kv_len = a.kv_lens[b];
  const int vis_hi = min(kv_len, a.L);
  const int vis_lo = a.window > 0 ? max(0, kv_len - a.window) : 0;
  const int span = max(0, vis_hi - vis_lo);
  const int per = (span + a.num_splits - 1) / a.num_splits;
  const int lo = vis_lo + split * per;
  const int hi = min(lo + per, vis_hi);

  float qr[G][C];
  {
    const int h0 = kv * a.group + (blockIdx.y - kv * a.chunks) * G;
    const int live = min(G, kv * a.group + a.group - h0);
    if (threadIdx.x == 0) {
      sm_heads[0] = h0;
      sm_heads[1] = live;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t off = ((size_t)b * a.h_q + h0 + g) * D + lane * C;
#pragma unroll
      for (int c = 0; c < C; ++c) qr[g][c] = 0.f;
      if (g < live) {
        if (a.q_bf16) {
          const __nv_bfloat16* q =
              static_cast<const __nv_bfloat16*>(a.q) + off;
#pragma unroll
          for (int c = 0; c < C; ++c) qr[g][c] = __bfloat162float(q[c]);
        } else {
          const float* q = static_cast<const float*>(a.q) + off;
#pragma unroll
          for (int c = 0; c < C; ++c) qr[g][c] = q[c];
        }
      }
    }
  }
  float m[G], l[G], acc[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMask;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
  }

  const size_t tok_stride = (size_t)a.n_kv * D;
  const size_t base = ((size_t)b * a.L * a.n_kv + kv) * D + lane * C;
  const KVT* kp = static_cast<const KVT*>(a.k) + base;
  const KVT* vp = static_cast<const KVT*>(a.v) + base;

  for (int t0 = lo + warp * kTok; t0 < hi; t0 += kWarps * kTok) {
    float kr[kTok][C], vr[kTok][C];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      if (t0 + u < hi) {
        load_cols<C>(kp + (size_t)(t0 + u) * tok_stride, kr[u]);
        load_cols<C>(vp + (size_t)(t0 + u) * tok_stride, vr[u]);
      } else {  // past the range: never read, never used
#pragma unroll
        for (int c = 0; c < C; ++c) kr[u][c] = vr[u][c] = 0.f;
      }
    }
    float s[kTok][G];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) x += qr[g][c] * kr[u][c];
        s[u][g] = x;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        s[u][g] = (t0 + u < hi) ? s[u][g] * a.scale : kMask;
        mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
      float pv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) pv[c] = 0.f;
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        const float p = (t0 + u < hi) ? expf(s[u][g] - mx) : 0.f;
        sum += p;
#pragma unroll
        for (int c = 0; c < C; ++c) pv[c] += p * vr[u][c];
      }
      l[g] = l[g] * alpha + sum;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = acc[g][c] * alpha + pv[c];
      m[g] = mx;
    }
  }

  // merge the warps' states (a warp with no tokens holds m = -1e30, l = 0,
  // acc = 0 and weighs exactly 0)
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < C; ++c) sm_acc[warp][g][lane * C + c] = acc[g][c];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  const int h0 = sm_heads[0], live = sm_heads[1];
  for (int i = threadIdx.x; i < live * D; i += kThreads) {
    const int g = i / D, c = i - g * D;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w][g] - mx);
      ll += wt * sm_l[w][g];
      o += wt * sm_acc[w][g][c];
    }
    const size_t row =
        ((size_t)b * a.num_splits + split) * a.h_q + h0 + g;
    a.o_part[row * D + c] = o / fmaxf(ll, 1e-30f);
    if (c == 0) {
      a.m_part[row] = mx;
      a.l_part[row] = ll;
    }
  }
}

// Pass 2: one block per (row, head), one thread per column.
__global__ void __launch_bounds__(256) fd_merge_kernel(FdArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.h_q, h = bh - (bh / a.h_q) * a.h_q;
  const int c = threadIdx.x;
  const int S = a.num_splits;
  float mx = kMask;
  for (int s = 0; s < S; ++s) {
    mx = fmaxf(mx, a.m_part[((size_t)b * S + s) * a.h_q + h]);
  }
  float ll = 0.f, o = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t row = ((size_t)b * S + s) * a.h_q + h;
    const float wt = expf(a.m_part[row] - mx) * a.l_part[row];
    ll += wt;
    o += wt * a.o_part[row * a.d + c];
  }
  const float r = o / fmaxf(ll, 1e-30f);
  const size_t off = (size_t)bh * a.d + c;
  if (a.q_bf16) {
    static_cast<__nv_bfloat16*>(a.out)[off] = __float2bfloat16(r);
  } else {
    static_cast<float*>(a.out)[off] = r;
  }
}

template <typename KVT, int D, int G>
cudaError_t launch_split(const FdArgs& a, int B, cudaStream_t stream) {
  // kTok tokens in flight per warp: fewer where the registers are tight
  // (128 a thread): 6 at 16 accumulators a lane (phase 4's 4 heads at d
  // 128), where 8 spilled
  constexpr int C = D / 32;
  constexpr int kTok = (G * C >= 32 || C >= 8) ? 4 : (G * C >= 16 ? 6 : 8);
  fd_split_kernel<KVT, D, G, kTok>
      <<<dim3(a.num_splits, a.n_kv * a.chunks, B), kThreads, 0, stream>>>(
          a);
  return cudaGetLastError();
}

template <typename KVT, int D>
cudaError_t launch_split_chunk(const FdArgs& a, int B, int G,
                               cudaStream_t stream) {
  if (G == 1) return launch_split<KVT, D, 1>(a, B, stream);
  if (G == 2) return launch_split<KVT, D, 2>(a, B, stream);
  if constexpr (D < 256) {  // d 256 takes 2 heads a block at most
    if (G == 4) return launch_split<KVT, D, 4>(a, B, stream);
    if (G == 8) return launch_split<KVT, D, 8>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename KVT>
cudaError_t launch_split_dim(const FdArgs& a, int B, int G,
                             cudaStream_t stream) {
  if (a.d == 64) return launch_split_chunk<KVT, 64>(a, B, G, stream);
  if (a.d == 128) return launch_split_chunk<KVT, 128>(a, B, G, stream);
  return launch_split_chunk<KVT, 256>(a, B, G, stream);
}

}  // namespace

// The query heads a block holds (G) and the blocks a KV head takes
// (chunks) for head dim d and `group` query heads per KV head; 0 for a
// shape the kernel does not take.  The wrapper sizes its grid with them.
extern "C" int codec_flash_decode_chunk(int d, int group) {
  if ((d != 64 && d != 128 && d != 256) || group < 1) return 0;
  const int cap = d == 256 ? 2 : 8;
  if (group > cap) return cap;
  int g = 1;
  while (g < group) g *= 2;
  return g;
}

// Launches both passes on `stream`.  o_part/m_part/l_part are scratch of
// (B, num_splits, h_q[, d]) floats.  Returns the first cudaError_t (0 = ok).
extern "C" int codec_flash_decode(const void* q, int q_bf16, const void* k,
                                  const void* v, int kv_bf16,
                                  const void* kv_lens, void* o_part,
                                  void* m_part, void* l_part, void* out,
                                  int B, int L, int h_q, int n_kv, int d,
                                  int window, int num_splits, float scale,
                                  void* stream) {
  if (n_kv <= 0 || h_q % n_kv || num_splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = h_q / n_kv;
  const int G = codec_flash_decode_chunk(d, group);
  if (G == 0) return static_cast<int>(cudaErrorInvalidValue);
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
  a.num_splits = num_splits;
  a.group = group;
  a.chunks = (group + G - 1) / G;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      kv_bf16 ? launch_split_dim<__nv_bfloat16>(a, B, G, s)
              : launch_split_dim<float>(a, B, G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_merge_kernel<<<B * h_q, d, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
