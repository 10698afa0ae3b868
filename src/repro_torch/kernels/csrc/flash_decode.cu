// FlashDecoding baseline (dense-batch decode attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:91
// (flash_decode, kernel body _fd_kernel): row b's single query attends over
// its own KV positions [0, kv_len_b) of dense (B, L, n_kv, d) K and V, with
// an optional window keeping only positions p > kv_len_b - 1 - window; GQA
// is folded per KV head (query head h reads KV head h / group); the softmax
// is an f32 online softmax with scale 1/sqrt(d); the output has q's type.
// q and KV types are independent (f32 or bf16 each).
//
// What bounds it on the H100: bytes.  It must read
//   sum_b min(kv_len_b, window or inf) * n_kv * d * esize * 2
// bytes of K and V, plus q and the output, and does 4 * group FLOPs per
// (K, V) element pair: at group = 4 that is 2 FLOP per f32 byte, far below
// the card's ridge, so it is a memory-bound GEMV and HBM at 3.35 TB/s is the
// bound.  Every visible KV byte is read exactly once.
//
// Design (a simple first version on CUDA cores; cp.async / TMA double
// buffering, and wgmma where the group is wide, are left for later):
//  * On the TPU the chunk axis ran in order per row and batch x KV head
//    gave the parallelism.  Here the KV is split across blocks, as
//    FlashDecoding does.  Pass 1 runs one block per (split, KV head, row):
//    at 8 rows x 8 KV heads, 8 splits make 512 blocks for the 132 SMs.
//  * A block's range is its share of the row's visible range
//    [max(0, kv_len - window), min(kv_len, L)), cut into num_splits equal
//    pieces.  Positions outside it are never read, so NaN padding past
//    kv_len (or before the window) cannot reach the accumulator.
//  * d = 128: a lane holds 4 columns of each of the group's queries, of
//    their accumulators and of every K and V row it loads, so a warp reads
//    one whole row per load (512 B in f32, 256 B in bf16).  Each warp takes
//    kTok consecutive tokens at a time, issues all 2 * kTok row loads before
//    using any, reduces the scores with warp shuffles and keeps m, l and acc
//    in registers in f32.
//  * The block's warps merge by log-sum-exp through shared memory and write
//    one partial (o normalised, m, l) per query head to scratch.  A split
//    with no visible position writes m = -1e30 (never -inf), l = 0, o = 0.
//  * Pass 2 merges a row's splits by log-sum-exp, one thread per (row, head,
//    column): empty splits weigh exp(m_s - M) * 0 = 0 exactly, and a row
//    with no visible position at all ends 0 / max(0, 1e-30) = 0, as on the
//    TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kMask = -1e30f;
constexpr int kD = 128;       // head dim this kernel takes
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// four consecutive elements (16-byte aligned for f32, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y) {
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
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
  int q_bf16, L, h_q, n_kv, window, num_splits;
  float scale;
};

template <int G>
__device__ __forceinline__ void load_q(const FdArgs& a, int b, int kv,
                                       int lane, float4 (&qr)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t off = ((size_t)b * a.h_q + kv * G + g) * kD + lane * 4;
    if (a.q_bf16) {
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + off;
      qr[g] = make_float4(__bfloat162float(q[0]), __bfloat162float(q[1]),
                          __bfloat162float(q[2]), __bfloat162float(q[3]));
    } else {
      const float* q = static_cast<const float*>(a.q) + off;
      qr[g] = make_float4(q[0], q[1], q[2], q[3]);
    }
  }
}

// Pass 1: one block per (split, KV head, row), grid (S, n_kv, B).
template <typename KVT, int G, int kTok>
__global__ void __launch_bounds__(kThreads) fd_split_kernel(FdArgs a) {
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ __align__(16) float sm_acc[kWarps][G][kD];

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this split's share of the row's visible range
  const int kv_len = a.kv_lens[b];
  const int vis_hi = min(kv_len, a.L);
  const int vis_lo = a.window > 0 ? max(0, kv_len - a.window) : 0;
  const int span = max(0, vis_hi - vis_lo);
  const int per = (span + a.num_splits - 1) / a.num_splits;
  const int lo = vis_lo + split * per;
  const int hi = min(lo + per, vis_hi);

  float4 qr[G];
  load_q<G>(a, b, kv, lane, qr);
  float m[G], l[G];
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMask;
    l[g] = 0.f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const size_t tok_stride = (size_t)a.n_kv * kD;
  const size_t base = ((size_t)b * a.L * a.n_kv + kv) * kD + lane * 4;
  const KVT* kp = static_cast<const KVT*>(a.k) + base;
  const KVT* vp = static_cast<const KVT*>(a.v) + base;

  for (int t0 = lo + warp * kTok; t0 < hi; t0 += kWarps * kTok) {
    float4 kr[kTok], vr[kTok];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      if (t0 + u < hi) {
        kr[u] = load4(kp + (size_t)(t0 + u) * tok_stride);
        vr[u] = load4(vp + (size_t)(t0 + u) * tok_stride);
      } else {  // past the range: never read, never used
        kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vr[u] = kr[u];
      }
    }
    float s[kTok][G];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[u][g] = dot4(qr[g], kr[u]);
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
      float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kTok; ++u) {
        const float p = (t0 + u < hi) ? expf(s[u][g] - mx) : 0.f;
        sum += p;
        pv.x += p * vr[u].x;
        pv.y += p * vr[u].y;
        pv.z += p * vr[u].z;
        pv.w += p * vr[u].w;
      }
      l[g] = l[g] * alpha + sum;
      acc[g].x = acc[g].x * alpha + pv.x;
      acc[g].y = acc[g].y * alpha + pv.y;
      acc[g].z = acc[g].z * alpha + pv.z;
      acc[g].w = acc[g].w * alpha + pv.w;
      m[g] = mx;
    }
  }

  // merge the warps' states (a warp with no tokens holds m = -1e30, l = 0,
  // acc = 0 and weighs exactly 0)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    *reinterpret_cast<float4*>(&sm_acc[warp][g][lane * 4]) = acc[g];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * kD; i += kThreads) {
    const int g = i / kD, c = i - g * kD;
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
        ((size_t)b * a.num_splits + split) * a.h_q + kv * G + g;
    a.o_part[row * kD + c] = o / fmaxf(ll, 1e-30f);
    if (c == 0) {
      a.m_part[row] = mx;
      a.l_part[row] = ll;
    }
  }
}

// Pass 2: one block per (row, head), one thread per column.
__global__ void __launch_bounds__(kD) fd_merge_kernel(FdArgs a) {
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
    o += wt * a.o_part[row * kD + c];
  }
  const float r = o / fmaxf(ll, 1e-30f);
  const size_t off = (size_t)bh * kD + c;
  if (a.q_bf16) {
    static_cast<__nv_bfloat16*>(a.out)[off] = __float2bfloat16(r);
  } else {
    static_cast<float*>(a.out)[off] = r;
  }
}

template <typename KVT, int G>
cudaError_t launch_split(const FdArgs& a, int B, cudaStream_t stream) {
  // kTok tokens in flight per warp: fewer for wide groups (registers)
  constexpr int kTok = G >= 8 ? 4 : 8;
  fd_split_kernel<KVT, G, kTok>
      <<<dim3(a.num_splits, a.n_kv, B), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename KVT>
cudaError_t launch_split_group(const FdArgs& a, int B, int group,
                               cudaStream_t stream) {
  switch (group) {
    case 1: return launch_split<KVT, 1>(a, B, stream);
    case 2: return launch_split<KVT, 2>(a, B, stream);
    case 4: return launch_split<KVT, 4>(a, B, stream);
    case 8: return launch_split<KVT, 8>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches both passes on `stream`.  o_part/m_part/l_part are scratch of
// (B, num_splits, h_q[, d]) floats.  Returns the first cudaError_t (0 = ok).
extern "C" int codec_flash_decode(const void* q, int q_bf16, const void* k,
                                  const void* v, int kv_bf16,
                                  const void* kv_lens, void* o_part,
                                  void* m_part, void* l_part, void* out,
                                  int B, int L, int h_q, int n_kv, int d,
                                  int window, int num_splits, float scale,
                                  void* stream) {
  if (d != kD || n_kv <= 0 || h_q % n_kv || num_splits <= 0) {
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
  a.window = window;
  a.num_splits = num_splits;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = h_q / n_kv;
  cudaError_t err =
      kv_bf16 ? launch_split_group<__nv_bfloat16>(a, B, group, s)
              : launch_split_group<float>(a, B, group, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_merge_kernel<<<B * h_q, kD, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
