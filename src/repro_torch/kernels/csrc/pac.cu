// CoDec PAC (partial attention computation, paper §4.3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pac.py::pac (kernel body
// _pac_kernel).  One launch runs a whole compiled DecodePlan: the step
// arrays (num_lanes, max_steps) say, for each lane, which KV page of which
// subtask to process next.  Each task's partial output is the flash triple
// (o, m, l) over its KV slice, with o normalised and m/l the running max and
// denominator, task-major: o (T+1, max_q, h_q, d), m/l (T+1, max_q, h_q).
// Visibility of position p (token j of its page) to a query at q_pos:
// j < kvlen && p <= q_pos && (window <= 0 || p > q_pos - window); masked
// scores are -1e30 (never -inf), so a fully masked row ends l = 0, o = 0.
//
// What bounds it on the H100.  Bytes: each planned KV page is read once per
// task (the paper's IO saving), 3.35 TB/s.  Operations: 4 * rows * tokens
// * d FLOPs; at qwen3-4b a shared-document task of 8 queries has 32 rows
// per KV head, and with f32 KV on CUDA cores (67 TFLOP/s) the operation
// bound comes within 1.5x of the byte bound.  The first version of this
// kernel was bound by neither: every page step waited on a chain of
// dependent metadata loads, then on its page load with nothing else in
// flight, then on four block-wide barriers around one-thread-per-row
// softmax passes (~11 us a step against ~0.1 us of bytes).
//
// Design:
//  * Grid (num_lanes, n_kv, row chunks): one block per (lane, KV head) and
//    chunk of kRows folded query rows (row r = qi * group + g, head h =
//    kv * group + g, as on the TPU).  Each KV page is read once per block
//    for all query heads of its KV head and all queries of the task.  A
//    task with more rows than one block holds (16 on CUDA cores, 64 on
//    tensor cores) is split over grid z: more warps per SM, and the
//    blocks of a task read its pages at about the same time, the later
//    ones mostly from L2.  Blocks whose chunk holds no live row of any of
//    their lane's tasks stage the metadata, find no work and exit.
//  * Metadata off the critical path: the block stages its lane's steps
//    into shared memory (up to kListCap a round: one step per thread, all
//    seven arrays and the task's query count read at once), compacted by a
//    ballot to the valid steps whose task has rows in this chunk.  Padding
//    steps and other chunks' tasks cost nothing after that.
//  * A ring of kStages tiles in shared memory, filled by cp.async (16-byte
//    cp.async.cg; 8-byte cp.async.ca where a bf16 row is not a 16-byte
//    multiple).  A tile is kTok tokens of one page (a whole page at page
//    16 and d <= 128; a page of 64 is four tiles), K and V of one KV head.
//    Tokens past the step's kvlen and columns past d are zero-filled by
//    the copy itself, so no stale value reaches a product.  All threads
//    issue the copies kStages - 1 tiles ahead of the tile being computed,
//    across subtask boundaries; one __syncthreads per tile both publishes
//    the landed tile and frees the stage that the next copy refills.
//  * f32 KV (and bf16 KV with d > 128): CUDA cores, 8 warps of up to two
//    rows each (rows w and w + 8 of the block's 16).  A lane holds 4 * DV
//    columns of each row's query and accumulator in registers.  Per tile a
//    lane computes rows x tokens partial dot products from contiguous K
//    rows (conflict-free 512-byte reads), and one transposing butterfly
//    (xpose) reduces all of them at once, 31 shuffles for 32 scores,
//    leaving one score per lane; the row max takes a few more shuffles,
//    and the denominator is kept per lane and reduced at the subtask's
//    end.  The row count is a template parameter, so a warp with one live
//    row (every flash-plan task) does one row's work.  What bounds this
//    path is the shared-memory pipe (LDS and SHFL), not FFMA issue: every
//    warp reads the whole tile for its two rows, and each score costs a
//    shuffle to reduce and one to broadcast its p.  Four rows a warp read
//    half as much but left too few warps on an SM to hide the latency
//    (PERF.md has both times).  f32 stays on FFMA: TF32 would break the
//    1e-5 parity with repro.
//  * bf16 KV with d <= 128: tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//    accumulate), 4 warps of one 16-row tile each.  Q fragments and the
//    accumulator live in registers (FlashAttention-2 layouts: the score
//    accumulator becomes the A operand of PV without leaving registers).
//    K is read with ldmatrix, V with ldmatrix.trans, from rows padded by
//    16 bytes (conflict-free).  q (when f32) and P are split into
//    bf16 hi + lo terms, two products each, so the only rounding left is
//    ~2^-17 of each value: K and V are exact in bf16.
//  * Shared memory is the ring plus the staged steps, independent of max_q
//    and page: 73 KB for f32 at d = 128 (three blocks fit on an SM), 42 KB
//    for bf16.  Page 64 at full width runs.
//  * Only live rows (slot < task_qnum) are computed and written; dead query
//    slots keep what the caller allocated, and the caller masks them.
//    State is reset on step_first, written on step_last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using codec::cp_async16;
using codec::cp_async8;
using codec::cp_async_commit;
using codec::cp_async_wait;
using codec::reduce_rounds;

constexpr float kMask = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 4;     // tiles in the ring
constexpr int kListCap = 512;  // plan steps staged per round

struct PacArgs {
  const void* q;          // (B, h_q, d) float32 or bfloat16
  const int* q_gather;    // (T+1, max_q) query row of each task slot
  const int* q_pos;       // (T+1, max_q) absolute position of each query
  const int* task_qnum;   // (T+1,) live queries of each task
  const void* k_pool;     // (P, page, n_kv, d)
  const void* v_pool;
  const int* step_task;   // (num_lanes, max_steps), all seven
  const int* step_page;
  const int* step_valid;
  const int* step_first;
  const int* step_last;
  const int* step_pos;
  const int* step_kvlen;
  float* o;               // (T+1, max_q, h_q, d)
  float* m;               // (T+1, max_q, h_q)
  float* l;
  int max_steps, max_q, h_q, n_kv, d, page, window, q_bf16, vec16;
  float scale;
};

// One plan step as staged in shared memory.
struct __align__(16) Step {
  int page;  // pool page
  int pos;   // absolute position of the page's first token
  int task;
  int meta;  // kvlen (bits 0-19) | rows in this block (20-27) | first (28)
             // | last (29)
};

__device__ __forceinline__ int step_kvlen(const Step& s) {
  return s.meta & 0xfffff;
}
__device__ __forceinline__ int step_rows(const Step& s) {
  return (s.meta >> 20) & 0xff;
}
__device__ __forceinline__ bool step_first(const Step& s) {
  return (s.meta >> 28) & 1;
}
__device__ __forceinline__ bool step_last(const Step& s) {
  return (s.meta >> 29) & 1;
}

__device__ __forceinline__ bool visible(int j, int ntok, int pos, int qpos,
                                        int window) {
  return j < ntok && pos <= qpos && (window <= 0 || pos > qpos - window);
}

__device__ __forceinline__ float load_q(const PacArgs& a, size_t off) {
  return a.q_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
             : static_cast<const float*>(a.q)[off];
}

// four consecutive elements of a shared-memory row as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 y = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(x.x, x.y, y.x, y.y);
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y) {
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x += p * v.x;
  acc.y += p * v.y;
  acc.z += p * v.z;
  acc.w += p * v.w;
}

__device__ __forceinline__ void scale4(float4& acc, float s) {
  acc.x *= s;
  acc.y *= s;
  acc.z *= s;
  acc.w *= s;
}

// ------------------------------------------------------------------------
// Policies: the per-warp compute of one tile, and what a block holds.
// ------------------------------------------------------------------------

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// CUDA cores; DV = 1, 2, 4 for d <= 128, 256, 512.
template <typename KV, int DV>
struct Simt {
  using KVT = KV;
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlots = 2;               // rows per warp
  static constexpr int kRows = kWarps * kSlots;  // rows per block
  static constexpr int kTok = 16 / DV;           // tokens per tile
  static constexpr int kDPad = 128 * DV;         // columns kept per row
  static constexpr int kLd = kDPad;              // row stride (elements)
  static constexpr int kStageBytes = 2 * kTok * kLd * (int)sizeof(KV);
  static constexpr int kMinBlocks = DV <= 2 ? 2 : 1;  // d = 512: no spills
  static constexpr int kScratchFloats = 32 * kWarps;  // each warp's p

  float4 q[kSlots][DV];
  float4 acc[kSlots][DV];
  float m, l;  // running max, and this lane's share of the denominator,
               // of the row whose scores this lane holds
  int qpos;    // that row's query position; -1 for a dead row
  int ns;      // live rows of this warp: rows warp, warp + 8 below `rows`

  __device__ __forceinline__ void begin(const PacArgs& a, int task, int rows,
                                        int row0, int kv, int group) {
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    ns = min(max((rows - warp + kWarps - 1) / kWarps, 0), kSlots);
    m = kMask;
    l = 0.f;
    qpos = -1;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      int qp = -1;
#pragma unroll
      for (int dv = 0; dv < DV; ++dv) {
        q[s][dv] = make_float4(0.f, 0.f, 0.f, 0.f);
        acc[s][dv] = q[s][dv];
      }
      if (s < ns) {
        const int fr = row0 + warp + kWarps * s;
        const int qi = fr / group, g = fr - qi * group;
        const int slot = task * a.max_q + qi;
        const int b = a.q_gather[slot];
        qp = a.q_pos[slot];
        const size_t base = ((size_t)b * a.h_q + kv * group + g) * a.d;
#pragma unroll
        for (int dv = 0; dv < DV; ++dv) {
          const int c = (dv * 32 + ln) * 4;
          if (c < a.d) {
            q[s][dv] = make_float4(load_q(a, base + c), load_q(a, base + c + 1),
                                   load_q(a, base + c + 2),
                                   load_q(a, base + c + 3));
          }
        }
      }
      if (ns > 0 && s == ln / (32 / ns)) qpos = qp;
    }
  }

  // A tile for a warp with NS live rows: its NS * kTok partial dot
  // products reduce in one butterfly, leaving one score per lane (the lanes
  // of row s are 32 / NS consecutive ones), then one online-softmax update
  // and the P V products, which read p back from the warp's 32 floats of
  // shared memory four tokens at a time (broadcast reads, not shuffles).
  template <int NS>
  __device__ __forceinline__ void tile_rows(const PacArgs& a, const KV* ks,
                                            int pos0, int ntok, float* pw) {
    constexpr int NT = kTok;
    constexpr int kN = NS * NT;
    constexpr int kShift = 5 - ilog2(kN);  // lane ln holds score ln >> kShift
    constexpr int kRowLanes = 32 / NS;
    constexpr int kDup = 32 / kN;          // lanes holding each score
    const KV* vs = ks + kTok * kLd;
    const int ln = threadIdx.x & 31;
    float v[kN];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float4 kk[DV];
#pragma unroll
      for (int dv = 0; dv < DV; ++dv) {
        kk[dv] = ld4(ks + t * kLd + (dv * 32 + ln) * 4);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float x = 0.f;
#pragma unroll
        for (int dv = 0; dv < DV; ++dv) x += dot4(q[s][dv], kk[dv]);
        v[s * NT + t] = x;
      }
    }
    reduce_rounds<kN, 16>(v, ln);
    const int j = (ln >> kShift) % NT, pos = pos0 + j;
    const bool vis = visible(j, ntok, pos, qpos, a.window);
    const float sv = vis ? v[0] * a.scale : kMask;
    float mx = sv;
#pragma unroll
    for (int o = kDup; o < kRowLanes; o <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    }
    const float m_new = fmaxf(m, mx);
    const float p = vis ? expf(sv - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    const bool mine = (ln & (kDup - 1)) == 0;
    l = l * alpha + (mine ? p : 0.f);
    m = m_new;
    if (mine) pw[ln >> kShift] = p;  // p of (row s, token t) at s * NT + t
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float al =
          NS == 1 ? alpha : __shfl_sync(kFull, alpha, s * kRowLanes);
#pragma unroll
      for (int dv = 0; dv < DV; ++dv) scale4(acc[s][dv], al);
    }
#pragma unroll
    for (int t = 0; t < NT; t += 4) {
      float4 ps[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        ps[s] = *reinterpret_cast<const float4*>(pw + s * NT + t);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[DV];
#pragma unroll
        for (int dv = 0; dv < DV; ++dv) {
          vv[dv] = ld4(vs + (t + u) * kLd + (dv * 32 + ln) * 4);
        }
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float pst = u == 0 ? ps[s].x : u == 1 ? ps[s].y
                          : u == 2 ? ps[s].z : ps[s].w;
#pragma unroll
          for (int dv = 0; dv < DV; ++dv) fma4(acc[s][dv], pst, vv[dv]);
        }
      }
    }
  }

  __device__ __forceinline__ void tile(const PacArgs& a, const KV* ks,
                                       int pos0, int ntok, float* scratch) {
    float* pw = scratch + 32 * (threadIdx.x >> 5);
    if (ns == kSlots) {
      tile_rows<kSlots>(a, ks, pos0, ntok, pw);
    } else if (ns == 1) {
      tile_rows<1>(a, ks, pos0, ntok, pw);
    }
  }

  __device__ __forceinline__ void finish(const PacArgs& a, int task, int rows,
                                         int row0, int kv, int group) {
    if (ns == 0) return;
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    const int row_lanes = 32 / ns;
    float lsum = l;
    for (int o = 1; o < row_lanes; o <<= 1) {
      lsum += __shfl_xor_sync(kFull, lsum, o);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s < ns) {
        const float ls = __shfl_sync(kFull, lsum, s * row_lanes);
        const float ms = __shfl_sync(kFull, m, s * row_lanes);
        const int fr = row0 + warp + kWarps * s;
        const int qi = fr / group, g = fr - qi * group;
        const size_t orow =
            (size_t)(task * a.max_q + qi) * a.h_q + kv * group + g;
        const float den = fmaxf(ls, 1e-30f);
#pragma unroll
        for (int dv = 0; dv < DV; ++dv) {
          const int c = (dv * 32 + ln) * 4;
          if (c < a.d) {
            const float4 x = acc[s][dv];
            *reinterpret_cast<float4*>(a.o + orow * a.d + c) =
                make_float4(x.x / den, x.y / den, x.z / den, x.w / den);
          }
        }
        if (ln == 0) {
          a.m[orow] = ms;
          a.l[orow] = ls;
        }
      }
    }
  }
};

// Tensor cores for bf16 KV, d <= 128: a warp owns one 16-row tile.
struct Mma {
  using KVT = __nv_bfloat16;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kTok = 16;
  static constexpr int kDPad = 128;
  static constexpr int kLd = kDPad + 8;  // 16-byte pad: ldmatrix is
                                         // conflict-free
  static constexpr int kStageBytes = 2 * kTok * kLd * 2;
  static constexpr int kMinBlocks = 2;
  static constexpr int kKSteps = kDPad / 16;
  static constexpr int kNTiles = kDPad / 8;
  static constexpr int kScratchFloats = 0;

  uint32_t qh[kKSteps][4], ql[kKSteps][4];  // q = hi + lo, A fragments
  float acc[kNTiles][4];
  float m[2], l[2];  // rows ln / 4 and ln / 4 + 8 of the tile; l per lane
  int qpos[2];
  bool on, lo;

  __device__ __forceinline__ void begin(const PacArgs& a, int task, int rows,
                                        int row0, int kv, int group) {
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    const int g4 = ln >> 2, t4 = ln & 3;
    on = warp * 16 < rows;
    lo = !a.q_bf16;
    size_t base[2] = {0, 0};
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g4 + 8 * i;
      m[i] = kMask;
      l[i] = 0.f;
      qpos[i] = -1;
      live[i] = on && r < rows;
      if (live[i]) {
        const int fr = row0 + r, qi = fr / group, g = fr - qi * group;
        const int slot = task * a.max_q + qi;
        qpos[i] = a.q_pos[slot];
        base[i] = ((size_t)a.q_gather[slot] * a.h_q + kv * group + g) * a.d;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = ks * 16 + half * 8 + 2 * t4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = 0.f, y = 0.f;
          if (live[i] && c < a.d) {
            x = load_q(a, base[i] + c);
            y = load_q(a, base[i] + c + 1);
          }
          codec::split_bf16(x, y, qh[ks][half * 2 + i], ql[ks][half * 2 + i]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const PacArgs& a,
                                       const __nv_bfloat16* ks, int pos0,
                                       int ntok, float*) {
    if (!on) return;
    const __nv_bfloat16* vs = ks + kTok * kLd;
    const int ln = threadIdx.x & 31, t4 = ln & 3;

    // S = Q K^T over the tile's 16 tokens: two n-tiles of 8
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    // ldmatrix.x4 rows: matrix ln / 8 = (token half, column half)
    const __nv_bfloat16* krow =
        ks + ((ln >> 4) * 8 + (ln & 7)) * kLd + ((ln >> 3) & 1) * 8;
    const int nks = (a.d + 15) >> 4;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      if (kk < nks) {
        uint32_t b[4];
        codec::ldmatrix_x4(b, krow + kk * 16);
        codec::mma_bf16(s[0], qh[kk], b[0], b[1]);
        codec::mma_bf16(s[1], qh[kk], b[2], b[3]);
        if (lo) {
          codec::mma_bf16(s[0], ql[kk], b[0], b[1]);
          codec::mma_bf16(s[1], ql[kk], b[2], b[3]);
        }
      }
    }

    // online softmax; element e of n-tile nt is row ln/4 + 8*(e/2), token
    // nt*8 + 2*(ln%4) + e%2
    float mx[2] = {kMask, kMask};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t4 + (e & 1);
        const bool vis = visible(j, ntok, pos0 + j, qpos[e >> 1], a.window);
        s[nt][e] = vis ? s[nt][e] * a.scale : kMask;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
    }
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t4 + (e & 1);
        const bool vis = visible(j, ntok, pos0 + j, qpos[e >> 1], a.window);
        p[nt][e] = vis ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        psum[e >> 1] += p[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + psum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // O += P V: the score accumulators are P's A fragment (k = 16 tokens)
    uint32_t ph[4], pl[4];
    codec::split_bf16(p[0][0], p[0][1], ph[0], pl[0]);
    codec::split_bf16(p[0][2], p[0][3], ph[1], pl[1]);
    codec::split_bf16(p[1][0], p[1][1], ph[2], pl[2]);
    codec::split_bf16(p[1][2], p[1][3], ph[3], pl[3]);
    // ldmatrix.x4.trans rows: matrix ln / 8 = (column half, token half)
    const __nv_bfloat16* vrow =
        vs + (((ln >> 3) & 1) * 8 + (ln & 7)) * kLd + (ln >> 4) * 8;
#pragma unroll
    for (int nt = 0; nt < kNTiles; nt += 2) {
      if (nt * 8 < a.d) {
        uint32_t b[4];
        codec::ldmatrix_x4_trans(b, vrow + nt * 8);
        codec::mma_bf16(acc[nt], ph, b[0], b[1]);
        codec::mma_bf16(acc[nt], pl, b[0], b[1]);
        codec::mma_bf16(acc[nt + 1], ph, b[2], b[3]);
        codec::mma_bf16(acc[nt + 1], pl, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void finish(const PacArgs& a, int task, int rows,
                                         int row0, int kv, int group) {
    if (!on) return;
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    const int g4 = ln >> 2, t4 = ln & 3;
    float lsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lsum[i] = l[i] + __shfl_xor_sync(kFull, l[i], 1);
      lsum[i] += __shfl_xor_sync(kFull, lsum[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g4 + 8 * i;
      if (r < rows) {
        const int fr = row0 + r, qi = fr / group, g = fr - qi * group;
        const size_t orow =
            (size_t)(task * a.max_q + qi) * a.h_q + kv * group + g;
        const float den = fmaxf(lsum[i], 1e-30f);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int c = nt * 8 + 2 * t4;
          if (c < a.d) {
            *reinterpret_cast<float2*>(a.o + orow * a.d + c) = make_float2(
                acc[nt][2 * i] / den, acc[nt][2 * i + 1] / den);
          }
        }
        if (t4 == 0) {
          a.m[orow] = m[i];
          a.l[orow] = lsum[i];
        }
      }
    }
  }
};

// ------------------------------------------------------------------------
// The block: staging, the ring, and the walk over the lane's steps.
// ------------------------------------------------------------------------

// Stages the lane's steps from raw step `raw` on into `list`: the valid
// ones whose task has live rows in the block's row chunk [row0, row0 +
// kRows).  Returns how many; advances `raw`.  A round reads one step per
// thread and compacts the kept ones, in order, by a ballot.
template <class P>
__device__ int stage_steps(const PacArgs& a, int lane, int row0, int group,
                           int& raw, Step* list, int* warp_cnt) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  int count = 0;
  while (raw < a.max_steps && count + P::kThreads <= kListCap) {
    const int i = raw + threadIdx.x;
    bool keep = false;
    Step s{};
    if (i < a.max_steps) {
      const int idx = lane * a.max_steps + i;
      const int valid = a.step_valid[idx];
      const int task = a.step_task[idx];
      const int kvlen = min(max(a.step_kvlen[idx], 0), a.page);
      const int first = a.step_first[idx], last = a.step_last[idx];
      s.page = a.step_page[idx];
      s.pos = a.step_pos[idx];
      s.task = task;
      if (valid) {
        const int rows = min(a.task_qnum[task] * group - row0, P::kRows);
        keep = rows > 0;
        s.meta = kvlen | (max(rows, 0) << 20) | ((first != 0) << 28) |
                 ((last != 0) << 29);
      }
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (ln == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < P::kWarps; ++w) {
      const int c = warp_cnt[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (keep) list[count + before + __popc(ballot & ((1u << ln) - 1u))] = s;
    count += total;
    raw += P::kThreads;
    __syncthreads();  // publishes the list; warp_cnt is rewritten next round
  }
  return count;
}

// Copies tile tokens [t_off, t_off + kTok) of step s's page, KV head kv,
// into a stage: K then V, rows of kLd elements.  Tokens past the step's
// kvlen and columns past d are zero-filled, reading nothing.
template <class P>
__device__ __forceinline__ void load_tile(const PacArgs& a, const Step& s,
                                          int t_off, int kv,
                                          typename P::KVT* ks) {
  using KVT = typename P::KVT;
  KVT* vs = ks + P::kTok * P::kLd;
  const int ntok = step_kvlen(s) - t_off;
  const size_t tok_stride = (size_t)a.n_kv * a.d;
  const size_t base = (((size_t)s.page * a.page + t_off) * a.n_kv + kv) * a.d;
  const KVT* kp = static_cast<const KVT*>(a.k_pool);
  const KVT* vp = static_cast<const KVT*>(a.v_pool);
  if (a.vec16) {
    constexpr int kVec = 16 / sizeof(KVT);
    constexpr int kPer = P::kDPad / kVec;  // chunks per row
    static_assert(P::kTok * kPer % P::kThreads == 0, "copies per thread");
#pragma unroll
    for (int it = 0; it < P::kTok * kPer / P::kThreads; ++it) {
      const int i = threadIdx.x + it * P::kThreads;
      const int j = i / kPer, c = (i % kPer) * kVec;
      const bool in = j < ntok && c < a.d;
      const size_t off = in ? base + j * tok_stride + c : 0;
      cp_async16(ks + j * P::kLd + c, kp + off, in ? 16 : 0);
      cp_async16(vs + j * P::kLd + c, vp + off, in ? 16 : 0);
    }
  } else {
    constexpr int kVec = 8 / sizeof(KVT);
    constexpr int kPer = P::kDPad / kVec;
    static_assert(P::kTok * kPer % P::kThreads == 0, "copies per thread");
#pragma unroll
    for (int it = 0; it < P::kTok * kPer / P::kThreads; ++it) {
      const int i = threadIdx.x + it * P::kThreads;
      const int j = i / kPer, c = (i % kPer) * kVec;
      const bool in = j < ntok && c < a.d;
      const size_t off = in ? base + j * tok_stride + c : 0;
      cp_async8(ks + j * P::kLd + c, kp + off, in ? 8 : 0);
      cp_async8(vs + j * P::kLd + c, vp + off, in ? 8 : 0);
    }
  }
}

// Moves a (step, tile) cursor one tile on; true when it left the step.
template <class P>
__device__ __forceinline__ bool next_tile(const Step* list, int& step,
                                          int& tile) {
  const int ntiles = max(1, (step_kvlen(list[step]) + P::kTok - 1) / P::kTok);
  if (++tile < ntiles) return false;
  ++step;
  tile = 0;
  return true;
}

template <class P>
constexpr size_t smem_bytes() {
  return kStages * (size_t)P::kStageBytes + kListCap * sizeof(Step) +
         P::kWarps * sizeof(int) + P::kScratchFloats * sizeof(float);
}

template <class P>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
    pac_kernel(PacArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using KVT = typename P::KVT;
  constexpr int kStageElems = P::kStageBytes / (int)sizeof(KVT);
  KVT* ring = reinterpret_cast<KVT*>(smem);
  Step* list = reinterpret_cast<Step*>(smem + kStages * P::kStageBytes);
  int* warp_cnt = reinterpret_cast<int*>(list + kListCap);
  float* scratch = reinterpret_cast<float*>(warp_cnt + P::kWarps);

  const int lane = blockIdx.x, kv = blockIdx.y;
  const int group = a.h_q / a.n_kv;
  const int row0 = blockIdx.z * P::kRows;
  P pol;
  int task = 0, rows = 0;  // the subtask being accumulated (rows: none yet)
  int raw = 0;
  while (raw < a.max_steps) {
    const int n = stage_steps<P>(a, lane, row0, group, raw, list, warp_cnt);
    // producer and consumer cursors over (step in list, tile in step)
    int ps = 0, pt = 0, cs = 0, ct = 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (ps < n) {
        load_tile<P>(a, list[ps], pt * P::kTok, kv, ring + i * kStageElems);
        next_tile<P>(list, ps, pt);
      }
      cp_async_commit();
    }
#pragma unroll 1
    for (int t = 0; cs < n; ++t) {
      const Step s = list[cs];
      if (ct == 0 && step_first(s)) {  // queries load while tile t lands
        task = s.task;
        rows = step_rows(s);
        pol.begin(a, task, rows, row0, kv, group);
      }
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile t landed everywhere; tile t-1's stage is free
      if (ps < n) {
        load_tile<P>(a, list[ps], pt * P::kTok, kv,
                     ring + ((t + kStages - 1) % kStages) * kStageElems);
        next_tile<P>(list, ps, pt);
      }
      cp_async_commit();
      const int t_off = ct * P::kTok;
      if (rows > 0) {
        pol.tile(a, ring + (t % kStages) * kStageElems, s.pos + t_off,
                 min(P::kTok, step_kvlen(s) - t_off), scratch);
      }
      if (next_tile<P>(list, cs, ct) && step_last(s) && rows > 0) {
        pol.finish(a, task, rows, row0, kv, group);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the list are refilled next round
  }
}

// Raises the kernel's dynamic shared memory cap to what it uses, once.
template <class P>
cudaError_t allow_smem() {
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        pac_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<P>());
    if (err != cudaSuccess) return err;
    raised = true;
  }
  return cudaSuccess;
}

template <class P>
cudaError_t launch(const PacArgs& a, int num_lanes, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P>();
  const cudaError_t err = allow_smem<P>();
  if (err != cudaSuccess) return err;
  const int chunks = (a.max_q * (a.h_q / a.n_kv) + P::kRows - 1) / P::kRows;
  pac_kernel<P><<<dim3(num_lanes, a.n_kv, chunks), P::kThreads, smem,
                  stream>>>(a);
  return cudaGetLastError();
}

// The policy for head dim d and the KV type: tensor cores for bf16 at
// d <= 128, CUDA cores otherwise.  Calls fn(P{}); fails above d = 512.
template <class Fn>
auto with_policy(int d, int kv_bf16, Fn&& fn) -> decltype(fn(Mma{})) {
  if (kv_bf16) {
    if (d <= 128) return fn(Mma{});
    if (d <= 256) return fn(Simt<__nv_bfloat16, 2>{});
    return fn(Simt<__nv_bfloat16, 4>{});
  }
  if (d <= 128) return fn(Simt<float, 1>{});
  if (d <= 256) return fn(Simt<float, 2>{});
  return fn(Simt<float, 4>{});
}

constexpr int kMaxD = 512;
constexpr int kMaxPage = 1 << 20;

}  // namespace

// Dynamic shared memory of one block for head dim d and the KV type
// (0 if the shape is not taken).
extern "C" size_t codec_pac_smem_bytes(int d, int kv_bf16) {
  if (d <= 0 || d > kMaxD) return 0;
  return with_policy(d, kv_bf16,
                     [](auto pol) { return smem_bytes<decltype(pol)>(); });
}

// Blocks of the kernel for head dim d and the KV type that fit on one SM
// of the current device, as its registers and shared memory allow (0 if
// the shape is not taken, -1 if the query failed).
extern "C" int codec_pac_blocks_per_sm(int d, int kv_bf16) {
  if (d <= 0 || d > kMaxD) return 0;
  return with_policy(d, kv_bf16, [](auto pol) {
    using P = decltype(pol);
    int n = -1;
    if (allow_smem<P>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, pac_kernel<P>, P::kThreads, smem_bytes<P>()) != cudaSuccess) {
      return -1;
    }
    return n;
  });
}

// Returns the cudaError_t of the launch (0 = success).
extern "C" int codec_pac(const void* q, int q_bf16, const void* q_gather,
                         const void* q_pos, const void* task_qnum,
                         const void* k_pool, const void* v_pool, int kv_bf16,
                         const void* step_task, const void* step_page,
                         const void* step_valid, const void* step_first,
                         const void* step_last, const void* step_pos,
                         const void* step_kvlen, void* o, void* m, void* l,
                         int num_lanes, int max_steps, int max_q, int h_q,
                         int n_kv, int d, int page, int window, float scale,
                         void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 || n_kv <= 0 || h_q % n_kv ||
      page <= 0 || page >= kMaxPage) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PacArgs a;
  a.q = q;
  a.q_gather = static_cast<const int*>(q_gather);
  a.q_pos = static_cast<const int*>(q_pos);
  a.task_qnum = static_cast<const int*>(task_qnum);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.step_task = static_cast<const int*>(step_task);
  a.step_page = static_cast<const int*>(step_page);
  a.step_valid = static_cast<const int*>(step_valid);
  a.step_first = static_cast<const int*>(step_first);
  a.step_last = static_cast<const int*>(step_last);
  a.step_pos = static_cast<const int*>(step_pos);
  a.step_kvlen = static_cast<const int*>(step_kvlen);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.max_steps = max_steps;
  a.max_q = max_q;
  a.h_q = h_q;
  a.n_kv = n_kv;
  a.d = d;
  a.page = page;
  a.window = window;
  a.q_bf16 = q_bf16;
  a.vec16 = ((size_t)d * (kv_bf16 ? 2 : 4)) % 16 == 0;
  a.scale = scale;
  if (num_lanes <= 0 || max_steps <= 0 || max_q <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_policy(d, kv_bf16, [&](auto pol) {
    return launch<decltype(pol)>(a, num_lanes, s);
  }));
}
