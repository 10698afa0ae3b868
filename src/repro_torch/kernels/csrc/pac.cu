// CoDec PAC (partial attention computation, paper §4.3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pac.py::pac (kernel body
// _pac_kernel).  One launch runs a whole compiled DecodePlan: the step
// arrays (num_lanes, max_steps) say, for each lane, which KV page of which
// subtask to process next.  Each task's partial output is the flash triple
// (o, m, l) over its KV slice, with o normalised and m/l the running max and
// denominator, task-major: o (T+1, max_q, h_q, d), m/l (T+1, max_q, h_q).
//
// What bounds it on the H100: decode attention reads each planned KV page
// once per task and does 4 * rows * page * d FLOPs on it, far below the
// card's ~295 FLOP/byte ridge at decode batch sizes, so the page bytes from
// HBM (3.35 TB/s) are the bound; at the full qwen3-4b width a shared-prefix
// task with 8 queries runs 32 rows per KV head, where the f32 CUDA-core rate
// (67 TFLOP/s) comes within a factor of two of that bound too.
//
// Design (a simple first version; wgmma, TMA and pipelining come later):
//  * grid (num_lanes, n_kv), 256 threads: one block per (lane, KV head).
//    A loop over the lane's steps takes the place of the TPU's sequential
//    grid axis; the block reads step_* itself from global memory.
//  * GQA is folded as on the TPU: head h = kv*group + g, row r = qi*group+g,
//    so each KV page is loaded once into shared memory for all query heads
//    of its KV head and all queries of the task (the paper's IO saving).
//  * The Q tile (gathered through q_gather, no materialised q_tasks), the
//    f32 accumulator, m and l live in dynamic shared memory (~160 KB at
//    max_q=32, group=4, d=128: one block per SM, 128 blocks fill the card).
//  * Only the task's live rows (task_qnum * group) are computed and
//    written; dead query slots keep whatever the caller allocated, and the
//    caller masks them before the segment combine.
//  * State is reset on step_first, invalid steps (lane padding) are skipped
//    and write nothing, and o/m/l are written only on step_last.  A fully
//    masked row ends with p = 0, l = 0, o = acc / 1e-30 = 0.
//  * K/V are float32 or bfloat16 and are upcast to f32; all accumulation is
//    f32.  The 1/sqrt(d) scale is applied after the dot, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kMask = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // page loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
  int max_steps, max_q, h_q, n_kv, d, page, window;
  float scale;
};

__device__ __forceinline__ bool visible(int p, int j, int kvlen, int qpos,
                                        int window) {
  return j < kvlen && p <= qpos && (window <= 0 || p > qpos - window);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) pac_kernel(PacArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.x;
  const int kv = blockIdx.y;
  const int group = a.h_q / a.n_kv;
  const int R = a.max_q * group;
  const int d = a.d, d4 = a.d / 4, page = a.page;
  const int ldq = d + 4;  // padded rows: conflict-free float4 reads of K

  float* qs = smem;                 // (R, ldq)   query tile, f32
  float* ks = qs + R * ldq;         // (page, ldq)
  float* vs = ks + page * ldq;      // (page, d)
  float* acc = vs + page * d;       // (R, d)
  float* sc = acc + R * d;          // (R, page)  scores, then p
  float* ms = sc + R * page;        // (R,)
  float* ls = ms + R;               // (R,)
  float* al = ls + R;               // (R,)       this step's rescale
  int* qp = reinterpret_cast<int*>(al + R);  // (max_q,)

  const QT* q = static_cast<const QT*>(a.q);
  const KVT* kp = static_cast<const KVT*>(a.k_pool);
  const KVT* vp = static_cast<const KVT*>(a.v_pool);

  int task = 0;
  int rows = 0;
  for (int step = 0; step < a.max_steps; ++step) {
    const int idx = lane * a.max_steps + step;
    if (!a.step_valid[idx]) continue;  // lane padding: no work, no write
    const int pg = a.step_page[idx];
    const int pos0 = a.step_pos[idx];
    const int kvlen = a.step_kvlen[idx];

    if (a.step_first[idx]) {
      task = a.step_task[idx];
      const int nq = a.task_qnum[task];
      rows = nq * group;
      for (int i = threadIdx.x; i < rows * d; i += kThreads) {
        const int r = i / d, c = i - (i / d) * d;
        const int qi = r / group, g = r - qi * group;
        const int b = a.q_gather[task * a.max_q + qi];
        qs[r * ldq + c] =
            to_f32(q[((size_t)b * a.h_q + kv * group + g) * d + c]);
        acc[r * d + c] = 0.f;
      }
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        ms[r] = kMask;
        ls[r] = 0.f;
      }
      for (int i = threadIdx.x; i < nq; i += kThreads) {
        qp[i] = a.q_pos[task * a.max_q + i];
      }
    }

    // this step's page of K and V for KV head `kv`, upcast to f32: all of
    // a thread's vector loads are issued before any is stored, so the
    // block waits on global memory once per round, not once per element
    const int n4 = page * d4;
    for (int base = 0; base < n4; base += kThreads * kUnroll) {
      float4 kr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + threadIdx.x;
        if (i < n4) {
          const int j = i / d4, c = (i - j * d4) * 4;
          const size_t off = (((size_t)pg * page + j) * a.n_kv + kv) * d + c;
          kr[u] = load4(kp + off);
          vr[u] = load4(vp + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + threadIdx.x;
        if (i < n4) {
          const int j = i / d4, c = (i - j * d4) * 4;
          *reinterpret_cast<float4*>(ks + j * ldq + c) = kr[u];
          *reinterpret_cast<float4*>(vs + j * d + c) = vr[u];
        }
      }
    }
    __syncthreads();

    // scores s[r, j] = <q_r, k_j> * scale, masked to kMask
    for (int i = threadIdx.x; i < rows * page; i += kThreads) {
      const int r = i / page, j = i - (i / page) * page;
      const float4* qr = reinterpret_cast<const float4*>(qs + r * ldq);
      const float4* kr = reinterpret_cast<const float4*>(ks + j * ldq);
      float s = 0.f;
      for (int c = 0; c < d4; ++c) {
        const float4 x = qr[c], y = kr[c];
        s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      const bool vis = visible(pos0 + j, j, kvlen, qp[r / group], a.window);
      sc[i] = vis ? s * a.scale : kMask;
    }
    __syncthreads();

    // online softmax over the page, one thread per row
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      float* sr = sc + r * page;
      const int qpos = qp[r / group];
      float mx = ms[r];
      for (int j = 0; j < page; ++j) mx = fmaxf(mx, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < page; ++j) {
        const float e = visible(pos0 + j, j, kvlen, qpos, a.window)
                            ? expf(sr[j] - mx)
                            : 0.f;
        sr[j] = e;
        sum += e;
      }
      const float alpha = expf(ms[r] - mx);
      ls[r] = ls[r] * alpha + sum;
      ms[r] = mx;
      al[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V, four columns a thread
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4, c4 = i - (i / d4) * d4;
      float4* ar = reinterpret_cast<float4*>(acc + r * d) + c4;
      const float* pr = sc + r * page;
      const float alpha = al[r];
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < page; ++j) {
        const float pj = pr[j];
        const float4 v = reinterpret_cast<const float4*>(vs + j * d)[c4];
        u.x += pj * v.x;
        u.y += pj * v.y;
        u.z += pj * v.z;
        u.w += pj * v.w;
      }
      float4 o = *ar;
      o.x = o.x * alpha + u.x;
      o.y = o.y * alpha + u.y;
      o.z = o.z * alpha + u.z;
      o.w = o.w * alpha + u.w;
      *ar = o;
    }

    if (a.step_last[idx]) {
      __syncthreads();
      for (int i = threadIdx.x; i < rows * d; i += kThreads) {
        const int r = i / d, c = i - (i / d) * d;
        const int qi = r / group, h = kv * group + (r - qi * group);
        const size_t orow = (size_t)(task * a.max_q + qi) * a.h_q + h;
        a.o[orow * d + c] = acc[r * d + c] / fmaxf(ls[r], 1e-30f);
      }
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        const int qi = r / group, h = kv * group + (r - qi * group);
        const size_t orow = (size_t)(task * a.max_q + qi) * a.h_q + h;
        a.m[orow] = ms[r];
        a.l[orow] = ls[r];
      }
    }
    __syncthreads();  // the next step overwrites ks/vs/sc (and qs/acc)
  }
}

template <typename QT, typename KVT>
cudaError_t launch(const PacArgs& a, int num_lanes, size_t smem,
                   cudaStream_t stream) {
  auto kernel = pac_kernel<QT, KVT>;
  // raise the dynamic shared memory cap once per instantiation
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cap = smem;
  }
  kernel<<<dim3(num_lanes, a.n_kv), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t codec_pac_smem_bytes(int max_q, int group, int d,
                                       int page) {
  const size_t R = (size_t)max_q * group;
  const size_t ldq = d + 4;
  const size_t floats = R * ldq + page * ldq + (size_t)page * d + R * d +
                        R * page + 3 * R;
  return floats * sizeof(float) + (size_t)max_q * sizeof(int);
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
  a.scale = scale;
  const size_t smem = codec_pac_smem_bytes(max_q, h_q / n_kv, d, page);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = kv_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, num_lanes, smem, s)
                  : launch<__nv_bfloat16, float>(a, num_lanes, smem, s);
  } else {
    err = kv_bf16 ? launch<float, __nv_bfloat16>(a, num_lanes, smem, s)
                  : launch<float, float>(a, num_lanes, smem, s);
  }
  return static_cast<int>(err);
}
