// CoDec POR (partial output reduction, paper Alg. 3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/por.py::por (kernel body
// _por_kernel): the pairwise log-sum-exp merge of two flash partials over
// the same queries,
//   m = max(m1, m2),  a_i = exp(m_i - m) * l_i,  l = a1 + a2,
//   o = (o1 * a1 + o2 * a2) / max(l, 1e-30).
// In the decode engine it merges the frozen-plan partials with the
// growing-tail-page partials of every attention layer.
//
// What bounds it on the H100: a few FLOPs per element against 12 bytes read
// and 4 written, so HBM bytes (3.35 TB/s) bound it; at decode batch sizes the
// arrays are a few hundred KB and a launch costs more than the traffic.
//
// Design: one thread per (row, column) element of o, rows = N * h.  Each
// thread recomputes its row's m, a1, a2 and l (two exps; the row stats stay
// in L1) and the column-0 thread writes m and l.  Products and sums are
// rounded separately (__fmul_rn / __fadd_rn, no FMA contraction) so the
// result follows the plain torch version's rounding.

#include <cuda_runtime.h>

#include <cstddef>

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
