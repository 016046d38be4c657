// Kernel B4: the batch-norm backward folded into the neighbour scatter.
//
// Replaces weaksuppointcloudseg_tpu/ops/scatter_pallas.py::
// scatter_bn_bwd_pallas (_scatter_bn_kernel). For every point p, slot j and
// channel c, the cotangent of the pre-BN activation y [B, P, k, C] is
//   dy = (first + alpha[c]) + beta[c] * y          (f32)
// with first = sv[c] * dz[p,j,c] (dense mode) or q[p,c] * 1[asel[p,c] == j]
// (sparse mode). Out: du[p,c] = sum_j dy in f32, and dv[b, idx[p,j], c] +=
// bf16(dy) (the TPU kernel scatters bf16 operands through its one-hot
// matmul when y is bf16), accumulated in f32.
//
// What bounds it on an H100: the bytes. At B=32, P=N=2048, k=20, C=64 the
// kernel must read y and dz (168 MB each, bf16) and idx, and write du and
// dv (16.8 MB each): 0.11 ms at 3.35 TB/s.
//
// Design: two passes over the graph's inverse (scatter_add.cu, built first)
// and no float atomics.
// 1. du: one thread per (point, two adjacent channels when C is even),
//    channels fastest, walks the k slots in order: dy is assembled from y,
//    dz or (q, asel) and the per-channel constants with __fadd_rn /
//    __fmul_rn, du sums it in registers from zero, and bf16(dy) goes to a
//    [B, P, k, C] scratch (coalesced bf16x2 loads and stores).
// 2. dv: B13's gather-sum of the scratch (csr_gather.cuh): each row of dv
//    sums its sources' bf16(dy) in ascending slot order and is written
//    once. So dv and du are the same bit for bit on every launch and equal
//    the plain versions' bit for bit. The scratch costs a write and a read
//    of y's size, which the atomics of the first version kept in L2; a
//    sparse-mode variant that recomputed dy in the gather from y and the
//    routed values (no scratch) was several times slower on an H100: each
//    source then waits on three row loads instead of one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_gather.cuh"

namespace {

constexpr int THREADS = 256;

// one thread per (point, V adjacent channels), channels fastest
template <int V, bool DENSE>
__global__ void __launch_bounds__(THREADS) scatter_bn_du_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ dz,
    const float* __restrict__ q, const int32_t* __restrict__ asel,
    const float* __restrict__ sv, const float* __restrict__ alpha,
    const float* __restrict__ beta, long long total, int k, int C,
    __nv_bfloat16* __restrict__ dyb, float* __restrict__ du) {
  constexpr bool dense = DENSE;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e0 = (long long)blockIdx.x * THREADS + threadIdx.x;
       e0 < total / V; e0 += stride) {
    const long long e = e0 * V;  // (b*P + p)*C + c
    const long long pc = e / C;  // b*P + p
    const int c = (int)(e - pc * C);
    float al[V], be[V], s[V], qv[V], dus[V];
    int aj[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      al[v] = alpha[c + v];
      be[v] = beta[c + v];
      s[v] = dense ? sv[c + v] : 0.f;
      aj[v] = dense ? -1 : asel[e + v];
      qv[v] = dense ? 0.f : q[e + v];
      dus[v] = 0.f;
    }
    for (int j = 0; j < k; ++j) {
      const long long o = (pc * k + j) * C + c;
      float yv[V], dzv[V], dy[V];
      if constexpr (V == 2) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + o));
        yv[0] = a.x;
        yv[1] = a.y;
        if constexpr (DENSE) {
          const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dz + o));
          dzv[0] = d.x;
          dzv[1] = d.y;
        }
      } else {
        yv[0] = __bfloat162float(y[o]);
        if constexpr (DENSE) dzv[0] = __bfloat162float(dz[o]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float first = dense ? __fmul_rn(s[v], dzv[v])
                                  : (aj[v] == j ? qv[v] : 0.f);
        dy[v] = __fadd_rn(__fadd_rn(first, al[v]), __fmul_rn(be[v], yv[v]));
        dus[v] = __fadd_rn(dus[v], dy[v]);
      }
      if constexpr (V == 2) {
        *reinterpret_cast<__nv_bfloat162*>(dyb + o) = __floats2bfloat162_rn(dy[0], dy[1]);
      } else {
        dyb[o] = __float2bfloat16_rn(dy[0]);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) du[e + v] = dus[v];
  }
}

}  // namespace

// idx [B,P,k] int32; y [B,P,k,C] bf16; dense: dz [B,P,k,C] bf16 and sv [C]
// f32 (q, asel null); sparse: q [B,P,C] f32 and asel [B,P,C] int32 (dz, sv
// null); alpha/beta [C] f32; offsets [B,N+1] / src [B,P*k] int32: the
// inverse of idx (scatter_add.cu), built first (work as for
// inverse_graph_launch). dyb [B,P,k,C] bf16 scratch; dv [B,N,C] f32 and
// du [B,P,C] f32, written whole. Returns a cudaError_t.
extern "C" int scatter_bn_bwd_launch(const void* idx, void* offsets,
                                     void* src, void* work,
                                     long long work_elems, const void* y,
                                     const void* dz, const void* q,
                                     const void* asel, const void* sv,
                                     const void* alpha, const void* beta,
                                     int B, int P, int k, int N, int C,
                                     void* dyb, void* dv, void* du,
                                     void* stream) {
  if ((dz == nullptr) == (q == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int built = inverse_graph_launch(idx, B, P, k, N, offsets, src, work,
                                         work_elems, stream);
  if (built != 0) return built;
  const long long total = (long long)B * P * C;
  if (total > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    const int V = C % 2 == 0 ? 2 : 1;  // bf16x2 loads and stores
    const long long want = (total / V + THREADS - 1) / THREADS;
    const int grid = (int)(want < (long long)sms * 16 ? want : (long long)sms * 16);
    auto kernel = V == 2 ? (dz ? scatter_bn_du_kernel<2, true>
                               : scatter_bn_du_kernel<2, false>)
                         : (dz ? scatter_bn_du_kernel<1, true>
                               : scatter_bn_du_kernel<1, false>);
    kernel<<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)y, (const __nv_bfloat16*)dz, (const float*)q,
        (const int32_t*)asel, (const float*)sv, (const float*)alpha,
        (const float*)beta, total, k, C, (__nv_bfloat16*)dyb, (float*)du);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int S = P * k;
  return (int)csr_gather((const int32_t*)offsets, (const int32_t*)src, B, N,
                         S, C, bf16_val((const __nv_bfloat16*)dyb, S, C),
                         (float*)dv, s);
}
