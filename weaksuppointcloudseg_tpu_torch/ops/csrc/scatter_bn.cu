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
// kernel reads y and dz (168 MB each, bf16) and idx, and writes du and dv
// (16.8 MB each): 0.11 ms at 3.35 TB/s. Each dy is one f32 atomic add into
// dv, which stays in the 50 MB L2.
//
// Design: B13's. One thread per (point, channel), channels fastest, walks
// the k slots: du stays in a register, dy is assembled from y, dz or (q,
// asel) and the per-channel constants, and each slot's bf16(dy) goes to dv
// with a coalesced f32 atomic. The k contributions to a row of dv arrive in
// an order that changes from run to run (ROADMAP C4); du sums in slot order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) scatter_bn_bwd_kernel(
    const int32_t* __restrict__ idx, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ dz, const float* __restrict__ q,
    const int32_t* __restrict__ asel, const float* __restrict__ sv,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    long long total, int P, int k, int N, int C, float* __restrict__ dv,
    float* __restrict__ du) {
  const bool dense = dz != nullptr;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += stride) {
    const long long pc = e / C;  // b*P + p
    const int c = (int)(e - pc * C);
    const long long b = pc / P;
    const float al = alpha[c], be = beta[c];
    const float s = dense ? sv[c] : 0.f;
    const int aj = dense ? -1 : asel[e];
    const float qv = dense ? 0.f : q[e];
    float dus = 0.f;
    for (int j = 0; j < k; ++j) {
      const long long o = (pc * k + j) * C + c;
      const float yv = __bfloat162float(y[o]);
      const float first = dense ? __fmul_rn(s, __bfloat162float(dz[o]))
                                : (aj == j ? qv : 0.f);
      const float dy = __fadd_rn(__fadd_rn(first, al), __fmul_rn(be, yv));
      dus = __fadd_rn(dus, dy);
      const int t = idx[pc * k + j];
      if ((unsigned)t < (unsigned)N) {
        atomicAdd(&dv[(b * N + t) * C + c],
                  __bfloat162float(__float2bfloat16_rn(dy)));
      }
    }
    du[e] = dus;
  }
}

}  // namespace

// idx [B,P,k] int32; y [B,P,k,C] bf16; dense: dz [B,P,k,C] bf16 and sv [C]
// f32 (q, asel null); sparse: q [B,P,C] f32 and asel [B,P,C] int32 (dz, sv
// null); alpha/beta [C] f32. dv [B,N,C] f32 (zeroed by the caller), du
// [B,P,C] f32. Returns a cudaError_t.
extern "C" int scatter_bn_bwd_launch(const void* idx, const void* y,
                                     const void* dz, const void* q,
                                     const void* asel, const void* sv,
                                     const void* alpha, const void* beta,
                                     int B, int P, int k, int N, int C,
                                     void* dv, void* du, void* stream) {
  if ((dz == nullptr) == (q == nullptr)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * P * C;
  if (total == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const long long want = (total + THREADS - 1) / THREADS;
  const int grid = (int)(want < (long long)sms * 16 ? want : (long long)sms * 16);
  scatter_bn_bwd_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)idx, (const __nv_bfloat16*)y, (const __nv_bfloat16*)dz,
      (const float*)q, (const int32_t*)asel, (const float*)sv,
      (const float*)alpha, (const float*)beta, total, P, k, N, C, (float*)dv,
      (float*)du);
  return (int)cudaGetLastError();
}
