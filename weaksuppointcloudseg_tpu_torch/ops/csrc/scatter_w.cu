// Kernel B6 (scatter): out[b, idx[b,p,j], :] += w[b,p,j] * ct[b,p,:], the
// backward of the weighted gathers B6 and B9 (the smoothness loss's
// cotangent of f).
//
// Replaces weaksuppointcloudseg_tpu/ops/scatter_pallas.py::
// scatter_add_weighted_pallas (body _scatter_w_kernel), which builds a
// combined weighted one-hot matrix per tile and sums with one matmul
// because a TPU has no scattered atomic adds.
//
// What bounds it on an H100: the bytes. At B=64, P=N=2048, k=10, C=51 it
// reads idx and w (10.5 MB) and the f32 cotangent (26.7 MB) once and
// writes out (26.7 MB) once: 0.019 ms at 3.35 TB/s. The k atomic adds per
// cotangent element land in out, which stays in the 50 MB L2.
//
// Design (B13's, ops/csrc/scatter_add.cu): one thread per cotangent element
// (point, channel), channels fastest. It loads ct[b,p,c] once for all k
// slots and adds w * ct with one f32 atomicAdd per slot, so the threads of
// a warp add into neighbouring channels of one out row. The k
// contributions to a row arrive in an order that changes from run to run,
// so the sums are not bitwise reproducible: the tests hold them to 1e-5 of
// the sum of magnitudes (ROADMAP C4). The wrapper zero-fills out. Targets
// outside [0, N) are skipped rather than written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) scatter_add_weighted_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ w,
    const float* __restrict__ ct, int P, int k, int N, int C, long long total,
    float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += stride) {
    const long long row = e / C;  // b*P + p
    const int c = (int)(e - row * C);
    const float g = ct[e];
    float* ob = out + (row / P) * N * C + c;
    for (int j = 0; j < k; ++j) {
      const int t = idx[row * k + j];
      if ((unsigned)t >= (unsigned)N) continue;
      atomicAdd(ob + (long long)t * C, __fmul_rn(w[row * k + j], g));
    }
  }
}

}  // namespace

// idx [B,P,k] int32, w [B,P,k] f32, ct [B,P,C] f32, out [B,N,C] f32 (zeroed
// by the caller). Returns a cudaError_t.
extern "C" int scatter_add_weighted_launch(const void* idx, const void* w,
                                           const void* ct, int B, int P, int k,
                                           int N, int C, void* out,
                                           void* stream) {
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
  scatter_add_weighted_kernel<<<grid, THREADS, 0,
                                reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)idx, (const float*)w, (const float*)ct, P, k, N, C, total,
      (float*)out);
  return (int)cudaGetLastError();
}
