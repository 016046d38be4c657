// Kernel B13: out[b, idx[b,p,j], :] += g[b,p,j,:], the backward of the
// neighbour gather.
//
// Replaces weaksuppointcloudseg_tpu/ops/scatter_pallas.py::scatter_add_pallas
// (body _scatter_kernel), which builds one-hot tiles and sums with MXU
// matmuls because a TPU has no scattered atomic adds.
//
// What bounds it on an H100: the bytes. At B=64, P=N=2048, k=20, C=64 the
// cotangent g is 671 MB of f32 and idx 10.5 MB, read once; out is 33.5 MB,
// written once: 0.21 ms at 3.35 TB/s. Every element of g is one f32 atomic
// add into out, which stays in the 50 MB L2.
//
// Design: the simple correct one. Threads walk the flat [B*P*k, C] array with
// c fastest, so a warp reads 32 consecutive floats of g and adds them into 32
// consecutive floats of one out row (coalesced loads, coalesced atomics).
// The k contributions to one row arrive in an order that changes from run to
// run, so the sums are not bitwise reproducible: the tests hold them to a
// relative tolerance. The wrapper zero-fills out. Targets outside [0, N) are
// skipped rather than written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) scatter_add_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ g,
    long long rows_per_batch, int N, int C, long long total,
    float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += stride) {
    const long long row = e / C;  // (b*P + p)*k + j
    const int c = (int)(e - row * C);
    const int t = idx[row];
    if ((unsigned)t >= (unsigned)N) continue;
    const long long b = row / rows_per_batch;
    atomicAdd(&out[(b * N + t) * C + c], g[e]);
  }
}

}  // namespace

// idx [B,P,k] int32, g [B,P,k,C] f32, out [B,N,C] f32 (zeroed by the
// caller). Returns a cudaError_t.
extern "C" int scatter_add_launch(const void* idx, const void* g, int B, int P,
                                  int k, int N, int C, void* out,
                                  void* stream) {
  const long long total = (long long)B * P * k * C;
  if (total == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const long long want = (total + THREADS - 1) / THREADS;
  const int grid = (int)(want < (long long)sms * 16 ? want : (long long)sms * 16);
  scatter_add_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)idx, (const float*)g, (long long)P * k, N, C, total,
      (float*)out);
  return (int)cudaGetLastError();
}
