// Kernel B6 (gather): s[b,n,:] = sum_j w[b,n,j] * f[b, idx[b,n,j], :] from
// a given kNN graph, the neighbour side of the smoothness loss.
//
// Replaces weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::
// _wgather_pre_impl (body _kernel_wagg_pre), which builds one combined
// weighted one-hot matrix per row tile and gathers with a hi/lo-split bf16
// matmul because a TPU has no indexed loads. Here each output element is a
// plain f32 sum of k products (wgather.cuh), so the result differs from
// the Pallas kernel's by that split's ~2^-16 relative error, not from the
// exact sum.
//
// What bounds it on an H100: the bytes. At B=64, N=2048, k=10, Cf=51 it
// reads idx and w (10.5 MB) and f (13.4 MB of bf16) and writes s (26.7 MB
// of f32): 0.015 ms at 3.35 TB/s. The neighbour rows it reads again (k of
// them per point) are 102-byte rows of a cloud that stays in the 50 MB L2.
//
// Design: the simple correct one. One thread per output element (point,
// channel), channels fastest, so the threads of a warp read neighbouring
// channels of the same neighbour rows and broadcast-load the same (idx, w).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgather.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) wgather_pre_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ w,
    const __nv_bfloat16* __restrict__ f, int N, int Cf, int k,
    long long total, float* __restrict__ s) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += stride) {
    const long long p = e / Cf;  // b*N + n
    const int c = (int)(e - p * Cf);
    const int32_t* ip = idx + p * k;
    const float* wp = w + p * k;
    const __nv_bfloat16* fb = f + (p / N) * N * Cf;
    s[e] = weighted_sum(fb, N, Cf, c, k, [&](int j, int& t, float& wj) {
      t = ip[j];
      wj = wp[j];
    });
  }
}

}  // namespace

// idx [B,N,k] int32, w [B,N,k] f32, f [B,N,Cf] bf16, s [B,N,Cf] f32.
// Returns a cudaError_t.
extern "C" int wgather_pre_launch(const void* idx, const void* w, const void* f,
                                  int B, int N, int k, int Cf, void* s,
                                  void* stream) {
  const long long total = (long long)B * N * Cf;
  if (total == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const long long want = (total + THREADS - 1) / THREADS;
  const int grid = (int)(want < (long long)sms * 16 ? want : (long long)sms * 16);
  wgather_pre_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)idx, (const float*)w, (const __nv_bfloat16*)f, N, Cf, k,
      total, (float*)s);
  return (int)cudaGetLastError();
}
