// Kernel B9: kNN of f32 points + exp-weighted neighbour sum in one pass,
// the S3DIS smoothness loss's neighbour side:
//   idx[b,n,:] = the k nearest of x[b,n] (self included), nearest first,
//   w[b,n,j]   = exp(-max(d_j, 0) / gamma),
//   s[b,n,:]   = sum_j w[b,n,j] * f[b, idx[b,n,j], :].
//
// Replaces weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::
// _knn_wgather_impl (body _kernel_wagg), whose selection rounds accumulate
// a combined weighted one-hot matrix and gather with a hi/lo-split bf16
// matmul. Here the distance pass and the selection are kernel B12's
// (knn_rows.cuh, exact and fast modes, fast-mode distances with their low
// idx_bits cleared as _selection_rounds returns them), and the epilogue is
// kernel B6's weighted sum (wgather.cuh), so s is the exact f32 sum of the
// k products, ~2^-16 relative from the Pallas kernel's.
//
// What bounds it on an H100: the distance pass. At B=28, N=4096, Cg=6 the
// symmetric Gram needs 2.8 GFLOP of f32 FMAs (0.042 ms at 67 TFLOP/s); the
// bytes are ~12 MB. As for B12 at small C, the k selection rounds over
// N-wide rows in shared memory take the time.
//
// Epilogue: after round r the warp's lane r keeps the winner's column and
// weight (k <= 32); after the k rounds the lanes write idx and w, park the
// k pairs in the warp's spent distance row (2k <= N), and sum channels
// lane, lane+32, ... of the k neighbour rows of f.

#include <cuda_bf16.h>

#include "knn_rows.cuh"
#include "wgather.cuh"

namespace {

struct WGatherOut {
  const __nv_bfloat16* f;
  int N, Cf, k;
  float inv_gamma;
  int32_t* idx;
  float* s;
  float* w;
  int my_col;
  float my_w;

  __device__ void take(int, int, int lane, int round, int col, float value) {
    if (lane == round) {
      my_col = col;
      my_w = expf(-fmaxf(value, 0.f) * inv_gamma);
    }
  }

  __device__ void finish(int b, int row, int lane, int* drow) {
    const size_t o = ((size_t)b * N + row) * k;
    if (lane < k) {
      idx[o + lane] = my_col;
      w[o + lane] = my_w;
      drow[lane] = my_col;
      drow[k + lane] = __float_as_int(my_w);
    }
    __syncwarp();
    const __nv_bfloat16* fb = f + (size_t)b * N * Cf;
    float* sr = s + ((size_t)b * N + row) * Cf;
    for (int c = lane; c < Cf; c += 32) {
      sr[c] = weighted_sum(fb, N, Cf, c, k, [&](int j, int& t, float& wj) {
        t = drow[j];
        wj = __int_as_float(drow[k + j]);
      });
    }
  }
};

}  // namespace

// g [B,N,Cg] f32, f [B,N,Cf] bf16; norms: [B,N] f32 scratch; idx [B,N,k]
// int32, s [B,N,Cf] f32, w [B,N,k] f32. k <= 32 and 2k <= N. Returns a
// cudaError_t (cudaErrorInvalidValue when the shape exceeds shared memory
// or k is out of range).
extern "C" int knn_wgather_launch(const void* g, const void* f, int B, int N,
                                  int Cg, int Cf, int k, int fast,
                                  int idx_bits, float inv_gamma, void* norms,
                                  void* idx, void* s, void* w, void* stream) {
  if (k < 1 || k > 32 || 2 * k > N) return (int)cudaErrorInvalidValue;
  const WGatherOut out{(const __nv_bfloat16*)f, N, Cf, k, inv_gamma,
                       (int32_t*)idx, (float*)s, (float*)w, 0, 0.f};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* gf = (const float*)g;
  return (int)(fast ? knn_rows_launch<true>(gf, B, N, Cg, k, idx_bits,
                                            (float*)norms, out, st)
                    : knn_rows_launch<false>(gf, B, N, Cg, k, idx_bits,
                                             (float*)norms, out, st));
}
