// Kernel B12: k nearest neighbours of f32 points, with their squared
// distances on request.
//
// Replaces weaksuppointcloudseg_tpu/ops/knn_pallas.py::knn_pallas (bodies
// _knn_kernel and _knn_kernel_fast). The distance pass and the selection
// live in knn_rows.cuh (shared with kernel B9); this file adds the output
// epilogue: idx[b,i,0..k) nearest first and, optionally, sqd[b,i,0..k).
//
// What bounds it on an H100: the distance pass. The Gram is symmetric, so
// the function needs B*N*(N+1)/2 dot products of C f32 FMAs (17.2 GFLOP at
// B=64, N=2048, C=64: 0.257 ms at the 67 TFLOP/s f32 peak); this kernel
// computes every (i, j) and so does twice that. The outputs are a few MB.
// At C=3 the k selection rounds over N-wide rows take the time, not the
// arithmetic.

#include "knn_rows.cuh"

namespace {

// Lane 0 of the row's warp writes each round's column and distance.
struct KnnOut {
  int N, k;
  int32_t* idx;
  float* sqd;  // or null

  __device__ void take(int b, int row, int lane, int round, int col,
                       float value) {
    if (lane != 0) return;
    const size_t o = ((size_t)b * N + row) * k + round;
    idx[o] = col;
    if (sqd != nullptr) sqd[o] = value;
  }

  __device__ void finish(int, int, int, int*) {}
};

}  // namespace

// x [B,N,C] f32; norms: [B,N] f32 scratch; idx [B,N,k] int32; sqd [B,N,k]
// f32 or null. Returns a cudaError_t (cudaErrorInvalidValue when the shape
// exceeds shared memory).
extern "C" int knn_launch(const void* x, int B, int N, int C, int k, int fast,
                          int idx_bits, void* norms, void* idx, void* sqd,
                          void* stream) {
  const KnnOut out{N, k, (int32_t*)idx, (float*)sqd};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  return (int)(fast ? knn_rows_launch<true>(xf, B, N, C, k, idx_bits,
                                            (float*)norms, out, s)
                    : knn_rows_launch<false>(xf, B, N, C, k, idx_bits,
                                             (float*)norms, out, s));
}
