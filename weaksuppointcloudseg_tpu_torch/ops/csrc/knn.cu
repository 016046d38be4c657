// Kernel B12: k nearest neighbours of f32 points, with their squared
// distances on request.
//
// Replaces weaksuppointcloudseg_tpu/ops/knn_pallas.py::knn_pallas (bodies
// _knn_kernel and _knn_kernel_fast). The distance pass and the selection
// live in knn_tiles.cuh (shared with kernel B15); this file adds the
// output epilogue: idx[b,i,0..k) nearest first and, optionally,
// sqd[b,i,0..k). 1 <= k <= 64.
//
// What bounds it on an H100: f32 FMAs. The Gram is symmetric, so the
// function needs B*N*(N+1)/2 dot products of C f32 FMAs (17.2 GFLOP at
// B=64, N=2048, C=64: 0.257 ms at the 67 TFLOP/s f32 peak); this kernel
// computes every (i, j), 0.51 ms at that peak, in IEEE f32 on the CUDA
// cores (tensor cores would change the bits kernel B1 shares). The
// outputs are a few MB. What the design does about it: an 8 x 4 register
// micro-tile per thread, so 12 shared-memory loads feed 128 FMAs; 128
// query rows a block, so each column tile fetched feeds 128 rows;
// cp.async double-buffering of the column tiles; and a streaming top-k
// whose one-compare filter drops nearly every pair, so at C=3 the
// selection no longer rescans N-wide rows. nvcc -Xptxas -v (sm_90a):
// 128 registers, no spills, both modes; shared memory 89.5 KB a block at
// C=64, k=20 (two blocks per SM), 41.5 KB at C=3.

#include "knn_tiles.cuh"

namespace {

// The row's warp writes the k columns and, on request, their distances.
struct KnnTileOut {
  int N, k;
  int32_t* idx;
  float* sqd;  // or null

  template <bool FAST>
  __device__ void finish(int b, int row, int lane, const uint64_t* list,
                         int idx_mask) const {
    const size_t o = ((size_t)b * N + row) * k;
    for (int s = lane; s < k; s += 32) {
      const uint64_t e = list[s];
      idx[o + s] = entry_col(e);
      if (sqd != nullptr) sqd[o + s] = entry_value<FAST>(e, idx_mask);
    }
  }
};

}  // namespace

// x [B,N,C] f32; norms: [B,N] f32 scratch; idx [B,N,k] int32; sqd [B,N,k]
// f32 or null. 1 <= k <= min(64, N), 1 <= B <= 65535. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape outside those limits).
extern "C" int knn_launch(const void* x, int B, int N, int C, int k, int fast,
                          int idx_bits, void* norms, void* idx, void* sqd,
                          void* stream) {
  const KnnTileOut out{N, k, (int32_t*)idx, (float*)sqd};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  return (int)(fast ? knn_tiles_launch<true>(xf, B, N, C, k, TT_K_MAX,
                                             idx_bits, (float*)norms, out, s)
                    : knn_tiles_launch<false>(xf, B, N, C, k, TT_K_MAX,
                                              idx_bits, (float*)norms, out, s));
}
