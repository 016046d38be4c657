// Kernel B15: kNN of the graph points g + the neighbour-row gather of f,
// in one pass:
//   idx[b,n,:]    = the k nearest of g[b,n] (self included), nearest first,
//   nbr[b,n,j,:]  = f[b, idx[b,n,j], :], an exact, bitwise copy,
//   sqd[b,n,j]    = the selected squared distance (on request).
//
// Replaces weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::
// _knn_gather_fwd_impl (body _kernel_knn_gather), whose selection rounds
// double as one-hot masks that gather f on the MXU (exact for bf16 f,
// rounded for f32 f on a TPU). Here the distance pass and the selection
// are kernel B12's (knn_rows.cuh, exact and fast modes) on f32 g; the
// wrapper widens a bf16 g exactly, so the distances, and with them the
// indices, are bit for bit kernel B1's on the same g (the same norms,
// the same fmaf chains over channels 0..Cg-1, the same keys). The
// epilogue copies rows as kernel B14 does (gather_rows.cu), for bf16 and
// f32 f alike.
//
// What bounds it on an H100: at B=64, N=2048, Cg=Cf=64, k=20 in bf16 the
// bytes (the nbr write, 335.5 MB, with g, f and idx: 0.113 ms at
// 3.35 TB/s) outweigh the symmetric bf16 Gram (17.2 GFLOP, 0.017 ms on
// the tensor cores). This kernel computes the Gram on the CUDA cores in
// f32 and, as B12, every (i, j) pair, so the distance pass takes the
// time; at Cg=3 the k selection rounds over N-wide rows do.
//
// Epilogue: after round r the warp's lane r keeps the winner's column and
// distance (k <= 32). After the k rounds the lanes write idx (and sqd),
// park the k columns in the warp's spent distance row (k <= N), and copy
// the k rows of f into nbr in chunks of VB bytes, neighbouring lanes on
// neighbouring chunks, so a warp's stores are contiguous. The rows are 6
// bytes (Cf=3, bf16), 18 (Cf=9) or 128 (Cf=64), so the launcher takes the
// widest chunk of 16, 8, 4 or 2 bytes that divides the row and to which
// both f and nbr are aligned; a chunk never crosses a row.

#include <stdint.h>

#include "knn_rows.cuh"

namespace {

struct GatherOut {
  const char* f;  // [B, N, row_bytes]
  int N, k, row_bytes, vb;
  int32_t* idx;
  char* nbr;      // [B, N, k, row_bytes]
  float* sqd;     // or null
  int my_col;
  float my_val;

  __device__ void take(int, int, int lane, int round, int col, float value) {
    if (lane == round) {
      my_col = col;
      my_val = value;
    }
  }

  template <class T>
  __device__ void copy_rows(int b, int row, int lane, const int* sel) const {
    const int rc = row_bytes / (int)sizeof(T);  // chunks per row
    const T* src = reinterpret_cast<const T*>(f) + (size_t)b * N * rc;
    T* dst = reinterpret_cast<T*>(nbr) + ((size_t)b * N + row) * k * rc;
    const int per_point = k * rc;
    for (int e = lane; e < per_point; e += 32) {
      const int j = e / rc;
      const int c = e - j * rc;
      dst[e] = src[(size_t)sel[j] * rc + c];
    }
  }

  __device__ void finish(int b, int row, int lane, int* drow) {
    const size_t o = ((size_t)b * N + row) * k;
    if (lane < k) {
      idx[o + lane] = my_col;
      if (sqd != nullptr) sqd[o + lane] = my_val;
      drow[lane] = my_col;
    }
    __syncwarp();
    switch (vb) {
      case 16: copy_rows<uint4>(b, row, lane, drow); break;
      case 8: copy_rows<uint2>(b, row, lane, drow); break;
      case 4: copy_rows<uint32_t>(b, row, lane, drow); break;
      default: copy_rows<uint16_t>(b, row, lane, drow); break;
    }
  }
};

int chunk_bytes(int row_bytes, const void* f, const void* nbr) {
  for (int vb = 16; vb > 2; vb /= 2) {
    if (row_bytes % vb == 0 && (uintptr_t)f % vb == 0 &&
        (uintptr_t)nbr % vb == 0) {
      return vb;
    }
  }
  return 2;
}

}  // namespace

// g [B,N,Cg] f32, f [B,N,row_bytes] (bf16 or f32 rows, row_bytes even);
// norms: [B,N] f32 scratch; idx [B,N,k] int32, nbr [B,N,k,row_bytes],
// sqd [B,N,k] f32 or null. 1 <= k <= 32 and k <= N. Returns a cudaError_t
// (cudaErrorInvalidValue when the shape exceeds shared memory or k or the
// row is out of range).
extern "C" int knn_gather_launch(const void* g, const void* f, int B, int N,
                                 int Cg, int row_bytes, int k, int fast,
                                 int idx_bits, void* norms, void* idx,
                                 void* nbr, void* sqd, void* stream) {
  if (k < 1 || k > 32 || k > N || row_bytes < 2 || row_bytes % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const GatherOut out{(const char*)f, N, k, row_bytes,
                      chunk_bytes(row_bytes, f, nbr), (int32_t*)idx,
                      (char*)nbr, (float*)sqd, 0, 0.f};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* gf = (const float*)g;
  return (int)(fast ? knn_rows_launch<true>(gf, B, N, Cg, k, idx_bits,
                                            (float*)norms, out, st)
                    : knn_rows_launch<false>(gf, B, N, Cg, k, idx_bits,
                                             (float*)norms, out, st));
}
