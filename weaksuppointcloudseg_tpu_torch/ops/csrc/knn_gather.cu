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
// are kernel B12's (knn_tiles.cuh, exact and fast modes) on f32 g; the
// wrapper widens a bf16 g exactly, so the distances, and with them the
// indices, are bit for bit kernel B1's on the same g (the same norms,
// the same fmaf chains over channels 0..ceil4(Cg)-1, the same keys). The
// epilogue copies rows as kernel B14 does (gather_rows.cu), for bf16 and
// f32 f alike.
//
// What bounds it on an H100: at B=64, N=2048, Cg=Cf=64, k=20 in bf16 the
// bytes (the nbr write, 335.5 MB, with g, f and idx: 0.113 ms at
// 3.35 TB/s) outweigh the symmetric bf16 Gram (17.2 GFLOP, 0.017 ms on
// the tensor cores). This kernel computes the Gram on the CUDA cores in
// f32 for every (i, j) pair, to keep B1's bits, so its floor is B12's
// (0.51 ms of f32 FMAs at C=64); the design is B12's (register
// micro-tiles, cp.async double-buffering, a streaming top-k), and the row
// copies of one block overlap the distance pass of the other block on
// its SM. nvcc -Xptxas -v (sm_90a): 128 registers, no spills, both modes.
//
// Epilogue: for each of its rows the warp writes idx (and sqd) from the
// row's final sorted list and copies the k rows of f into nbr in chunks
// of VB bytes, neighbouring lanes on neighbouring chunks, so a warp's
// stores are contiguous. The rows are 6 bytes (Cf=3, bf16), 18 (Cf=9) or
// 128 (Cf=64), so the launcher takes the widest chunk of 16, 8, 4 or 2
// bytes that divides the row and to which both f and nbr are aligned; a
// chunk never crosses a row. 1 <= k <= 32.

#include <stdint.h>

#include "knn_tiles.cuh"

namespace {

struct GatherTileOut {
  const char* f;  // [B, N, row_bytes]
  int N, k, row_bytes, vb;
  int32_t* idx;
  char* nbr;      // [B, N, k, row_bytes]
  float* sqd;     // or null

  template <class T>
  __device__ void copy_rows(int b, int row, int lane,
                            const uint64_t* list) const {
    const int rc = row_bytes / (int)sizeof(T);  // chunks per row
    const T* src = reinterpret_cast<const T*>(f) + (size_t)b * N * rc;
    T* dst = reinterpret_cast<T*>(nbr) + ((size_t)b * N + row) * k * rc;
    const int per_point = k * rc;
    for (int e = lane; e < per_point; e += 32) {
      const int j = e / rc;
      const int c = e - j * rc;
      dst[e] = src[(size_t)entry_col(list[j]) * rc + c];
    }
  }

  template <bool FAST>
  __device__ void finish(int b, int row, int lane, const uint64_t* list,
                         int idx_mask) const {
    const size_t o = ((size_t)b * N + row) * k;
    if (lane < k) {
      const uint64_t e = list[lane];
      idx[o + lane] = entry_col(e);
      if (sqd != nullptr) sqd[o + lane] = entry_value<FAST>(e, idx_mask);
    }
    switch (vb) {
      case 16: copy_rows<uint4>(b, row, lane, list); break;
      case 8: copy_rows<uint2>(b, row, lane, list); break;
      case 4: copy_rows<uint32_t>(b, row, lane, list); break;
      default: copy_rows<uint16_t>(b, row, lane, list); break;
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
// sqd [B,N,k] f32 or null. 1 <= k <= min(32, N), 1 <= B <= 65535.
// Returns a cudaError_t (cudaErrorInvalidValue when k, the batch or the
// row is out of range).
extern "C" int knn_gather_launch(const void* g, const void* f, int B, int N,
                                 int Cg, int row_bytes, int k, int fast,
                                 int idx_bits, void* norms, void* idx,
                                 void* nbr, void* sqd, void* stream) {
  if (row_bytes < 2 || row_bytes % 2 != 0) return (int)cudaErrorInvalidValue;
  const GatherTileOut out{(const char*)f, N, k, row_bytes,
                          chunk_bytes(row_bytes, f, nbr), (int32_t*)idx,
                          (char*)nbr, (float*)sqd};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* gf = (const float*)g;
  return (int)(fast ? knn_tiles_launch<true>(gf, B, N, Cg, k, 32, idx_bits,
                                             (float*)norms, out, st)
                    : knn_tiles_launch<false>(gf, B, N, Cg, k, 32, idx_bits,
                                              (float*)norms, out, st));
}
