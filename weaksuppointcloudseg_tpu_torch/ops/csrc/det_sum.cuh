// Fixed-order sums of per-block partials, shared by kernels B1
// (knn_edge.cu), B11 (knn_edge_pre.cu), B2 and B5 forward (conv_kmax.cu),
// B3 (conv_kmax_bwd.cu) and B5 backward (conv_nmax_bwd.cu).
//
// A kernel whose blocks each hold a partial sum writes it to a workspace
// indexed by block, with no atomics, and one of the two kernels below adds
// the partials in an order fixed by the block index alone. So every sum is
// the same bit for bit from launch to launch: blocks may run in any order,
// the reduction does not depend on it. The order depends on the shapes
// (the grid) only.
//
// sum_rows: part is [rows][width] (few rows): one thread per element adds
//   rows 0, 1, ..., rows - 1 in that order.
// sum_cols: part is [width][rows] (many rows): WPE warps per element; lane
//   l of warp w adds rows w*32 + l, w*32 + l + 32*WPE, ... in order, the
//   lanes then combine in a fixed butterfly and the warps in warp order.
//
// What bounds them: the workspace's bytes, read once (a few MB at most,
// from L2); each costs one launch on the kernel's stream.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int DSUM_THREADS = 256;

__global__ void __launch_bounds__(DSUM_THREADS) sum_rows_kernel(
    const float* __restrict__ part, int rows, int width,
    float* __restrict__ out) {
  const int e = blockIdx.x * DSUM_THREADS + threadIdx.x;
  if (e >= width) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s = __fadd_rn(s, part[(size_t)r * width + e]);
  out[e] = s;
}

template <int WPE>
__global__ void __launch_bounds__(DSUM_THREADS) sum_cols_kernel(
    const float* __restrict__ part, int rows, int width,
    float* __restrict__ out) {
  constexpr int EPB = DSUM_THREADS / 32 / WPE;  // elements per block
  __shared__ float ws[DSUM_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * EPB + warp / WPE;
  float s = 0.f;
  if (e < width) {
    const float* p = part + (size_t)e * rows;
    for (int r = (warp % WPE) * 32 + lane; r < rows; r += 32 * WPE) {
      s = __fadd_rn(s, p[r]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  }
  if constexpr (WPE == 1) {
    if (lane == 0 && e < width) out[e] = s;
  } else {
    if (lane == 0) ws[warp] = s;
    __syncthreads();
    if (warp % WPE == 0 && lane == 0 && e < width) {
      float t = ws[warp];
      for (int w = 1; w < WPE; ++w) t = __fadd_rn(t, ws[warp + w]);
      out[e] = t;
    }
  }
}

// out[e] = sum_r part[r * width + e]
inline cudaError_t sum_rows(const float* part, int rows, int width,
                            float* out, cudaStream_t s) {
  if (width <= 0) return cudaSuccess;
  sum_rows_kernel<<<(width + DSUM_THREADS - 1) / DSUM_THREADS, DSUM_THREADS,
                    0, s>>>(part, rows, width, out);
  return cudaGetLastError();
}

// out[e] = sum_r part[e * rows + r]
inline cudaError_t sum_cols(const float* part, int rows, int width,
                            float* out, cudaStream_t s) {
  if (width <= 0) return cudaSuccess;
  constexpr int W = DSUM_THREADS / 32;
  if (rows >= 2048) {
    sum_cols_kernel<W><<<width, DSUM_THREADS, 0, s>>>(part, rows, width, out);
  } else {
    sum_cols_kernel<1><<<(width + W - 1) / W, DSUM_THREADS, 0, s>>>(
        part, rows, width, out);
  }
  return cudaGetLastError();
}

}  // namespace
