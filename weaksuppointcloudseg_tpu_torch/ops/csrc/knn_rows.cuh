// The distance pass and k selection of kernel B12 (knn.cu), shared with
// kernel B9 (knn_wgather.cu), which runs them with a weighted-gather
// epilogue instead of B12's plain index output.
//
// For every point i of every cloud b the kernel computes the squared
// distances from x[b,i] to all x[b,j] in IEEE f32, in the Pallas kernels'
// order of additions (knn_pallas.py:121-127, edgeconv_pallas.py:110-119),
//   d = (-2 x_i.x_j + |x_i|^2) + |x_j|^2,
// and selects the k nearest, nearest first. Exact mode keeps d unclamped
// and breaks ties by the lowest index (lax.top_k's order); fast mode clamps
// d at 0 and takes one min over the packed int32 "distance bits with the
// low idx_bits replaced by the column", so near-ties may order differently
// (held to an agreement rate) and the selected distance has its low
// idx_bits cleared. In both modes NaN distances come after +inf, in column
// order, as the plain version's stable sort puts them.
//
// Design: one block holds ROWS query rows and their full distance rows in
// shared memory (ROWS*N*4 bytes), so the B x N x N matrix never reaches
// device memory. Squared norms come from a small first kernel. The block
// walks the columns in tiles of TJ points staged in shared memory (rows
// padded to a stride = 4 mod 32 floats, so float4 loads are
// conflict-free); each thread owns one column of the tile against all ROWS
// query rows. When C is a multiple of 4 (C <= 4*MAXQ, rows 16-byte
// aligned) the next tile's float4 loads are issued into registers before
// the current tile is computed. Channels are summed in order 0..C-1 with
// fmaf in every chain.
// Selection (select.cuh): the distance rows are stored as int32 keys; one
// warp per row; each lane keeps the minimum of its strided subset of
// columns; a round is a warp shuffle argmin over the 32 lane minima, after
// which only the lane that owned the winner rescans.
//
// Epilogue contract: every lane of a row's warp calls
//   e.take(b, row, lane, round, column, distance)
// after each round (the same column and distance on all lanes), and
//   e.finish(b, row, lane, drow)
// once after the k rounds, with drow the warp's distance row in shared
// memory (N ints, free for the epilogue's own use from then on).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int ROWS = 8;                   // query rows per block (one warp each)
constexpr int THREADS = 32 * ROWS;
constexpr int TJ = THREADS;               // columns per staged tile (one each)
constexpr int MAXQ = 16;                  // float4 chunks a thread prefetches

// |x_p|^2 in f32, channels summed in order (one thread per point).
__global__ void sqnorm_kernel(const float* __restrict__ x, int points, int C,
                              float* __restrict__ norms) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= points) return;
  float s = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = x[(size_t)p * C + c];
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  norms[p] = s;
}

// Stage points [p0, p0 + count) of x (row length C) as rows of `stride`
// floats, zero past C and past the last point.
__device__ __forceinline__ void stage_rows(const float* __restrict__ xb, int p0,
                                           int count, int n, int C, int stride,
                                           float* dst) {
  for (int e = threadIdx.x; e < count * stride; e += THREADS) {
    const int r = e / stride, c = e - r * stride;
    const int p = p0 + r;
    dst[e] = (p < n && c < C) ? xb[(size_t)p * C + c] : 0.f;
  }
}

struct TileChunks {
  float4 q[MAXQ];
};

__device__ __forceinline__ void load_tile(const float* __restrict__ xb, int j0,
                                          int n, int C, int nq, TileChunks& t) {
  const int cpr = C / 4;  // chunks per point
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    if (i < nq) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / cpr, cc = e - r * cpr;
      const int p = j0 + r;
      t.q[i] = (r < TJ && p < n)
          ? *reinterpret_cast<const float4*>(xb + (size_t)p * C + cc * 4)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void store_tile(const TileChunks& t, int C, int nq,
                                           int stride, float* dst) {
  const int cpr = C / 4;
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    if (i < nq) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / cpr, cc = e - r * cpr;
      if (r < TJ) *reinterpret_cast<float4*>(dst + r * stride + cc * 4) = t.q[i];
    }
  }
}

template <bool FAST, class Epilogue>
__global__ void __launch_bounds__(THREADS) knn_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int N, int C,
    int stride, int k, int idx_mask, bool vec, Epilogue epi) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* xs = reinterpret_cast<float*>(smem4);  // [TJ][stride] column tile
  float* xr = xs + TJ * stride;                 // [ROWS][stride] query rows
  int* dist = reinterpret_cast<int*>(xr + ROWS * stride);  // [ROWS][N] keys

  const float* xb = x + (size_t)b * N * C;
  const float* nb = norms + (size_t)b * N;
  stage_rows(xb, row0, ROWS, N, C, stride, xr);

  // ---- distance rows (the B x N x N matrix stays in shared memory) ----
  const int jj = threadIdx.x;  // this thread's tile column, against all rows
  float rn[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) rn[q] = row0 + q < N ? nb[row0 + q] : 0.f;
  const int quads = stride / 4 - 1;  // float4 groups holding the channels
  const int nq = (TJ * (C / 4) + THREADS - 1) / THREADS;
  const bool chunked = vec && nq <= MAXQ;
  TileChunks next;
  if (chunked) {
    // the padding channels [C, stride) of the tile stay zero throughout
    for (int e = threadIdx.x; e < TJ * (stride - C); e += THREADS) {
      const int r = e / (stride - C);
      xs[r * stride + C + (e - r * (stride - C))] = 0.f;
    }
    load_tile(xb, 0, N, C, nq, next);
  }
  for (int j0 = 0; j0 < N; j0 += TJ) {
    __syncthreads();  // the previous tile is consumed (and xr is staged)
    if (chunked) {
      store_tile(next, C, nq, stride, xs);
    } else {
      stage_rows(xb, j0, TJ, N, C, stride, xs);
    }
    __syncthreads();
    if (chunked && j0 + TJ < N) load_tile(xb, j0 + TJ, N, C, nq, next);
    const int j = j0 + jj;
    if (j >= N) continue;
    const float4* col = reinterpret_cast<const float4*>(xs + jj * stride);
    const float4* rows = reinterpret_cast<const float4*>(xr);
    float acc[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) acc[q] = 0.f;
    for (int c4 = 0; c4 < quads; ++c4) {
      const float4 cv = col[c4];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const float4 rv = rows[q * (stride / 4) + c4];
        acc[q] = fmaf(rv.x, cv.x, acc[q]);
        acc[q] = fmaf(rv.y, cv.y, acc[q]);
        acc[q] = fmaf(rv.z, cv.z, acc[q]);
        acc[q] = fmaf(rv.w, cv.w, acc[q]);
      }
    }
    const float cn = nb[j];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      float d = __fadd_rn(__fmul_rn(-2.f, acc[q]), rn[q]);
      d = __fadd_rn(d, cn);
      dist[(size_t)q * N + j] = FAST ? fast_key(d, j, idx_mask) : order_key(d);
    }
  }
  __syncthreads();

  // ---- k selection rounds, one warp per row ----
  const int row = row0 + warp;
  if (row >= N) return;
  int* drow = dist + (size_t)warp * N;
  Epilogue e = epi;
  int lk, lc;
  lane_min(drow, N, lane, lk, lc);
  for (int round = 0; round < k; ++round) {
    int bk = lk, bc = lc;
    warp_min<FAST>(bk, bc);
    e.take(b, row, lane, round, bc,
           FAST ? __int_as_float(bk & ~idx_mask) : key_value(bk));
    if ((bc & 31) == lane) {  // the owner knocks the winner out, rescans
      drow[bc] = KEY_KNOCKOUT;
      lane_min(drow, N, lane, lk, lc);
    }
  }
  __syncwarp();
  e.finish(b, row, lane, drow);
}

// Padded row length (floats) of a staged tile of C-channel points; = 4
// mod 32 when C % 32 == 0.
inline int knn_rows_stride(int C) { return (C + 3) / 4 * 4 + 4; }

// Shared memory of one block: the column tile, the query rows and ROWS
// distance rows of N keys.
inline size_t knn_rows_smem(int N, int C) {
  return 4 * ((size_t)(TJ + ROWS) * knn_rows_stride(C) + (size_t)ROWS * N);
}

// Norms into the [B,N] scratch, then the rows kernel with epilogue `epi`.
// Returns cudaErrorInvalidValue when the shape exceeds shared memory.
template <bool FAST, class Epilogue>
cudaError_t knn_rows_launch(const float* x, int B, int N, int C, int k,
                            int idx_bits, float* norms, Epilogue epi,
                            cudaStream_t s) {
  const int stride = knn_rows_stride(C);
  const size_t smem = knn_rows_smem(N, C);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const int points = B * N;
  sqnorm_kernel<<<(points + 255) / 256, 256, 0, s>>>(x, points, C, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(knn_rows_kernel<FAST, Epilogue>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const int idx_mask = (1 << idx_bits) - 1;
  // float4 tile loads need 16-byte aligned rows
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  knn_rows_kernel<FAST, Epilogue><<<grid, THREADS, smem, s>>>(
      x, norms, N, C, stride, k, idx_mask, vec, epi);
  return cudaGetLastError();
}

}  // namespace
