// Kernel B12: k nearest neighbours of f32 points, with their squared
// distances on request.
//
// Replaces weaksuppointcloudseg_tpu/ops/knn_pallas.py::knn_pallas (bodies
// _knn_kernel and _knn_kernel_fast). For every point i of every cloud b it
// computes the squared distances from x[b,i] to all x[b,j] in IEEE f32, in
// the Pallas kernel's order of additions,
//   d = (-2 x_i.x_j + |x_i|^2) + |x_j|^2,
// selects the k nearest and writes idx[b,i,0..k) nearest first and,
// optionally, sqd[b,i,0..k). Exact mode keeps d unclamped and breaks ties by
// the lowest index (lax.top_k's order); fast mode clamps d at 0 and takes one
// min over the packed int32 "distance bits with the low idx_bits replaced by
// the column", so near-ties may order differently (held to an agreement
// rate). In both modes NaN distances come after +inf, in column order, as
// the plain version's stable sort puts them.
//
// What bounds it on an H100: the distance pass. The Gram is symmetric, so
// the function needs B*N*(N+1)/2 dot products of C f32 FMAs (17.2 GFLOP at
// B=64, N=2048, C=64: 0.257 ms at the 67 TFLOP/s f32 peak); this kernel
// computes every (i, j) and so does twice that. The outputs are a few MB.
// At C=3 the k selection rounds over N-wide rows take the time, not the
// arithmetic.
//
// Design (B1's, ops/csrc/knn_edge.cu, without its y1/moments epilogue and
// with f32 inputs): one block holds ROWS query rows and their full distance
// rows in shared memory (ROWS*N*4 bytes), so the B x N x N matrix never
// reaches device memory. Squared norms come from a small first kernel. The
// block walks the columns in tiles of TJ points staged in shared memory
// (rows padded to a stride = 4 mod 32 floats, so float4 loads are
// conflict-free); each thread owns one column of the tile against all ROWS
// query rows. When C is a multiple of 4 (C <= 4*MAXQ, rows 16-byte
// aligned) the next tile's float4 loads are issued into registers before
// the current tile is computed. Channels are summed in order 0..C-1 with
// fmaf in every chain.
// Selection (select.cuh): the distance rows are stored as int32 keys; one
// warp per row; each lane keeps the minimum of its strided subset of
// columns; a round is a warp shuffle argmin over the 32 lane minima, after
// which only the lane that owned the winner rescans.

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

template <bool FAST>
__global__ void __launch_bounds__(THREADS) knn_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int N, int C,
    int stride, int k, int idx_mask, bool vec, int32_t* __restrict__ idx_out,
    float* __restrict__ sqd_out) {
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
  int lk, lc;
  lane_min(drow, N, lane, lk, lc);
  const size_t ko = ((size_t)b * N + row) * k;
  for (int round = 0; round < k; ++round) {
    int bk = lk, bc = lc;
    warp_min<FAST>(bk, bc);
    if (lane == 0) {
      idx_out[ko + round] = bc;
      if (sqd_out != nullptr) {
        sqd_out[ko + round] =
            FAST ? __int_as_float(bk & ~idx_mask) : key_value(bk);
      }
    }
    if ((bc & 31) == lane) {  // the owner knocks the winner out, rescans
      drow[bc] = KEY_KNOCKOUT;
      lane_min(drow, N, lane, lk, lc);
    }
  }
}

template <bool FAST>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const float* x,
                   const float* norms, int N, int C, int stride, int k,
                   int idx_mask, bool vec, void* idx, void* sqd) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  knn_kernel<FAST><<<grid, THREADS, smem, s>>>(
      x, norms, N, C, stride, k, idx_mask, vec, (int32_t*)idx, (float*)sqd);
  return cudaGetLastError();
}

}  // namespace

// x [B,N,C] f32; norms: [B,N] f32 scratch; idx [B,N,k] int32; sqd [B,N,k]
// f32 or null. Returns a cudaError_t (cudaErrorInvalidValue when the shape
// exceeds shared memory).
extern "C" int knn_launch(const void* x, int B, int N, int C, int k, int fast,
                          int idx_bits, void* norms, void* idx, void* sqd,
                          void* stream) {
  const int stride = (C + 3) / 4 * 4 + 4;  // = 4 mod 32 when C % 32 == 0
  const size_t smem =
      4 * ((size_t)(TJ + ROWS) * stride + (size_t)ROWS * N);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int points = B * N;
  sqnorm_kernel<<<(points + 255) / 256, 256, 0, s>>>((const float*)x, points, C,
                                                     (float*)norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const int idx_mask = (1 << idx_bits) - 1;
  // float4 tile loads need 16-byte aligned rows
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  err = fast ? launch<true>(grid, smem, s, (const float*)x,
                            (const float*)norms, N, C, stride, k, idx_mask, vec,
                            idx, sqd)
             : launch<false>(grid, smem, s, (const float*)x,
                             (const float*)norms, N, C, stride, k, idx_mask,
                             vec, idx, sqd);
  return (int)err;
}
