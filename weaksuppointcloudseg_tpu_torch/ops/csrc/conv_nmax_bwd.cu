// Kernel B5 (backward): the N-max block's backward on the tensor cores.
//
// Replaces weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py::
// conv_nmax_bwd_pallas (_kernel_nmax_bwd). For h [B, N, C1] bf16 and the
// routed gradient q / winning row asel [B, C2]:
//   y   = bf16(h @ W + b)                            (recomputed)
//   dy  = (q * 1[n == asel] + alpha) + beta * y      (f32)
//   dh  = bf16(bf16(dy) @ W^T),  dW = h^T bf16(dy),  db = sum dy (from f32 dy)
// Every product takes bf16 operands with f32 accumulation, as the TPU
// kernel's MXU dots do; sums run in another order than the plain version's.
//
// What bounds it on an H100: the three products, 2*B*N*C1*C2 FLOPs each
// (2.6e10 at 32x2048, 192->1024), about 0.08 ms at the bf16 tensor rate.
//
// Design, simple first: three kernels built on WMMA 16x16x16 bf16
// fragments, 64x64 block tiles of four warps (32x32 each), operands staged
// in shared memory with the ragged row edge zero-filled.
//   1. dy: y tile = h tile @ W tile, then dy, db and bf16(dy) into a
//      [B*N, C2] bf16 scratch; each block writes its column sums of dy to a
//      workspace indexed by block;
//   2. dh = scratch @ W^T over C2 in chunks of 64;
//   3. dW = h^T @ scratch, split over the rows; each split writes its tile
//      to a workspace indexed by split.
// db and dW then sum their partials in block (split) order (det_sum.cuh):
// no float atomics, the same bits from launch to launch.
// The TPU kernel keeps bf16(dy) in VMEM; here it goes through memory once
// (134 MB at the path shape, written once, read twice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "det_sum.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 64, KC = 64;  // block tile and K chunk
constexpr int THREADS = 128;              // four warps, 32x32 each
constexpr int LDK = KC + 8;               // padded bf16 row of a K-chunk tile
constexpr int LDC = BN + 4;               // padded f32 row of the output tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// copy a [rows, 64] bf16 tile (rows >= valid are zero) from a row-major
// source with row stride ld into shared memory with row stride LDK
__device__ __forceinline__ void stage64(bf16* dst, const bf16* src, int rows,
                                        int valid, size_t ld) {
  for (int e = threadIdx.x; e < rows * 8; e += THREADS) {
    const int r = e >> 3, v = e & 7;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * ld + v * 8);
    *reinterpret_cast<uint4*>(dst + r * LDK + v * 8) = x;
  }
}

__device__ __forceinline__ void zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

__device__ __forceinline__ void store(float* cs, FragC (&acc)[2][2], int wm,
                                      int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
}

// 1. y = h @ W + b for rows [r0, r0+64) and channels [n0, n0+64); dy, db,
// bf16(dy) -> dyc
__global__ void __launch_bounds__(THREADS) nmax_bwd_dy_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ q,
    const int* __restrict__ asel, const float* __restrict__ alpha,
    const float* __restrict__ beta, int rows, int N, int C1, int C2,
    bf16* __restrict__ dyc, float* __restrict__ pdb) {
  __shared__ __align__(128) bf16 as[BM * LDK];
  __shared__ __align__(128) bf16 bs[KC * LDK];
  __shared__ __align__(128) float cs[BM * LDC];
  __shared__ float half_db[THREADS];
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  FragC acc[2][2];
  zero(acc);
  for (int k0 = 0; k0 < C1; k0 += KC) {
    __syncthreads();
    stage64(as, h + (size_t)r0 * C1 + k0, BM, min(BM, rows - r0), C1);
    stage64(bs, w + (size_t)k0 * C2 + n0, KC, KC, C2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDK + wn * 32 + j * 16, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  store(cs, acc, wm, wn);
  __syncthreads();
  const int cl = threadIdx.x & (BN - 1), c = n0 + cl;
  const float bias = b[c], al = alpha[c], be = beta[c];
  float dbs = 0.f;
  for (int r = threadIdx.x / BN; r < BM; r += THREADS / BN) {
    const int row = r0 + r;
    if (row >= rows) break;
    const int bi = row / N, n = row - bi * N;
    const float y = bf16_round(__fadd_rn(cs[r * LDC + cl], bias));
    const float first = asel[(size_t)bi * C2 + c] == n ? q[(size_t)bi * C2 + c] : 0.f;
    const float dy = __fadd_rn(__fadd_rn(first, al), __fmul_rn(be, y));
    dbs += dy;
    dyc[(size_t)row * C2 + c] = __float2bfloat16_rn(dy);
  }
  // two threads per column: the lower rows' half, then the other, into
  // pdb[column][row tile]
  half_db[threadIdx.x] = dbs;
  __syncthreads();
  if (threadIdx.x < BN) {
    pdb[(size_t)c * gridDim.x + blockIdx.x] =
        __fadd_rn(half_db[threadIdx.x], half_db[threadIdx.x + BN]);
  }
}

// 2. dh = dyc @ W^T for rows [r0, r0+64) and input channels [n0, n0+64)
__global__ void __launch_bounds__(THREADS) nmax_bwd_dh_kernel(
    const bf16* __restrict__ dyc, const bf16* __restrict__ w, int rows,
    int C1, int C2, bf16* __restrict__ dh) {
  __shared__ __align__(128) bf16 as[BM * LDK];
  __shared__ __align__(128) bf16 bs[BN * LDK];  // W[n0.., k0..] as [c1][c2]
  __shared__ __align__(128) float cs[BM * LDC];
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  FragC acc[2][2];
  zero(acc);
  for (int k0 = 0; k0 < C2; k0 += KC) {
    __syncthreads();
    stage64(as, dyc + (size_t)r0 * C2 + k0, BM, min(BM, rows - r0), C2);
    stage64(bs, w + (size_t)n0 * C2 + k0, BN, BN, C2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA fa[2];
      FragBc fb[2];  // B(k = c2, n = c1) = W[c1, c2]: column-major in bs
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * 32 + j * 16) * LDK + kk, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  store(cs, acc, wm, wn);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, cl = e % BN;
    if (r0 + r < rows) {
      dh[(size_t)(r0 + r) * C1 + n0 + cl] = __float2bfloat16_rn(cs[r * LDC + cl]);
    }
  }
}

// 3. dW[m0.., n0..] += h[rows of the split]^T @ dyc[rows of the split]
__global__ void __launch_bounds__(THREADS) nmax_bwd_dw_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ dyc, int rows,
    int C1, int C2, int rows_per_split, float* __restrict__ pdw) {
  __shared__ __align__(128) bf16 as[KC * LDK];  // h chunk [row][c1]
  __shared__ __align__(128) bf16 bs[KC * LDK];  // dyc chunk [row][c2]
  __shared__ __align__(128) float cs[BM * LDC];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ra = blockIdx.z * rows_per_split;
  const int rb = min(rows, ra + rows_per_split);
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  FragC acc[2][2];
  zero(acc);
  for (int k0 = ra; k0 < rb; k0 += KC) {
    const int valid = min(KC, rb - k0);
    __syncthreads();
    stage64(as, h + (size_t)k0 * C1 + m0, KC, valid, C1);
    stage64(bs, dyc + (size_t)k0 * C2 + n0, KC, valid, C2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragAc fa[2];  // A(m = c1, k = row) = h[row, c1]: column-major in as
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + kk * LDK + wm * 32 + i * 16, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDK + wn * 32 + j * 16, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  store(cs, acc, wm, wn);
  __syncthreads();
  // pdw[split][C1][C2] (an empty split writes zeros)
  float* out = pdw + (size_t)blockIdx.z * C1 * C2;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, cl = e % BN;
    out[(size_t)(m0 + r) * C2 + n0 + cl] = cs[r * LDC + cl];
  }
}

}  // namespace

// B5 backward. h [B, N, C1] bf16, q [B, C2] f32, asel [B, C2] int32,
// w [C1, C2] bf16, b/alpha/beta [C2] f32. dyc [B*N, C2] bf16 scratch;
// dh [B, N, C1] bf16; dw [C1, C2] and db [C2] f32, written whole; part:
// f32 scratch of part_elems >= C2 ceil(B N / 64) + ksplit C1 C2 floats.
// C1 and C2 must be multiples of 64; every pointer 16-byte aligned.
extern "C" int conv_nmax_bwd_launch(const void* h, const void* q,
                                    const void* asel, const void* w,
                                    const void* b, const void* alpha,
                                    const void* beta, int B, int N, int C1,
                                    int C2, int ksplit, void* dyc, void* dh,
                                    void* dw, void* db, void* part,
                                    long long part_elems, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * N;
  const int rtiles = (rows + BM - 1) / BM;
  if (C1 % 64 != 0 || C2 % 64 != 0 || ksplit < 1 ||
      part_elems < (long long)C2 * rtiles + (long long)ksplit * C1 * C2) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) {  // no rows: zero sums
    cudaError_t err = cudaMemsetAsync(dw, 0, sizeof(float) * C1 * C2, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(db, 0, sizeof(float) * C2, s);
    return (int)err;
  }
  float* pdb = (float*)part;
  float* pdw = pdb + (size_t)C2 * rtiles;
  nmax_bwd_dy_kernel<<<dim3(rtiles, C2 / BN), THREADS, 0, s>>>(
      (const bf16*)h, (const bf16*)w, (const float*)b, (const float*)q,
      (const int*)asel, (const float*)alpha, (const float*)beta, rows, N, C1,
      C2, (bf16*)dyc, pdb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nmax_bwd_dh_kernel<<<dim3(rtiles, C1 / BN), THREADS, 0, s>>>(
      (const bf16*)dyc, (const bf16*)w, rows, C1, C2, (bf16*)dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = ((rows + ksplit - 1) / ksplit + KC - 1) / KC * KC;
  nmax_bwd_dw_kernel<<<dim3(C2 / BN, C1 / BM, ksplit), THREADS, 0, s>>>(
      (const bf16*)h, (const bf16*)dyc, rows, C1, C2, per, pdw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_cols(pdb, rtiles, C2, (float*)db, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows(pdw, ksplit, C1 * C2, (float*)dw, s);
}
