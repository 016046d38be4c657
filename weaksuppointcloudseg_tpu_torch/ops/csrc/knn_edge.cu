// Kernel B1: fused kNN selection + first EdgeConv conv (y1 = v[idx] + u).
//
// Replaces weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::_knn_edge_impl
// (body _kernel_edge). For every point i of every cloud b it computes the
// squared distances from g[b,i] to all g[b,j] (bf16 values, f32 products and
// sums, f32 norms: d = (-2 g_i.g_j + |g_i|^2) + |g_j|^2), selects the k
// nearest (exact: value then lowest index, the order of lax.top_k; fast: one
// min over the packed int32 "distance bits | column"), and writes
//   idx[b,i,j]   the selected columns,
//   y1[b,i,j,:]  = bf16(f32(v[b,idx_j,:]) + f32(u[b,i,:])),
//   mom[0/1,:]   += sum / sum of squares of y1 over rows i < n_valid,
// and optionally the per-channel max/min of y1 over j with the first
// winning slot (with_minmax) and the selected distances (with_values).
//
// What bounds it on an H100: at the ShapeNet test shape (B=32, N=3000,
// k=20, C=64) the distance pass is B*N*N*Cg f32 FMAs (1.8e10 at Cg=64) on
// the CUDA cores, fed from shared memory; the y1 write is 246 MB of bf16;
// the selection is k argmin rounds over an N-wide row. Measured, the time
// grows with Cg (2.6 ms at Cg=3, 9.1 ms at Cg=64) and k=20 costs ~2 ms
// more than k=1; the distance rows hold one block per SM at N=3000, which
// leaves little to hide latency with. Tensor-core Grams come later.
//
// Design: one block holds ROWS query rows and their full distance rows in
// shared memory (ROWS*N*4 bytes), so the B x N x N matrix never reaches
// device memory. Squared norms come from a small first kernel. The block
// walks the columns in tiles of TJ points of g staged in shared memory as
// f32 (channels zero-padded to a multiple of 4, row stride = 4 mod 32 floats
// so float4 loads are conflict-free); each thread owns one column of the
// tile against all ROWS query rows, so one float4 load of the column feeds
// ROWS FMA chains (the query rows' float4 loads are warp broadcasts). The
// next tile's loads are issued before the current tile is computed.
// Channels are summed in order 0..Cg-1 in every chain.
// Selection (select.cuh): the distance rows are stored as int32 keys (NaN
// after +inf, as in the plain version). One warp per row. Each lane keeps
// the minimum of its strided subset of columns; a round is a warp shuffle argmin over the 32 lane
// minima, after which only the lane that owned the winner rescans its
// subset - k rounds cost k shuffles plus k rescans of N/32 entries.
// The y1 pass gives each lane the channels lane, lane+32, ... of its row,
// so gathers of v rows and y1 stores are coalesced, and the running
// max/min and moment sums stay in registers. Moments reduce per block in
// shared memory, then atomically into mom: the summation order is not
// fixed, which the tests' tolerance states.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int ROWS = 8;                   // query rows per block (one warp each)
constexpr int THREADS = 32 * ROWS;
constexpr int TJ = THREADS;               // columns per staged tile (one each)
constexpr int FAST_PAD = 0x7F000000;      // packed columns >= n_valid

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |g_p|^2 in f32, channels summed in order (one thread per point).
__global__ void sqnorm_kernel(const __nv_bfloat16* __restrict__ g, int points,
                              int Cg, float* __restrict__ norms) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= points) return;
  float s = 0.f;
  for (int c = 0; c < Cg; ++c) {
    const float x = __bfloat162float(g[(size_t)p * Cg + c]);
    s = __fadd_rn(s, __fmul_rn(x, x));
  }
  norms[p] = s;
}

// Stage points [p0, p0 + count) of g (row length Cg) as f32 rows of
// `stride` floats, zero-padded past Cg and past the last point. Flat
// element order, so a thread's loads are independent of each other.
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ gb,
                                           int p0, int count, int n, int Cg,
                                           int stride, float* dst) {
  for (int e = threadIdx.x; e < count * stride; e += THREADS) {
    const int r = e / stride, c = e - r * stride;
    const int p = p0 + r;
    dst[e] = (p < n && c < Cg) ? __bfloat162float(gb[(size_t)p * Cg + c]) : 0.f;
  }
}

// The column tile as 16-byte chunks (8 bf16) held in registers, so the next
// tile's loads are in flight while the current tile is computed. Used when
// Cg % 8 == 0 and a tile fits MAXQ chunks per thread (Cg <= 128).
constexpr int MAXQ = 8;

struct TileChunks {
  uint4 q[MAXQ];
};

__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ gb,
                                          int j0, int n, int Cg, int nq,
                                          TileChunks& t) {
  const int cpr = Cg / 8;  // chunks per point
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    if (i < nq) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / cpr, cc = e - r * cpr;
      const int p = j0 + r;
      t.q[i] = (r < TJ && p < n)
          ? *reinterpret_cast<const uint4*>(gb + (size_t)p * Cg + cc * 8)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void store_tile(const TileChunks& t, int Cg, int nq,
                                           int stride, float* dst) {
  const int cpr = Cg / 8;
#pragma unroll
  for (int i = 0; i < MAXQ; ++i) {
    if (i < nq) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / cpr, cc = e - r * cpr;
      if (r < TJ) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t.q[i]);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
        float4* out = reinterpret_cast<float4*>(dst + r * stride + cc * 8);
        out[0] = make_float4(a.x, a.y, b.x, b.y);
        out[1] = make_float4(c.x, c.y, d.x, d.y);
      }
    }
  }
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS) knn_edge_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ norms,
    int N, int Cg, int stride, int C, int k, int n_valid, int idx_mask,
    int32_t* __restrict__ idx_out, __nv_bfloat16* __restrict__ y_out,
    float* __restrict__ mom, __nv_bfloat16* __restrict__ ymax_out,
    int32_t* __restrict__ amax_out, __nv_bfloat16* __restrict__ ymin_out,
    int32_t* __restrict__ amin_out, float* __restrict__ sqd_out) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* gs = reinterpret_cast<float*>(smem4);  // [TJ][stride] column tile
  float* gr = gs + TJ * stride;                 // [ROWS][stride] query rows
  int* dist = reinterpret_cast<int*>(gr + ROWS * stride);  // [ROWS][N] keys
  float* msum = reinterpret_cast<float*>(dist + (size_t)ROWS * N);  // [2][C] moments
  int* sel = reinterpret_cast<int*>(msum + 2 * C);  // [ROWS][k]

  const __nv_bfloat16* gb = g + (size_t)b * N * Cg;
  const float* nb = norms + (size_t)b * N;
  stage_rows(gb, row0, ROWS, N, Cg, stride, gr);
  for (int t = threadIdx.x; t < 2 * C; t += THREADS) msum[t] = 0.f;

  // ---- distance rows (the B x N x N matrix stays in shared memory) ----
  const int jj = threadIdx.x;  // this thread's tile column, against all rows
  float rn[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) rn[q] = row0 + q < N ? nb[row0 + q] : 0.f;
  const int quads = stride / 4 - 1;  // float4 groups holding the channels
  const int nq = (TJ * (Cg / 8) + THREADS - 1) / THREADS;
  const bool chunked = Cg % 8 == 0 && nq <= MAXQ;
  TileChunks next;
  if (chunked) {
    // the padding channels [Cg, stride) of the tile stay zero throughout
    for (int e = threadIdx.x; e < TJ * (stride - Cg); e += THREADS) {
      const int r = e / (stride - Cg);
      gs[r * stride + Cg + (e - r * (stride - Cg))] = 0.f;
    }
    load_tile(gb, 0, N, Cg, nq, next);
  }
  for (int j0 = 0; j0 < N; j0 += TJ) {
    __syncthreads();  // the previous tile is consumed (and gr is staged)
    if (chunked) {
      store_tile(next, Cg, nq, stride, gs);
    } else {
      stage_rows(gb, j0, TJ, N, Cg, stride, gs);
    }
    __syncthreads();
    if (chunked && j0 + TJ < N) load_tile(gb, j0 + TJ, N, Cg, nq, next);
    const int j = j0 + jj;
    if (j >= N) continue;
    const float4* col = reinterpret_cast<const float4*>(gs + jj * stride);
    const float4* rows = reinterpret_cast<const float4*>(gr);
    float acc[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) acc[q] = 0.f;
    for (int c4 = 0; c4 < quads; ++c4) {
      const float4 cv = col[c4];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const float4 rv = rows[q * (stride / 4) + c4];
        acc[q] = fmaf(rv.x, cv.x, acc[q]);  // bf16 products are exact in f32
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
      int* slot = dist + (size_t)q * N + j;
      if (FAST) {
        *slot = j < n_valid ? fast_key(d, j, idx_mask) : (FAST_PAD | j);
      } else {
        *slot = order_key(j < n_valid ? d : INFINITY);
      }
    }
  }
  __syncthreads();

  // ---- k selection rounds, one warp per row ----
  const int row = row0 + warp;
  if (row < N) {
    int* drow = dist + (size_t)warp * N;
    int lk, lc;
    lane_min(drow, N, lane, lk, lc);
    const size_t ko = ((size_t)b * N + row) * k;
    for (int round = 0; round < k; ++round) {
      int bk = lk, bc = lc;
      warp_min<FAST>(bk, bc);
      if (lane == 0) {
        sel[warp * k + round] = bc;
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
    __syncwarp();

    // ---- y1 = bf16(v[idx] + u), k-extrema, moments ----
    const bool valid = row < n_valid;
    const size_t urow = ((size_t)b * N + row) * C;
    for (int c = lane; c < C; c += 32) {
      const float uu = __bfloat162float(u[urow + c]);
      float mx = 0.f, mn = 0.f, s1 = 0.f, s2 = 0.f;
      int ax = 0, an = 0;
      for (int j = 0; j < k; ++j) {
        const int nbr = sel[warp * k + j];
        const float y = valid
            ? bf16_round(__fadd_rn(
                  __bfloat162float(v[((size_t)b * N + nbr) * C + c]), uu))
            : 0.f;  // rows past n_valid: zeros, as the reference writes them
        y_out[(ko + j) * C + c] = __float2bfloat16_rn(y);
        if (j == 0) {
          mx = mn = y;
        } else {
          if (y > mx) { mx = y; ax = j; }
          if (y < mn) { mn = y; an = j; }
        }
        s1 = __fadd_rn(s1, y);
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      }
      if (ymax_out != nullptr) {
        ymax_out[urow + c] = __float2bfloat16_rn(mx);
        amax_out[urow + c] = ax;
        ymin_out[urow + c] = __float2bfloat16_rn(mn);
        amin_out[urow + c] = an;
      }
      if (valid) {
        atomicAdd(&msum[c], s1);
        atomicAdd(&msum[C + c], s2);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * C; t += THREADS) {
    atomicAdd(&mom[t], msum[t]);
  }
}

template <bool FAST>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s,
                   const __nv_bfloat16* g, const __nv_bfloat16* v,
                   const __nv_bfloat16* u, const float* norms, int N, int Cg,
                   int stride, int C, int k, int n_valid, int idx_mask,
                   void* idx, void* y, void* mom, void* ymax, void* amax,
                   void* ymin, void* amin, void* sqd) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_edge_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  knn_edge_kernel<FAST><<<grid, THREADS, smem, s>>>(
      g, v, u, norms, N, Cg, stride, C, k, n_valid, idx_mask, (int32_t*)idx,
      (__nv_bfloat16*)y, (float*)mom, (__nv_bfloat16*)ymax, (int32_t*)amax,
      (__nv_bfloat16*)ymin, (int32_t*)amin, (float*)sqd);
  return cudaGetLastError();
}

}  // namespace

// g [B,N,Cg], v/u [B,N,C] bf16; norms: [B,N] f32 scratch. Outputs as in
// the header; ymax/amax/ymin/amin and sqd may be null. Returns a
// cudaError_t (cudaErrorInvalidValue when the shape exceeds shared memory).
extern "C" int knn_edge_launch(const void* g, const void* v, const void* u,
                               int B, int N, int Cg, int C, int k, int fast,
                               int n_valid, int idx_bits, void* norms,
                               void* idx, void* y, void* mom, void* ymax,
                               void* amax, void* ymin, void* amin, void* sqd,
                               void* stream) {
  const int stride = (Cg + 3) / 4 * 4 + 4;  // = 4 mod 32 when Cg % 32 == 0
  const size_t smem = 4 * ((size_t)TJ * stride + (size_t)ROWS * stride +
                           (size_t)ROWS * N + 2 * (size_t)C + (size_t)ROWS * k);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int points = B * N;
  sqnorm_kernel<<<(points + 255) / 256, 256, 0, s>>>(
      (const __nv_bfloat16*)g, points, Cg, (float*)norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const int idx_mask = (1 << idx_bits) - 1;
  err = fast ? launch<true>(grid, smem, s, (const __nv_bfloat16*)g,
                            (const __nv_bfloat16*)v, (const __nv_bfloat16*)u,
                            (const float*)norms, N, Cg, stride, C, k, n_valid,
                            idx_mask, idx, y, mom, ymax, amax, ymin, amin, sqd)
             : launch<false>(grid, smem, s, (const __nv_bfloat16*)g,
                             (const __nv_bfloat16*)v, (const __nv_bfloat16*)u,
                             (const float*)norms, N, Cg, stride, C, k, n_valid,
                             idx_mask, idx, y, mom, ymax, amax, ymin, amin, sqd);
  return (int)err;
}
