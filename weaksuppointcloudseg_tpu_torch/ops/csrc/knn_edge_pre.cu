// Kernel B11: the first EdgeConv conv on a GIVEN kNN graph (static-graph
// mode's reusing stages): kernel B1's epilogue with the neighbours read from
// idx instead of selected.
//
// Replaces weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::_knn_edge_pre_impl
// (body _kernel_edge_pre). For every point i of every cloud b it writes
//   y1[b,i,j,:]  = bf16(f32(v[b,idx[b,i,j],:]) + f32(u[b,i,:])),
//   mom[0/1,:]  = sum / sum of squares of y1 over rows i < n_valid,
// zero y1 on rows i >= n_valid, and optionally (with_minmax) the
// per-channel max/min of y1 over j with the first winning slot. The add
// and the single rounding are B1's (knn_edge.cu), so given B1's own idx
// the outputs are B1's bit for bit; the moments sum in a fixed order
// (det_sum.cuh), the same bit for bit from launch to launch.
//
// What bounds it on an H100: bytes. At the ShapeNet training shape (B=64,
// N=2048, k=20, C=64) it must write y1 (336 MB of bf16) and read idx,
// v and u once (~44 MB): ~0.113 ms at 3.35 TB/s; the arithmetic is one add
// and two FMAs per y1 element. The v rows it gathers are re-read k times
// on average, from L2 (a cloud's v is 256 KB).
//
// Design (a simple kernel first): one warp per row, ROWS_PER_BLOCK rows per
// block walked by its WARPS warps in turn. A warp stages its row's k
// indices in shared memory (checking each lies in [0, N): an index outside
// stops the kernel with a trap, never a clamp), then each lane owns V
// adjacent channels (V=2 when C is even: bf16x2 loads of v and u and
// stores of y1, so a warp stores 128 contiguous bytes per slot) and walks
// the k slots in order, keeping the running extrema and the moment sums in
// registers. Moments: each warp adds its rows' sums, in row order, into its
// own shared slot; the block adds the slots in warp order into a workspace
// indexed by block, and a second launch adds the blocks in index order
// (det_sum.cuh; no float atomics). Staging v in shared memory and TMA
// stores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "det_sum.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_BLOCK = 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (V == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* x) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS) knn_edge_pre_kernel(
    const int32_t* __restrict__ idx, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ u, int N, int C, int k, int n_valid,
    __nv_bfloat16* __restrict__ y_out, float* __restrict__ part,
    __nv_bfloat16* __restrict__ ymax_out, int32_t* __restrict__ amax_out,
    __nv_bfloat16* __restrict__ ymin_out, int32_t* __restrict__ amin_out) {
  extern __shared__ float smem[];
  float* wsum = smem;                                      // [WARPS][2C]
  int* sel = reinterpret_cast<int*>(wsum + WARPS * 2 * C);  // [WARPS][k]
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x; t < WARPS * 2 * C; t += THREADS) wsum[t] = 0.f;
  __syncthreads();

  int* wsel = sel + warp * k;
  const int row_end = min(N, (blockIdx.x + 1) * ROWS_PER_BLOCK);
  for (int row = blockIdx.x * ROWS_PER_BLOCK + warp; row < row_end;
       row += WARPS) {
    const size_t ko = ((size_t)b * N + row) * k;
    __syncwarp();  // the previous row's indices are consumed
    for (int j = lane; j < k; j += 32) {
      const int nbr = idx[ko + j];
      if (nbr < 0 || nbr >= N) __trap();  // out of range: stop, never clamp
      wsel[j] = nbr;
    }
    __syncwarp();

    const bool valid = row < n_valid;
    const size_t urow = ((size_t)b * N + row) * C;
    for (int c = lane * V; c < C; c += 32 * V) {
      float uu[V], mx[V], mn[V], s1[V], s2[V];
      int ax[V], an[V];
      load_vec<V>(u + urow + c, uu);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        mx[q] = mn[q] = s1[q] = s2[q] = 0.f;
        ax[q] = an[q] = 0;
      }
      for (int j = 0; j < k; ++j) {
        float vv[V], y[V];
        load_vec<V>(v + ((size_t)b * N + wsel[j]) * C + c, vv);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          // rows past n_valid: zeros, as B1 and the reference write them
          y[q] = valid ? bf16_round(__fadd_rn(vv[q], uu[q])) : 0.f;
          if (j == 0) {
            mx[q] = mn[q] = y[q];
          } else {
            if (y[q] > mx[q]) { mx[q] = y[q]; ax[q] = j; }
            if (y[q] < mn[q]) { mn[q] = y[q]; an[q] = j; }
          }
          s1[q] = __fadd_rn(s1[q], y[q]);
          s2[q] = __fadd_rn(s2[q], __fmul_rn(y[q], y[q]));
        }
        store_vec<V>(y_out + (ko + j) * C + c, y);
      }
      if (ymax_out != nullptr) {
        store_vec<V>(ymax_out + urow + c, mx);
        store_vec<V>(ymin_out + urow + c, mn);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          amax_out[urow + c + q] = ax[q];
          amin_out[urow + c + q] = an[q];
        }
      }
      if (valid) {  // this lane alone owns channels c.. of the warp's slot
        float* ws = wsum + warp * 2 * C;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          ws[c + q] = __fadd_rn(ws[c + q], s1[q]);
          ws[C + c + q] = __fadd_rn(ws[C + c + q], s2[q]);
        }
      }
    }
  }
  __syncthreads();
  // the block's partial: warps in order, into part[element][block]
  const int nblk = gridDim.x * gridDim.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  for (int t = threadIdx.x; t < 2 * C; t += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, wsum[w * 2 * C + t]);
    part[(size_t)t * nblk + blk] = s;
  }
}

}  // namespace

// idx int32 [B,N,k]; v/u bf16 [B,N,C]; y bf16 [B,N,k,C]; mom f32 [2,C]
// (written whole); ymax/amax/ymin/amin [B,N,C] or all null; part: f32
// scratch of part_elems >= 2C * B * ceil(N / 32) floats. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the launch cannot take).
extern "C" int knn_edge_pre_launch(const void* idx, const void* v,
                                   const void* u, int B, int N, int C, int k,
                                   int n_valid, void* y, void* mom, void* ymax,
                                   void* amax, void* ymin, void* amin,
                                   void* part, long long part_elems,
                                   void* stream) {
  const size_t smem = 4 * ((size_t)WARPS * 2 * C + (size_t)WARPS * k);
  const int nblk = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK * B;
  if (B < 1 || B > 65535 || N < 1 || C < 1 || k < 1 || smem > 48 * 1024 ||
      part_elems < 2LL * C * nblk) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, B);
  if (C % 2 == 0) {
    knn_edge_pre_kernel<2><<<grid, THREADS, smem, s>>>(
        (const int32_t*)idx, (const __nv_bfloat16*)v, (const __nv_bfloat16*)u,
        N, C, k, n_valid, (__nv_bfloat16*)y, (float*)part,
        (__nv_bfloat16*)ymax, (int32_t*)amax, (__nv_bfloat16*)ymin,
        (int32_t*)amin);
  } else {
    knn_edge_pre_kernel<1><<<grid, THREADS, smem, s>>>(
        (const int32_t*)idx, (const __nv_bfloat16*)v, (const __nv_bfloat16*)u,
        N, C, k, n_valid, (__nv_bfloat16*)y, (float*)part,
        (__nv_bfloat16*)ymax, (int32_t*)amax, (__nv_bfloat16*)ymin,
        (int32_t*)amin);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_cols((const float*)part, nblk, 2 * C, (float*)mom, s);
}
