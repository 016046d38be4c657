// Kernel B1: fused kNN selection + first EdgeConv conv (y1 = v[idx] + u).
//
// Replaces weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::_knn_edge_impl
// (body _kernel_edge). For every point i of every cloud b it computes the
// squared distances from g[b,i] to all g[b,j] (bf16 values, f32 products and
// sums, f32 norms: d = (-2 g_i.g_j + |g_i|^2) + |g_j|^2), selects the k
// nearest (exact: value then lowest index, the order of lax.top_k; fast: the
// packed int32 "distance bits | column"), and writes
//   idx[b,i,j]   the selected columns, nearest first,
//   y1[b,i,j,:]  = bf16(f32(v[b,idx_j,:]) + f32(u[b,i,:])),
//   mom[0/1,:]   = sum / sum of squares of y1 over rows i < n_valid,
// and optionally the per-channel max/min of y1 over j with the first
// winning slot (with_minmax) and the selected distances (with_values).
// Columns at or past n_valid are never selected before a valid one; rows
// past it hold zeros (and zero extrema at slot 0).
//
// What bounds it on an H100: f32 FMAs. At the serving shape (B=32,
// N=3000, k=20, Cg=C=64) the distance pass is B*N*N*Cg = 1.8e10 f32 FMAs
// on the CUDA cores (0.55 ms at the 67 TFLOP/s f32 peak; tensor cores
// would change the bits the graph is held to); the y1 write is 246 MB of
// bf16 (0.073 ms at 3.35 TB/s), and v's rows are gathered from L2.
//
// Design. The distance pass and the selection are knn_tiles.cuh's
// (B12 and B15 share them): a block of 4 warps owns 128 query rows, each
// thread an 8 x 4 register micro-tile of dot products, the column tiles
// double-buffered with cp.async, channels past 64 walked in chunks, and a
// streaming top-k whose one-compare filter drops nearly every pair. Its
// shared memory does not grow with N (89.5 KB at Cg=64, k=20: two blocks
// an SM; 41.5 KB at Cg=3). The tiles read f32 points: the first kernel
// (sqnorm_kernel) widens g exactly into an f32 copy whose rows are padded
// with zeros to ceil4(Cg) channels and sums each point's squares in
// channel order, the chain every kNN kernel of the port uses, so B1, B12
// and B15 select the same graph bit for bit. knn_edge_kernel is the
// tiles' body with B1's epilogue.
//
// Epilogue: a warp writes idx (and sqd) for each of its rows as the row's
// list is sorted, and y1, the extrema and the moments for 8 rows at once,
// at the group's last row: each lane owns a pair of channels (one where C
// is odd), gathers the group's v rows in batches of JB neighbours so the
// loads overlap, and keeps the running max/min and sums in registers.
// Moments sum in a fixed order (det_sum.cuh): each row sums its k values
// in slot order, each group of 8 consecutive rows adds its rows in order
// (rows past N as zeros) into part[element][b * ceil(N/8) + row / 8], and
// a second launch adds those partials in index order. No float atomics:
// the moments are the same bit for bit from launch to launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "det_sum.cuh"
#include "knn_tiles.cuh"

namespace {

constexpr int GROUP = 8;  // rows of one moment partial
constexpr int JB = 8;     // neighbour rows of v in flight per lane

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |g_p|^2 in f32, channels summed in order, and g_p widened to f32 into
// x32's row of cpad floats (channels past Cg zero). One thread per point.
__global__ void sqnorm_kernel(const __nv_bfloat16* __restrict__ g, int points,
                              int Cg, int cpad, float* __restrict__ norms,
                              float* __restrict__ x32) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= points) return;
  const __nv_bfloat16* src = g + (size_t)p * Cg;
  float4* dst = reinterpret_cast<float4*>(x32 + (size_t)p * cpad);
  float s = 0.f;
  for (int c4 = 0; c4 < cpad / 4; ++c4) {
    float e[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = 4 * c4 + t;
      e[t] = c < Cg ? __bfloat162float(src[c]) : 0.f;
      if (c < Cg) s = __fadd_rn(s, __fmul_rn(e[t], e[t]));
    }
    dst[c4] = make_float4(e[0], e[1], e[2], e[3]);
  }
  norms[p] = s;
}

// W consecutive bf16 channels (W = 2: one aligned 4-byte access).
template <int W>
using Raw = std::conditional_t<W == 2, __nv_bfloat162, __nv_bfloat16>;

template <int W>
__device__ __forceinline__ void widen(Raw<W> h, float* f) {
  if constexpr (W == 2) {
    const float2 t = __bfloat1622float2(h);
    f[0] = t.x;
    f[1] = t.y;
  } else {
    f[0] = __bfloat162float(h);
  }
}

template <int W>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* f) {
  if constexpr (W == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  } else {
    *p = __float2bfloat16_rn(f[0]);
  }
}

struct EdgeTileOut {
  const __nv_bfloat16* v;  // [B, N, C]
  const __nv_bfloat16* u;  // [B, N, C]
  int N, C, k, n_valid;
  int groups;              // ceil(N / GROUP): a cloud's moment partials
  int nblk;                // B * groups: partials per element
  bool pairs;              // lanes own channel pairs (C even, aligned)
  int32_t* idx;            // [B, N, k]
  __nv_bfloat16* y;        // [B, N, k, C]
  float* part;             // [2C][nblk]
  __nv_bfloat16* ymax;     // [B, N, C] or null (then all four are)
  int32_t* amax;
  __nv_bfloat16* ymin;
  int32_t* amin;
  float* sqd;              // [B, N, k] or null

  // y1, the extrema and the moment partial of rows r0..r1 (one group, r1
  // its last row below N), from their sorted lists (list0: row r0's).
  template <int W>
  __device__ void group_out(int b, int r0, int r1, int lane,
                            const uint64_t* list0) const {
    const int ls = tile_list_stride(k);
    const size_t cloud = (size_t)b * N;
    const int slot = b * groups + r0 / GROUP;
    for (int c = W * lane; c < C; c += 32 * W) {
      float p1[W], p2[W];
#pragma unroll
      for (int w = 0; w < W; ++w) p1[w] = p2[w] = 0.f;
      for (int r = r0; r <= r1; ++r) {
        const size_t urow = (cloud + r) * C + c;
        __nv_bfloat16* yrow = y + (cloud + r) * k * C + c;
        float mx[W], mn[W], s1[W], s2[W];
        int ax[W], an[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          mx[w] = mn[w] = s1[w] = s2[w] = 0.f;
          ax[w] = an[w] = 0;
        }
        if (r < n_valid) {
          const uint64_t* l = list0 + (r - r0) * ls;
          float uu[W];
          widen<W>(*reinterpret_cast<const Raw<W>*>(u + urow), uu);
          for (int j0 = 0; j0 < k; j0 += JB) {
            Raw<W> vr[JB];
#pragma unroll
            for (int t = 0; t < JB; ++t) {
              if (j0 + t < k) {
                vr[t] = *reinterpret_cast<const Raw<W>*>(
                    v + (cloud + entry_col(l[j0 + t])) * C + c);
              }
            }
#pragma unroll
            for (int t = 0; t < JB; ++t) {
              const int j = j0 + t;
              if (j < k) {
                float yv[W];
                widen<W>(vr[t], yv);
#pragma unroll
                for (int w = 0; w < W; ++w) {
                  yv[w] = bf16_round(__fadd_rn(yv[w], uu[w]));
                  if (j == 0) {
                    mx[w] = mn[w] = yv[w];
                  } else {
                    if (yv[w] > mx[w]) { mx[w] = yv[w]; ax[w] = j; }
                    if (yv[w] < mn[w]) { mn[w] = yv[w]; an[w] = j; }
                  }
                  s1[w] = __fadd_rn(s1[w], yv[w]);
                  s2[w] = __fadd_rn(s2[w], __fmul_rn(yv[w], yv[w]));
                }
                store_bf16<W>(yrow + (size_t)j * C, yv);
              }
            }
          }
        } else {  // rows past n_valid: zeros, as the reference writes them
          for (int j = 0; j < k; ++j) store_bf16<W>(yrow + (size_t)j * C, mx);
        }
        if (ymax != nullptr) {
          store_bf16<W>(ymax + urow, mx);
          store_bf16<W>(ymin + urow, mn);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            amax[urow + w] = ax[w];
            amin[urow + w] = an[w];
          }
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          p1[w] = __fadd_rn(p1[w], s1[w]);
          p2[w] = __fadd_rn(p2[w], s2[w]);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (r1 - r0 < GROUP - 1) {  // the group's rows past N add zeros
          p1[w] = __fadd_rn(p1[w], 0.f);
          p2[w] = __fadd_rn(p2[w], 0.f);
        }
        part[(size_t)(c + w) * nblk + slot] = p1[w];
        part[(size_t)(C + c + w) * nblk + slot] = p2[w];
      }
    }
  }

  template <bool FAST>
  __device__ void finish(int b, int row, int lane, const uint64_t* list,
                         int idx_mask) const {
    const size_t o = ((size_t)b * N + row) * k;
    for (int s = lane; s < k; s += 32) {
      const uint64_t e = list[s];
      idx[o + s] = entry_col(e);
      if (sqd != nullptr) sqd[o + s] = entry_value<FAST>(e, idx_mask);
    }
    if (row % GROUP != GROUP - 1 && row != N - 1) return;
    const int r0 = row - row % GROUP;
    const uint64_t* list0 = list - (size_t)(row - r0) * tile_list_stride(k);
    if (pairs) {
      group_out<2>(b, r0, row, lane, list0);
    } else {
      group_out<1>(b, r0, row, lane, list0);
    }
  }
};

template <bool FAST>
__global__ void __launch_bounds__(TT_THREADS) knn_edge_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int N, int C,
    TileGeometry geo, int k, int n_valid, int idx_mask, bool vec,
    EdgeTileOut epi) {
  knn_tiles_body<FAST>(x, norms, N, C, geo, k, n_valid, idx_mask, vec, epi);
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

}  // namespace

// g [B,N,Cg], v/u [B,N,C] bf16; norms: [B,N] f32 scratch; x32: f32
// scratch of B * N * ceil4(Cg) floats (g widened); part: f32 scratch of
// part_elems >= 2C * B * ceil(N / 8) floats (the groups' partial
// moments). Outputs as in the header (mom written whole);
// ymax/amax/ymin/amin and sqd may be null. 1 <= k <= min(64, N),
// 1 <= B <= 65535. Returns a cudaError_t (cudaErrorInvalidValue for a
// shape outside those limits or a short part).
extern "C" int knn_edge_launch(const void* g, const void* v, const void* u,
                               int B, int N, int Cg, int C, int k, int fast,
                               int n_valid, int idx_bits, void* norms,
                               void* x32, void* idx, void* y, void* mom,
                               void* ymax, void* amax, void* ymin, void* amin,
                               void* sqd, void* part, long long part_elems,
                               void* stream) {
  const int groups = (N + GROUP - 1) / GROUP;
  if (!tiles_shape_ok(B, N, Cg, k, TT_K_MAX) || C < 1 ||
      part_elems < 2LL * C * B * groups) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int points = B * N;
  const int cpad = (Cg + 3) / 4 * 4;
  sqnorm_kernel<<<(points + 255) / 256, 256, 0, s>>>(
      (const __nv_bfloat16*)g, points, Cg, cpad, (float*)norms, (float*)x32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool pairs = C % 2 == 0 && aligned4(v) && aligned4(u) &&
                     aligned4(y) && (ymax == nullptr || (aligned4(ymax) &&
                                                         aligned4(ymin)));
  const EdgeTileOut out{(const __nv_bfloat16*)v, (const __nv_bfloat16*)u,
                        N, C, k, n_valid, groups, B * groups, pairs,
                        (int32_t*)idx, (__nv_bfloat16*)y, (float*)part,
                        (__nv_bfloat16*)ymax, (int32_t*)amax,
                        (__nv_bfloat16*)ymin, (int32_t*)amin, (float*)sqd};
  const float* xf = (const float*)x32;
  err = fast ? tiles_kernel_launch(knn_edge_kernel<true>, xf, B, N, cpad, k,
                                   n_valid, idx_bits, (const float*)norms, out,
                                   s)
             : tiles_kernel_launch(knn_edge_kernel<false>, xf, B, N, cpad, k,
                                   n_valid, idx_bits, (const float*)norms, out,
                                   s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_cols((const float*)part, B * groups, 2 * C, (float*)mom, s);
}
