// Kernel B3: one-pass backward of the fused conv2 + BN2 + relu + k-max block.
//
// Replaces weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py::
// conv_kmax_bwd_pallas (_kernel_cbk_bwd). For every row (point p, slot j)
// of y1 [P, k, C1]:
//   h_j  = bf16(relu(y1_j * scale1 + shift1))   (the BN1 fold)
//   Dq_j = bf16(q[p]) * 1[asel[p] == j]        (the k-max routed gradient)
//   dh_j = (Dq_j @ W2^T + h_j @ M) + row0      (f32 sums of exact products)
//   dz_j = dh_j * 1[h_j > 0], stored as bf16
// and the reductions T_sp = sum h_j^T Dq_j [C1, C2], G = sum h_j^T h_j
// [C1, C1], S1 = sum h_j, a1 = sum dz_j and a2 = sum dz_j (y1_j - mean1)
// inv1 (the last two from the f32 dz_j, before its rounding).
//
// What bounds it on an H100: the f32 FMA work on the CUDA cores. At
// 32x2048x20 rows, C1=64, C2=128, G and h_j @ M are 1.1e10 FMAs together;
// the routed products are sparse (each (p, channel) has one slot j) and
// cost C1*C2 per point, 5.4e8 FMAs each.
//
// Design: persistent blocks (at most one per SM: the tiles take ~143 KB of
// shared memory at k=20) walk tiles of TP points. A tile's h_j are
// recomputed from y1 into shared memory once; the routed product is
// scattered into a shared dh tile by the thread that owns (point, channel),
// skipping the zeros of Dq; the dense product h_j @ M runs from register
// tiles. T_sp, G, S1 and (a1, a2) are summed into a fixed number of
// partials whatever the grid: partial v (a "virtual block", v < V =
// VPARTS, or fewer where there are fewer tiles) sums tiles v, v + V,
// v + 2V, ... in that order in registers; a physical block takes virtual
// blocks blockIdx.x, blockIdx.x + grid, ..., resets its accumulators for
// each one and writes it (a1/a2 through a fixed warp butterfly and the
// warps in order) to workspace row v. A second launch adds the rows in
// index order (det_sum.cuh). No float atomics, and the order of every sum
// depends on the shapes alone: the same bits from launch to launch, at
// any grid and on any SM count. The grid is a launch argument (the
// wrapper passes min(V, SMs, tiles)); V = 264 runs two full waves of
// virtual blocks on a 132-SM H100. The workspace holds V partial rows:
// 264 x 12,480 floats = 13.2 MB at C2=128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "det_sum.cuh"

namespace {

constexpr int C1 = 64;        // conv2 input width (the EdgeConv width)
constexpr int HS = C1 + 4;    // padded row stride of the h and dh tiles
constexpr int TP = 8;         // points per tile
constexpr int THREADS = 256;
constexpr int RPT = 4;        // rows per thread and pass of the dense product
constexpr int VPARTS = 264;   // partial rows (virtual blocks), whatever the grid

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// floats of one block's partial: T_sp [C1][C2], G [C1][C1], S1, a1, a2
__host__ __device__ constexpr int partial_width(int C2) {
  return C1 * C2 + C1 * C1 + 3 * C1;
}

// h, dh, M, W2^T, q and asel tiles, and the a1/a2 warp sums
size_t smem_bytes(int k, int C2) {
  const size_t r = (size_t)TP * k;
  return (2 * r * HS + C1 * C1 + (size_t)C2 * C1 + 2 * (size_t)TP * C2 +
          (THREADS / 32) * 2 * C1) * 4;
}

template <int C2>
__global__ void __launch_bounds__(THREADS, 1) conv_kmax_bwd_kernel(
    const __nv_bfloat16* __restrict__ y1, const float* __restrict__ q,
    const int* __restrict__ asel, const __nv_bfloat16* __restrict__ w2t,
    const __nv_bfloat16* __restrict__ m, const float* __restrict__ row0,
    const float* __restrict__ scale1, const float* __restrict__ shift1,
    const float* __restrict__ mean1, const float* __restrict__ inv1, int P,
    int k, __nv_bfloat16* __restrict__ dz, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int R = TP * k;
  float* hs = reinterpret_cast<float*>(smem4);  // [R][HS] h_j
  float* ds = hs + R * HS;                      // [R][HS] Dq_j @ W2^T
  float* ms = ds + R * HS;                      // [C1][C1] M
  float* wt = ms + C1 * C1;                     // [C2][C1] W2^T
  float* qs = wt + C2 * C1;                     // [TP][C2] bf16(q)
  int* as = reinterpret_cast<int*>(qs + TP * C2);  // [TP][C2] asel
  float* wab = reinterpret_cast<float*>(as + TP * C2);  // [THREADS/32][2][C1]
  const int t = threadIdx.x;

  for (int e = t; e < C1 * C1; e += THREADS) ms[e] = __bfloat162float(m[e]);
  for (int e = t; e < C2 * C1; e += THREADS) wt[e] = __bfloat162float(w2t[e]);

  // T_sp: thread t owns column tc and rows ti0 + TSTEP * x
  constexpr int NT = C1 * C2 / THREADS;
  constexpr int TSTEP = THREADS / C2;
  const int tc = t % C2, ti0 = t / C2;
  float tacc[NT];
  // G: a 4x4 register tile; S1 by the 16 threads of tile row 0
  const int gi = (t >> 4) * 4, gl = (t & 15) * 4;
  float gacc[4][4];
  float s1acc[4];
  // dense product and epilogue: channels ig*8..ig*8+7, rows rg + 32 x
  const int ig = t & 7, rg = t >> 3;
  float a1acc[8], a2acc[8], r0v[8], mnv[8], ivv[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = ig * 8 + u;
    r0v[u] = row0[i];
    mnv[u] = mean1[i];
    ivv[u] = inv1[i];
  }

  const int tiles = (P + TP - 1) / TP;
  const int nv = min(VPARTS, tiles);  // partial rows
  for (int vb = blockIdx.x; vb < nv; vb += gridDim.x) {
#pragma unroll
    for (int x = 0; x < NT; ++x) tacc[x] = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      s1acc[a] = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) gacc[a][b] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) a1acc[u] = a2acc[u] = 0.f;

    for (int tile = vb; tile < tiles; tile += VPARTS) {
      const int p0 = tile * TP;
      const int np = min(TP, P - p0);
      const int nr = np * k;
      const __nv_bfloat16* ysrc = y1 + (size_t)p0 * k * C1;
      __syncthreads();  // the previous tile's readers are done
      for (int e = t; e < R * C1; e += THREADS) {
        const int r = e / C1, c = e % C1;
        float hv = 0.f;
        if (r < nr) {
          hv = bf16_round(fmaxf(
              __fadd_rn(__fmul_rn(__bfloat162float(ysrc[e]), scale1[c]), shift1[c]), 0.f));
        }
        hs[r * HS + c] = hv;
        ds[r * HS + c] = 0.f;
      }
      for (int e = t; e < TP * C2; e += THREADS) {
        const bool ok = e / C2 < np;
        qs[e] = ok ? bf16_round(q[(size_t)p0 * C2 + e]) : 0.f;
        as[e] = ok ? asel[(size_t)p0 * C2 + e] : -1;
      }
      __syncthreads();

      // routed product: thread (p, i) adds bf16(q[p,c]) W2[i,c] into its own
      // dh row of slot asel[p,c], for every c
      {
        const int i = t & (C1 - 1);
        for (int p = t / C1; p < np; p += THREADS / C1) {
          float* drow = ds + p * k * HS + i;
          const float* qrow = qs + p * C2;
          const int* arow = as + p * C2;
          for (int c = 0; c < C2; ++c) {
            const int j = arow[c];
            if ((unsigned)j < (unsigned)k) drow[j * HS] += qrow[c] * wt[c * C1 + i];
          }
        }
      }
      // T_sp += h_j^T Dq_j, only the routed slot of each (p, c)
      for (int p = 0; p < np; ++p) {
        const int j = as[p * C2 + tc];
        if ((unsigned)j >= (unsigned)k) continue;
        const float qv = qs[p * C2 + tc];
        const float* hrow = hs + (p * k + j) * HS;
#pragma unroll
        for (int x = 0; x < NT; ++x) tacc[x] = fmaf(hrow[ti0 + TSTEP * x], qv, tacc[x]);
      }
      // G += h^T h, S1 += sum h: the tile's sums first, then the running
      // ones (a virtual block sums ~5,000 rows at 32 x 2048 x 20; two levels keep the f32 error near
      // 1e-6 of the magnitudes)
      {
        float gt[4][4], st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) gt[u][v] = 0.f;
        for (int r = 0; r < nr; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(hs + r * HS + gi);
          const float4 b = *reinterpret_cast<const float4*>(hs + r * HS + gl);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) gt[u][v] = fmaf(av[u], bv[v], gt[u][v]);
#pragma unroll
          for (int v = 0; v < 4; ++v) st[v] += bv[v];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) gacc[u][v] += gt[u][v];
#pragma unroll
        for (int v = 0; v < 4; ++v) s1acc[v] += st[v];
      }
      __syncthreads();  // ds complete

      // dh = (routed + h @ M) + row0; dz = relu mask; store; a1/a2
      for (int base = 0; base < nr; base += 32 * RPT) {
        float acc[RPT][8];
#pragma unroll
        for (int x = 0; x < RPT; ++x)
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[x][u] = 0.f;
        for (int l = 0; l < C1; ++l) {
          const float4 m0 = *reinterpret_cast<const float4*>(ms + l * C1 + ig * 8);
          const float4 m1 = *reinterpret_cast<const float4*>(ms + l * C1 + ig * 8 + 4);
          const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
          for (int x = 0; x < RPT; ++x) {
            const int r = base + rg + 32 * x;
            const float hv = r < nr ? hs[r * HS + l] : 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u) acc[x][u] = fmaf(hv, mv[u], acc[x][u]);
          }
        }
#pragma unroll
        for (int x = 0; x < RPT; ++x) {
          const int r = base + rg + 32 * x;
          if (r >= nr) continue;
          const size_t o = ((size_t)p0 * k + r) * C1 + ig * 8;
          unsigned packed[4];
#pragma unroll
          for (int u = 0; u < 8; u += 2) {
            float out[2];
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int i = ig * 8 + u + v;
              const float dh = __fadd_rn(__fadd_rn(ds[r * HS + i], acc[x][u + v]), r0v[u + v]);
              const float dzv = hs[r * HS + i] > 0.f ? dh : 0.f;
              const float xhat = __fmul_rn(
                  __fsub_rn(__bfloat162float(ysrc[(size_t)r * C1 + i]), mnv[u + v]),
                  ivv[u + v]);
              a1acc[u + v] += dzv;
              a2acc[u + v] += dzv * xhat;
              out[v] = dzv;
            }
            const __nv_bfloat162 pair = __floats2bfloat162_rn(out[0], out[1]);
            packed[u / 2] = *reinterpret_cast<const unsigned*>(&pair);
          }
          *reinterpret_cast<uint4*>(dz + o) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
        }
      }
    }

    // virtual block vb's partial sums, workspace row vb [T_sp | G | S1 | a1
    // | a2]; each element has one owner
    float* row = part + (size_t)vb * partial_width(C2);
#pragma unroll
    for (int x = 0; x < NT; ++x) row[(ti0 + TSTEP * x) * C2 + tc] = tacc[x];
    float* grow = row + C1 * C2;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) grow[(gi + u) * C1 + gl + v] = gacc[u][v];
    float* srow = grow + C1 * C1;  // S1, a1, a2
    if (t < 16) {
#pragma unroll
      for (int v = 0; v < 4; ++v) srow[gl + v] = s1acc[v];
    }
    // lanes ig, ig+8, ig+16, ig+24 of a warp share channels: a fixed
    // butterfly, then the warps in order
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      for (int off = 8; off < 32; off <<= 1) {
        a1acc[u] += __shfl_xor_sync(0xffffffffu, a1acc[u], off);
        a2acc[u] += __shfl_xor_sync(0xffffffffu, a2acc[u], off);
      }
    }
    const int warp = t >> 5;
    if ((t & 31) < 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        wab[warp * 2 * C1 + ig * 8 + u] = a1acc[u];
        wab[warp * 2 * C1 + C1 + ig * 8 + u] = a2acc[u];
      }
    }
    __syncthreads();
    if (t < 2 * C1) {
      float acc = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) acc = __fadd_rn(acc, wab[w * 2 * C1 + t]);
      srow[C1 + t] = acc;
    }
    // the next virtual block's first tile starts with a __syncthreads: its
    // wab writes come after these reads
  }
}

template <int C2>
int launch(const void* y1, const void* q, const void* asel, const void* w2t,
           const void* m, const void* row0, const void* scale1,
           const void* shift1, const void* mean1, const void* inv1, int P,
           int k, int grid, void* dz, void* sums, void* part,
           long long part_elems, cudaStream_t stream) {
  const size_t smem = smem_bytes(k, C2);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int tiles = (P + TP - 1) / TP;
  const int rows = tiles < VPARTS ? tiles : VPARTS;
  if ((rows > 0 && (grid < 1 || grid > rows)) ||
      part_elems < (long long)rows * partial_width(C2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv_kmax_bwd_kernel<C2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    conv_kmax_bwd_kernel<C2><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)y1, (const float*)q, (const int*)asel,
        (const __nv_bfloat16*)w2t, (const __nv_bfloat16*)m, (const float*)row0,
        (const float*)scale1, (const float*)shift1, (const float*)mean1,
        (const float*)inv1, P, k, (__nv_bfloat16*)dz, (float*)part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)sum_rows((const float*)part, rows, partial_width(C2),
                       (float*)sums, stream);
}

}  // namespace

// B3. y1 [P, k, 64] bf16 (the raw first-conv output), q [P, C2] f32, asel
// [P, C2] int32, w2t [C2, 64] bf16, m [64, 64] bf16, row0 [64] f32,
// scale1/shift1/mean1/inv1 [64] f32 (the BN1 fold). dz [P, k, 64] bf16;
// sums: f32 [64 C2 + 64 * 64 + 3 * 64], T_sp [64, C2], G [64, 64] and
// (S1, a1, a2) [3, 64] in that order, written whole; part: f32 scratch of
// part_elems >= min(264, ceil(P / 8)) rows of that width; grid: the
// persistent blocks, 1 <= grid <= those rows (the sums do not depend on
// it). C1 must be 64, C2 64 or 128.
extern "C" int conv_kmax_bwd_launch(const void* y1, const void* q,
                                    const void* asel, const void* w2t,
                                    const void* m, const void* row0,
                                    const void* scale1, const void* shift1,
                                    const void* mean1, const void* inv1, int P,
                                    int k, int c1, int c2, int grid, void* dz,
                                    void* sums, void* part,
                                    long long part_elems, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (c1 != C1 || k < 1 || !scale1 || !shift1 || !mean1 || !inv1) {
    return (int)cudaErrorInvalidValue;
  }
  if (c2 == 64) {
    return launch<64>(y1, q, asel, w2t, m, row0, scale1, shift1, mean1, inv1,
                      P, k, grid, dz, sums, part, part_elems, s);
  }
  if (c2 == 128) {
    return launch<128>(y1, q, asel, w2t, m, row0, scale1, shift1, mean1, inv1,
                       P, k, grid, dz, sums, part, part_elems, s);
  }
  return (int)cudaErrorInvalidValue;
}
