// Kernels B10 and B17: out = exp(-max(|f_i|^2 - 2 f_i.f_j + |f_j|^2, 0)) @ u
// over all points j of the same sample, the Gaussian-affinity matvec of the
// matrix-free label propagation, with whole tile pairs skipped by a mask.
//
// Replaces weaksuppointcloudseg_tpu/ops/affinity_pallas.py::
// affinity_matvec_pallas_t (B10, body _kernel_t: feat [B,F,N], u and out
// [B,K,N]) and affinity_matvec_pallas (B17, body _kernel: feat [B,N,F], u
// and out [B,N,K]). The Pallas kernels walk a (row tile, column tile) grid
// in order, keep out in VMEM across the column axis and run the Gram and the
// apply as f32 HIGHEST MXU products; N is padded to the tile with points at
// 1e6 because Mosaic needs whole tiles. Here the layout is a template
// parameter of one kernel, and N is any size.
//
// What bounds it on an H100: the f32 operations. Per surviving ordered pair
// (i, j): the F-long dot (F <= 6 FMAs), two adds for the distance, one
// expf and K FMAs for the apply (K=13 in the CG, 1 for the degrees), all on
// the FP32 pipes: no tensor cores, because exp(-1e3 d^2) amplifies Gram
// error about a thousandfold (ROADMAP C1) and TF32 keeps about three
// digits. With every pair computed, one matvec of a 131,072-point room is
// ~8.7 ms at the 67 TFLOP/s FP32 peak; the skip mask (computed beside the
// kernel from tile bounding boxes, ops/affinity.py) keeps ~4% of the pairs
// of a surface-sampled room.
//
// Design: one block of 128 threads owns a 128-row tile, one row per
// thread: its features, norm and K sums stay in registers. The block walks
// the column tiles that its row of the mask keeps, in ascending order, and
// stages each tile's features and u in shared memory as float4 records
// that every thread reads at the same address (broadcast). 128-point
// tiles keep tight bounding boxes (256-point tiles keep about twice the
// pairs), and four warps per block share the staging of each tile. No
// atomics: a block writes its rows once, so every sum has one order. The
// row and column norms come from the same FMA chain, so a point's distance
// to itself is exactly 0. expf (not __expf): its error is 2 ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // threads of a block = rows = columns of a stage
constexpr int FMAX = 6;    // features
constexpr int FS = 8;      // a column's feature record in shared memory

__device__ __forceinline__ float dot6(const float (&x)[FMAX], float4 a,
                                      float2 b) {
  float s = x[0] * a.x;
  s = fmaf(x[1], a.y, s);
  s = fmaf(x[2], a.z, s);
  s = fmaf(x[3], a.w, s);
  s = fmaf(x[4], b.x, s);
  return fmaf(x[5], b.y, s);
}

// KN: feat [B,F,N], u and out [B,K,N] (B10); else feat [B,N,F], u and out
// [B,N,K] (B17). mask [B,nt,nt] uint8: 0 skips the (row tile, column tile).
template <int K, bool KN>
__global__ void __launch_bounds__(TILE) affinity_kernel(
    const float* __restrict__ feat, const float* __restrict__ u,
    const uint8_t* __restrict__ mask, int N, int F, int nt,
    float* __restrict__ out) {
  constexpr int KP = (K + 3) / 4 * 4;
  __shared__ float4 s_f[TILE][FS / 4];
  __shared__ float4 s_u[TILE][KP / 4];
  __shared__ float s_sq[TILE];

  const int b = blockIdx.y, it = blockIdx.x, tid = threadIdx.x;
  const float* fb = feat + (size_t)b * N * F;
  const float* ub = u + (size_t)b * N * K;
  float* ob = out + (size_t)b * N * K;
  auto fat = [&](int p, int c) {
    return KN ? (size_t)c * N + p : (size_t)p * F + c;
  };
  auto uat = [&](int p, int k) {
    return KN ? (size_t)k * N + p : (size_t)p * K + k;
  };

  const int row = it * TILE + tid;
  float rf[FMAX], acc[K];
#pragma unroll
  for (int c = 0; c < FMAX; ++c) {
    rf[c] = (row < N && c < F) ? fb[fat(row, c)] : 0.f;
  }
  const float rsq = dot6(rf, make_float4(rf[0], rf[1], rf[2], rf[3]),
                         make_float2(rf[4], rf[5]));
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;

  float* sf = reinterpret_cast<float*>(s_f);
  float* su = reinterpret_cast<float*>(s_u);
  const uint8_t* mrow = mask + ((size_t)b * nt + it) * nt;
  for (int jt = 0; jt < nt; ++jt) {
    if (!mrow[jt]) continue;  // the same for the whole block
    const int c0 = jt * TILE;
    const int nc = min(TILE, N - c0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < TILE * FMAX; e += TILE) {
      const int j = KN ? e % TILE : e / FMAX, c = KN ? e / TILE : e % FMAX;
      sf[j * FS + c] = (j < nc && c < F) ? fb[fat(c0 + j, c)] : 0.f;
    }
    for (int e = tid; e < TILE * KP; e += TILE) {
      const int j = KN ? e % TILE : e / KP, k = KN ? e / TILE : e % KP;
      su[j * KP + k] = (j < nc && k < K) ? ub[uat(c0 + j, k)] : 0.f;
    }
    __syncthreads();
    {
      float x[FMAX];
#pragma unroll
      for (int c = 0; c < FMAX; ++c) x[c] = sf[tid * FS + c];
      s_sq[tid] = dot6(x, s_f[tid][0],
                       *reinterpret_cast<const float2*>(&s_f[tid][1]));
    }
    __syncthreads();
    for (int j = 0; j < nc; ++j) {
      const float d = fmaf(
          -2.f,
          dot6(rf, s_f[j][0], *reinterpret_cast<const float2*>(&s_f[j][1])),
          rsq + s_sq[j]);
      const float w = expf(-(d < 0.f ? 0.f : d));  // NaN stays NaN
#pragma unroll
      for (int q = 0; q < KP / 4; ++q) {
        const float4 uv = s_u[j][q];
        const float uq[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * q + i < K) acc[4 * q + i] = fmaf(w, uq[i], acc[4 * q + i]);
        }
      }
    }
  }

  if (row < N) {
#pragma unroll
    for (int k = 0; k < K; ++k) ob[uat(row, k)] = acc[k];
  }
}

template <bool KN>
cudaError_t launch(const float* feat, const float* u, const uint8_t* mask,
                   int B, int N, int F, int K, float* out, cudaStream_t st) {
  const int nt = (N + TILE - 1) / TILE;
  const dim3 grid(nt, B);
  switch (K) {
#define AFFINITY_CASE(k)                                                  \
  case k:                                                                 \
    affinity_kernel<k, KN><<<grid, TILE, 0, st>>>(feat, u, mask, N, F,    \
                                                  nt, out);               \
    break;
    AFFINITY_CASE(1) AFFINITY_CASE(2) AFFINITY_CASE(3) AFFINITY_CASE(4)
    AFFINITY_CASE(5) AFFINITY_CASE(6) AFFINITY_CASE(7) AFFINITY_CASE(8)
    AFFINITY_CASE(9) AFFINITY_CASE(10) AFFINITY_CASE(11) AFFINITY_CASE(12)
    AFFINITY_CASE(13) AFFINITY_CASE(14) AFFINITY_CASE(15) AFFINITY_CASE(16)
#undef AFFINITY_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// kn=1: feat [B,F,N], u and out [B,K,N]; kn=0: feat [B,N,F], u and out
// [B,N,K]; f32, contiguous. mask [B,nt,nt] uint8 with nt = ceil(N / 128).
// 1 <= F <= 6, 1 <= K <= 16. Returns a cudaError_t.
extern "C" int affinity_matvec_launch(const void* feat, const void* u,
                                      const void* mask, int B, int N, int F,
                                      int K, int kn, void* out, void* stream) {
  if (F < 1 || F > FMAX || K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  const auto* f = (const float*)feat;
  const auto* uu = (const float*)u;
  const auto* m = (const uint8_t*)mask;
  return (int)(kn ? launch<true>(f, uu, m, B, N, F, K, (float*)out, st)
                  : launch<false>(f, uu, m, B, N, F, K, (float*)out, st));
}
