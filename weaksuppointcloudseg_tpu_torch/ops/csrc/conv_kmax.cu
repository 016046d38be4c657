// Kernels B7, B8 (eval) and B2, B5 forward (training): conv + a reduction
// of its output over the k slots or over the points.
//
// B7 conv_zmax replaces weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py::
// conv_zmax_pallas (_kernel_conv_zmax):
//   out[r,:] = bf16(relu(max_j(s2 * f32(bf16(act(h1[r,j,:]) @ W2 + b2)) + t2)))
// with act(x) = bf16(relu(x * scale1 + shift1)) when the upstream BN is
// folded in, else x.
//
// B2 conv_minmax replaces conv_kmax_pallas.py::conv_minmax_pallas
// (_kernel_conv_minmax): the same y[r,j,:] = bf16(act(h1[r,j,:]) @ W2 + b2),
// always with the BN1 fold (the only mode a preset reaches), reduced to its
// max and min over the k slots with the first winning slot (strict
// compares, j ascending), and the moments sum(y), sum(y^2) over all (r, j).
//
// B8 conv_znmax replaces conv_kmax_pallas.py::conv_znmax_pallas
// (_kernel_conv_znmax):
//   out[b,:] = relu(max_{n < n_valid}(s2 * f32(bf16(h[b,n,:] @ W + b)) + t2))
// in f32.
//
// B5 conv_nmax replaces conv_kmax_pallas.py::conv_nmax_pallas
// (_kernel_conv_nmax): y = bf16(h[b,n,:] @ W + b) reduced over the points to
// the max and min per (b, channel) with the lowest winning row, and the
// moments over all (b, n).
//
// The conv output never reaches memory in any of them. Rounding follows the
// reference: products of bf16 values are exact in f32, sums accumulate in
// f32 in channel order, the bias is added in f32, and y is rounded to bf16
// before BN, the compares and the moments. Multiplies and adds that the
// reference keeps separate are written with __fmul_rn/__fadd_rn so the
// compiler cannot contract them. The accumulation order still differs from
// XLA's, so y can land one bf16 ulp away; the tests allow that.
//
// What bounds them on an H100: f32 FMA work on the CUDA cores (B7 at
// 32x3000x20, 64->64: 7.9e9 FMAs; B2 at 32x2048x20: 5.4e9; B8/B5 at
// 192->1024: 1.9e10 / 1.3e10); B7 and B2 also read the bf16 y1 once.
//
// Two designs, each with an eval and a training epilogue:
// - k rows (B7, B2): one thread per output channel holds its W2 column in
//   registers (C1 is a template parameter); a block stages RT rows of h1
//   (k*C1 values each, BN1 fold applied once per element) in shared memory
//   and every thread reads them as float4 broadcasts, so the inner loop is
//   one shared load per four FMAs. The epilogue sees each slot's y: B7
//   keeps a running max of z, B2 the extrema, their slots and per-thread
//   moment sums, which each block writes to a workspace indexed by block.
// - N splits (B8, B5): grid (C2 tiles, N splits, B); each thread owns one
//   channel and RT rows of accumulators in registers, with the h tile
//   stored channel-major in shared memory so four rows come in one float4
//   broadcast. Each split writes its partial result and a second small
//   kernel merges the splits in ascending order: B8 takes the max and
//   applies relu (no atomics: deterministic); B5 keeps the split's lowest
//   winning row and merges with strict compares, so the lowest row wins
//   across splits too, and writes its moments to a workspace indexed by
//   split.
// The moments of B2 and B5 then sum over the blocks in an order fixed by
// the block index (det_sum.cuh): no float atomics, the same bits from
// launch to launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "det_sum.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ------------------------------------------------------------ k rows

constexpr int KROWS_PER_BLOCK = 32;

// y = bf16(act(h1[r, j, :]) @ W2[:, c2] + b2[c2]) for this thread's channel
// c2 = threadIdx.x and the block's rows; epi.slot(j, y) for every slot of a
// row, then epi.row_end(offset of (row, c2) in a [rows, C2] output).
template <int C1, class Epi>
__device__ __forceinline__ void conv_krows(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b2, const float* __restrict__ scale1,
    const float* __restrict__ shift1, int rows, int k, int C2, int rt,
    Epi& epi) {
  extern __shared__ float4 hs4[];  // [rt][k][C1] as float4
  float* hs = reinterpret_cast<float*>(hs4);
  const int c2 = threadIdx.x;
  float wr[C1];
#pragma unroll
  for (int c1 = 0; c1 < C1; ++c1) wr[c1] = __bfloat162float(w[c1 * C2 + c2]);
  const float bias = b2[c2];
  const bool fold = scale1 != nullptr;
  const int r_begin = blockIdx.x * KROWS_PER_BLOCK;
  const int r_end = min(rows, r_begin + KROWS_PER_BLOCK);
  const int row_elems = k * C1;

  for (int base = r_begin; base < r_end; base += rt) {
    const int nr = min(rt, r_end - base);
    __syncthreads();
    const __nv_bfloat16* src = h + (size_t)base * row_elems;
    for (int e = threadIdx.x; e < nr * row_elems; e += blockDim.x) {
      float x = __bfloat162float(src[e]);
      if (fold) {
        const int c1 = e % C1;
        x = bf16_round(fmaxf(__fadd_rn(__fmul_rn(x, scale1[c1]), shift1[c1]), 0.f));
      }
      hs[e] = x;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      for (int j = 0; j < k; ++j) {
        const float4* hrow = hs4 + (r * k + j) * (C1 / 4);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < C1 / 4; ++q) {
          const float4 hv = hrow[q];
          acc = fmaf(hv.x, wr[4 * q + 0], acc);
          acc = fmaf(hv.y, wr[4 * q + 1], acc);
          acc = fmaf(hv.z, wr[4 * q + 2], acc);
          acc = fmaf(hv.w, wr[4 * q + 3], acc);
        }
        epi.slot(j, bf16_round(__fadd_rn(acc, bias)));
      }
      epi.row_end((size_t)(base + r) * C2 + c2);
    }
  }
}

// B7: relu(max_j(s2 * y + t2)), bf16
struct ZmaxEpi {
  float s, t, zmax;
  __nv_bfloat16* out;
  __device__ void slot(int j, float y) {
    if (j == 0) zmax = -INFINITY;
    zmax = fmaxf(zmax, __fadd_rn(__fmul_rn(y, s), t));
  }
  __device__ void row_end(size_t o) { out[o] = __float2bfloat16_rn(fmaxf(zmax, 0.f)); }
};

// B2: extrema with the first winning slot, and the moments
struct MinmaxEpi {
  float ymx, ymn, psum, psq;
  int amx, amn;
  __nv_bfloat16 *ymax, *ymin;
  int *amax, *amin;
  __device__ void slot(int j, float y) {
    psum = __fadd_rn(psum, y);
    psq = __fadd_rn(psq, __fmul_rn(y, y));
    if (j == 0) {
      ymx = ymn = y;
      amx = amn = 0;
    } else {
      if (y > ymx) { ymx = y; amx = j; }  // strict: the first winner keeps it
      if (y < ymn) { ymn = y; amn = j; }
    }
  }
  __device__ void row_end(size_t o) {
    ymax[o] = __float2bfloat16_rn(ymx);  // exact: y is already bf16
    amax[o] = amx;
    ymin[o] = __float2bfloat16_rn(ymn);
    amin[o] = amn;
  }
};

template <int C1>
__global__ void conv_zmax_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b2, const float* __restrict__ s2,
    const float* __restrict__ t2, const float* __restrict__ scale1,
    const float* __restrict__ shift1, int rows, int k, int C2, int rt,
    __nv_bfloat16* __restrict__ out) {
  ZmaxEpi epi{s2[threadIdx.x], t2[threadIdx.x], -INFINITY, out};
  conv_krows<C1>(h, w, b2, scale1, shift1, rows, k, C2, rt, epi);
}

__global__ void conv_minmax_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b2, const float* __restrict__ scale1,
    const float* __restrict__ shift1, int rows, int k, int C2, int rt,
    __nv_bfloat16* __restrict__ ymax, int* __restrict__ amax,
    __nv_bfloat16* __restrict__ ymin, int* __restrict__ amin,
    float* __restrict__ part) {
  MinmaxEpi epi{0.f, 0.f, 0.f, 0.f, 0, 0, ymax, ymin, amax, amin};
  conv_krows<64>(h, w, b2, scale1, shift1, rows, k, C2, rt, epi);
  // part[element][block]; every block has rows
  part[(size_t)threadIdx.x * gridDim.x + blockIdx.x] = epi.psum;
  part[(size_t)(C2 + threadIdx.x) * gridDim.x + blockIdx.x] = epi.psq;
}

// rows of h1 staged per pass, keeping the tile within 48 KB (0: too wide)
int krows_tile(int k, int C1) {
  const int rt = (48 * 1024) / (k * C1 * 4);
  return rt > 8 ? 8 : rt;
}

template <int C1>
int launch_zmax(const void* h, const void* w, const void* b2, const void* s2,
                const void* t2, const void* scale1, const void* shift1,
                int rows, int k, int C2, void* out, cudaStream_t stream) {
  const int rt = krows_tile(k, C1);
  if (rt < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rt * k * C1 * 4;
  const int blocks = (rows + KROWS_PER_BLOCK - 1) / KROWS_PER_BLOCK;
  conv_zmax_kernel<C1><<<blocks, C2, smem, stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)b2,
      (const float*)s2, (const float*)t2, (const float*)scale1,
      (const float*)shift1, rows, k, C2, rt, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ N splits

constexpr int NS_CT = 128;  // output channels per block (one per thread)
constexpr int NS_RT = 32;   // rows per staged tile
constexpr int NS_STRIDE = NS_RT + 4;  // channel-major row stride, 16 B aligned

// y = bf16(h[b, n, :] @ W[:, ch] + b2[ch]) for rows n in [r0, r1) of batch
// b = blockIdx.z and channel ch = blockIdx.x * NS_CT + threadIdx.x;
// epi.row(n, y) for every row, in ascending order.
template <class Epi>
__device__ __forceinline__ void conv_nsplit(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b2, int N, int C1, int C2, int r0, int r1,
    Epi& epi) {
  extern __shared__ float4 hs4[];  // [C1][NS_STRIDE]
  float* hs = reinterpret_cast<float*>(hs4);
  const int ch = blockIdx.x * NS_CT + threadIdx.x;
  const bool active = ch < C2;
  const float bias = active ? b2[ch] : 0.f;

  for (int base = r0; base < r1; base += NS_RT) {
    const int nr = min(NS_RT, r1 - base);
    __syncthreads();
    const __nv_bfloat16* src = h + ((size_t)blockIdx.z * N + base) * C1;
    for (int e = threadIdx.x; e < NS_RT * C1; e += blockDim.x) {
      const int r = e / C1, c1 = e - r * C1;
      hs[c1 * NS_STRIDE + r] = r < nr ? __bfloat162float(src[e]) : 0.f;
    }
    __syncthreads();
    if (active) {
      float acc[NS_RT];
#pragma unroll
      for (int r = 0; r < NS_RT; ++r) acc[r] = 0.f;
      for (int c1 = 0; c1 < C1; ++c1) {
        const float wv = __bfloat162float(w[(size_t)c1 * C2 + ch]);
        const float4* col = hs4 + c1 * (NS_STRIDE / 4);
#pragma unroll
        for (int q = 0; q < NS_RT / 4; ++q) {
          const float4 hv = col[q];
          acc[4 * q + 0] = fmaf(hv.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(hv.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(hv.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(hv.w, wv, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < NS_RT; ++r) {
        if (r < nr) epi.row(base + r, bf16_round(__fadd_rn(acc[r], bias)));
      }
    }
  }
}

// B8: max_n(s2 * y + t2)
struct ZnmaxEpi {
  float s, t, zmax;
  __device__ void row(int, float y) { zmax = fmaxf(zmax, __fadd_rn(__fmul_rn(y, s), t)); }
};

// B5: extrema with the lowest winning row, and the moments
struct NmaxEpi {
  float ymx, ymn, psum, psq;
  int amx, amn;
  __device__ void row(int n, float y) {
    psum = __fadd_rn(psum, y);
    psq = __fadd_rn(psq, __fmul_rn(y, y));
    // rows ascend, compares are strict: the lowest row keeps a tie
    if (y > ymx) { ymx = y; amx = n; }
    if (y < ymn) { ymn = y; amn = n; }
  }
};

__global__ void conv_znmax_partial_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b2, const float* __restrict__ s2,
    const float* __restrict__ t2, int N, int C1, int C2, int n_valid,
    int rows_per_split, float* __restrict__ part) {
  const int ch = blockIdx.x * NS_CT + threadIdx.x;
  const bool active = ch < C2;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(n_valid, r0 + rows_per_split);  // rows >= n_valid never enter
  ZnmaxEpi epi{active ? s2[ch] : 0.f, active ? t2[ch] : 0.f, -INFINITY};
  conv_nsplit(h, w, b2, N, C1, C2, r0, r1, epi);
  if (active) part[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * C2 + ch] = epi.zmax;
}

__global__ void conv_znmax_final_kernel(const float* __restrict__ part,
                                        int nsplit, int B, int C2,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C2) return;
  const int b = i / C2, c = i - b * C2;
  float m = -INFINITY;
  for (int sp = 0; sp < nsplit; ++sp) {
    m = fmaxf(m, part[((size_t)b * nsplit + sp) * C2 + c]);
  }
  out[i] = fmaxf(m, 0.f);
}

__global__ void conv_nmax_partial_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b2, int N, int C1, int C2, int rows_per_split,
    float* __restrict__ pmax, int* __restrict__ pamax,
    float* __restrict__ pmin, int* __restrict__ pamin,
    float* __restrict__ pmom) {
  const int ch = blockIdx.x * NS_CT + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  NmaxEpi epi{-INFINITY, INFINITY, 0.f, 0.f, 0, 0};
  conv_nsplit(h, w, b2, N, C1, C2, r0, r1, epi);
  if (ch < C2) {
    const size_t o = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * C2 + ch;
    pmax[o] = epi.ymx;
    pamax[o] = epi.amx;
    pmin[o] = epi.ymn;
    pamin[o] = epi.amn;
    // pmom[split of batch][2][C2] (an empty split adds zeros)
    const size_t m = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * 2 * C2;
    pmom[m + ch] = epi.psum;
    pmom[m + C2 + ch] = epi.psq;
  }
}

__global__ void conv_nmax_final_kernel(
    const float* __restrict__ pmax, const int* __restrict__ pamax,
    const float* __restrict__ pmin, const int* __restrict__ pamin, int nsplit,
    int B, int C2, float* __restrict__ ymax, int* __restrict__ amax,
    float* __restrict__ ymin, int* __restrict__ amin) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C2) return;
  const int b = i / C2, c = i - b * C2;
  size_t o = (size_t)b * nsplit * C2 + c;
  float mx = pmax[o], mn = pmin[o];
  int ax = pamax[o], an = pamin[o];
  for (int sp = 1; sp < nsplit; ++sp) {
    o += C2;
    // splits ascend in rows: strict compares keep the lower row on a tie
    if (pmax[o] > mx) { mx = pmax[o]; ax = pamax[o]; }
    if (pmin[o] < mn) { mn = pmin[o]; an = pamin[o]; }
  }
  ymax[i] = mx;
  amax[i] = ax;
  ymin[i] = mn;
  amin[i] = an;
}

// the N-split partial kernels' shared memory: a [C1][NS_STRIDE] f32 tile
template <class Kernel>
int nsplit_smem(Kernel kernel, int C1, size_t* smem) {
  *smem = (size_t)C1 * NS_STRIDE * 4;
  if (*smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

// B7. h1 [rows, k, C1] bf16, w2 [C1, C2] bf16, b2/s2/t2 [C2] f32,
// scale1/shift1 [C1] f32 or null (no fold). out [rows, C2] bf16.
// C1 must be 64 or 128, C2 a multiple of 32 up to 1024.
extern "C" int conv_zmax_launch(const void* h, const void* w, const void* b2,
                                const void* s2, const void* t2,
                                const void* scale1, const void* shift1,
                                int rows, int k, int C1, int C2, void* out,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (C2 % 32 != 0 || C2 > 1024) return (int)cudaErrorInvalidValue;
  if (C1 == 64) {
    return launch_zmax<64>(h, w, b2, s2, t2, scale1, shift1, rows, k, C2, out, s);
  }
  if (C1 == 128) {
    return launch_zmax<128>(h, w, b2, s2, t2, scale1, shift1, rows, k, C2, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// B2. h1 [rows, k, 64] bf16 (the raw first-conv output), w2 [64, C2] bf16,
// b2 [C2] f32, scale1/shift1 [64] f32 (the BN1 fold). ymax/ymin [rows, C2]
// bf16, amax/amin [rows, C2] int32, mom [2, C2] f32 (written whole); part:
// f32 scratch of part_elems >= 2 C2 ceil(rows / 32) floats. C2 a multiple
// of 32 up to 1024.
extern "C" int conv_minmax_launch(const void* h, const void* w, const void* b2,
                                  const void* scale1, const void* shift1,
                                  int rows, int k, int C2, void* ymax,
                                  void* amax, void* ymin, void* amin, void* mom,
                                  void* part, long long part_elems,
                                  void* stream) {
  const int rt = krows_tile(k, 64);
  const int blocks = (rows + KROWS_PER_BLOCK - 1) / KROWS_PER_BLOCK;
  if (C2 % 32 != 0 || C2 > 1024 || k < 1 || rt < 1 || scale1 == nullptr ||
      shift1 == nullptr || part_elems < 2LL * C2 * blocks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    conv_minmax_kernel<<<blocks, C2, (size_t)rt * k * 64 * 4, s>>>(
        (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)b2,
        (const float*)scale1, (const float*)shift1, rows, k, C2, rt,
        (__nv_bfloat16*)ymax, (int*)amax, (__nv_bfloat16*)ymin, (int*)amin,
        (float*)part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)sum_cols((const float*)part, blocks, 2 * C2, (float*)mom, s);
}

// B8. h [B, N, C1] bf16, w [C1, C2] bf16, b/s2/t2 [C2] f32.
// part: [B, nsplit, C2] f32 scratch; out [B, C2] f32 (relu applied).
extern "C" int conv_znmax_launch(const void* h, const void* w, const void* b2,
                                 const void* s2, const void* t2, int B, int N,
                                 int C1, int C2, int n_valid, int nsplit,
                                 void* part, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  size_t smem = 0;
  int err = nsplit_smem(conv_znmax_partial_kernel, C1, &smem);
  if (err != 0) return err;
  const int rows_per_split = (N + nsplit - 1) / nsplit;
  const dim3 grid((C2 + NS_CT - 1) / NS_CT, nsplit, B);
  conv_znmax_partial_kernel<<<grid, NS_CT, smem, s>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)b2,
      (const float*)s2, (const float*)t2, N, C1, C2, n_valid, rows_per_split,
      (float*)part);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int total = B * C2;
  conv_znmax_final_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      (const float*)part, nsplit, B, C2, (float*)out);
  return (int)cudaGetLastError();
}

// B5 forward. h [B, N, C1] bf16, w [C1, C2] bf16, b [C2] f32. pmax/pmin
// [B, nsplit, C2] f32 and pamax/pamin int32 scratch, pmom [B, nsplit, 2,
// C2] f32 scratch; ymax/ymin [B, C2] f32, amax/amin [B, C2] int32 (global
// row), mom [2, C2] f32 (written whole).
extern "C" int conv_nmax_launch(const void* h, const void* w, const void* b,
                                int B, int N, int C1, int C2, int nsplit,
                                void* pmax, void* pamax, void* pmin,
                                void* pamin, void* pmom, void* ymax,
                                void* amax, void* ymin, void* amin, void* mom,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (nsplit < 1 || N < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int err = nsplit_smem(conv_nmax_partial_kernel, C1, &smem);
  if (err != 0) return err;
  const int rows_per_split = (N + nsplit - 1) / nsplit;
  const dim3 grid((C2 + NS_CT - 1) / NS_CT, nsplit, B);
  conv_nmax_partial_kernel<<<grid, NS_CT, smem, s>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)b, N, C1,
      C2, rows_per_split, (float*)pmax, (int*)pamax, (float*)pmin,
      (int*)pamin, (float*)pmom);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int total = B * C2;
  conv_nmax_final_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      (const float*)pmax, (const int*)pamax, (const float*)pmin,
      (const int*)pamin, nsplit, B, C2, (float*)ymax, (int*)amax,
      (float*)ymin, (int*)amin);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return (int)sum_rows((const float*)pmom, B * nsplit, 2 * C2, (float*)mom, s);
}
