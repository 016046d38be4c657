// The gather-sum over an inverse kNN graph, shared by kernels B13
// (scatter_add.cu), B4 (scatter_bn.cu) and B6's scatter (scatter_w.cu).
//
// A neighbour scatter out[b, idx[b,p,j], :] += val(b, p*k + j, :) becomes,
// once the graph is inverted (scatter_add.cu::inverse_graph_launch: for
// every destination row t of cloud b, the flat source slots s = p*k + j with
// idx[b,p,j] = t, ascending, in src[offsets[b,t] .. offsets[b,t+1])), a
// gather: each destination row sums its own segment in that order,
//   out[b, t, c] = (((0 + val(s_0, c)) + val(s_1, c)) + ...),
// in f32 with __fadd_rn, and is written once. No float atomics, so the
// result is the same bit for bit on every launch, and it is the order of
// torch.Tensor.index_add_ on the CPU (index order), so it equals the plain
// versions bit for bit.
//
// Layout: L lanes per destination row, each lane owning channels
// c0 + lane + L*i for i < CPL; rows wider than L*CPL loop over channel
// chunks. L is one lane for C <= 4 (of 1, 2, 4 and 8 lanes a row, one was
// the fastest for B13 at C=3 on an H100), else the smallest power of two
// >= C, at most 32. Source slots are read Val::kUnroll at a time, so that
// many rows' values are in flight before the adds, which keep their order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the inverse-graph build (scatter_add.cu), for the scatters that build
// their graph's inverse before they sum over it
extern "C" int inverse_graph_launch(const void* idx, int B, int P, int k,
                                    int N, void* offsets, void* src,
                                    void* work, long long work_elems,
                                    void* stream);

namespace {

constexpr int GATHER_THREADS = 256;

// s / d for 0 <= s < S by a multiply-high when S * d < 2^32 (exact there:
// magic = ceil(2^32 / d) errs by less than s / 2^32 < 1 / d), else by a
// division
struct FastDiv {
  unsigned magic;
  int d;
  __device__ __forceinline__ int operator()(int s) const {
    return magic ? (int)__umulhi((unsigned)s, magic) : s / d;
  }
};

inline FastDiv make_fastdiv(int d, long long S) {
  const bool ok = d > 1 && S * (long long)d < (1LL << 32);
  return FastDiv{ok ? (unsigned)(((1ULL << 32) + d - 1) / d) : 0u, d};
}

// Each value type names how many source slots a lane keeps in flight
// (kUnroll): 8 for plain rows (faster at C=64 than 4 on an H100), 4 where a
// value takes several loads.

// f32 contributions [B, S, C]
struct F32Val {
  static constexpr int kUnroll = 8;
  const float* g;
  int S, C;
  __device__ __forceinline__ float operator()(int b, int s, int c) const {
    return g[((size_t)b * S + s) * C + c];
  }
};

// bf16 contributions [B, S, C], widened exactly
struct Bf16Val {
  static constexpr int kUnroll = 4;
  const __nv_bfloat16* g;
  int S, C;
  __device__ __forceinline__ float operator()(int b, int s, int c) const {
    return __bfloat162float(g[((size_t)b * S + s) * C + c]);
  }
};

template <int L, int CPL, class Val>
__global__ void __launch_bounds__(GATHER_THREADS) csr_gather_kernel(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ src,
    int B, int N, int S, int C, Val val, float* __restrict__ out) {
  constexpr int RPB = GATHER_THREADS / L;  // destination rows per block
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / L;
  if (row >= (long long)B * N) return;
  const int sub = threadIdx.x % L;
  const int b = (int)(row / N), t = (int)(row - (long long)b * N);
  const int32_t* ob = offsets + (size_t)b * (N + 1);
  const int beg = ob[t], end = ob[t + 1];
  const int32_t* sb = src + (size_t)b * S;
  float* orow = out + row * C;
  constexpr int UNROLL = Val::kUnroll;
  for (int c0 = 0; c0 < C; c0 += L * CPL) {
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
    int q = beg;
    for (; q + UNROLL <= end; q += UNROLL) {
      int s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s[u] = sb[q + u];
      float v[UNROLL][CPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = c0 + sub + L * i;
          v[u][i] = c < C ? val(b, s[u], c) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], v[u][i]);
    }
    for (; q < end; ++q) {
      const int s = sb[q];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = c0 + sub + L * i;
        if (c < C) acc[i] = __fadd_rn(acc[i], val(b, s, c));
      }
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = c0 + sub + L * i;
      if (c < C) orow[c] = acc[i];
    }
  }
}

template <int L, int CPL, class Val>
cudaError_t launch_gather(const int32_t* offsets, const int32_t* src, int B,
                          int N, int S, int C, Val val, float* out,
                          cudaStream_t stream) {
  constexpr int RPB = GATHER_THREADS / L;
  const long long rows = (long long)B * N;
  if (rows == 0) return cudaSuccess;
  csr_gather_kernel<L, CPL, Val>
      <<<(unsigned)((rows + RPB - 1) / RPB), GATHER_THREADS, 0, stream>>>(
          offsets, src, B, N, S, C, val, out);
  return cudaGetLastError();
}

template <int L, class Val>
cudaError_t gather_cpl(int cpl, const int32_t* offsets, const int32_t* src,
                       int B, int N, int S, int C, Val val, float* out,
                       cudaStream_t stream) {
  if (cpl == 1) return launch_gather<L, 1>(offsets, src, B, N, S, C, val, out, stream);
  if (cpl == 2) return launch_gather<L, 2>(offsets, src, B, N, S, C, val, out, stream);
  return launch_gather<L, 4>(offsets, src, B, N, S, C, val, out, stream);
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// out [B, N, C] f32, every element written, at the lanes per row of the
// header
template <class Val>
cudaError_t csr_gather(const int32_t* offsets, const int32_t* src, int B,
                       int N, int S, int C, Val val, float* out,
                       cudaStream_t stream) {
  if (C < 1) return cudaErrorInvalidValue;
  const int lanes = C <= 4 ? 1 : C >= 32 ? 32 : pow2_at_least(C);
  const int per = (C + lanes - 1) / lanes;
  const int cpl = per >= 4 ? 4 : pow2_at_least(per);
  switch (lanes) {
    case 1: return gather_cpl<1>(cpl, offsets, src, B, N, S, C, val, out, stream);
    case 8: return gather_cpl<8>(cpl, offsets, src, B, N, S, C, val, out, stream);
    case 16: return gather_cpl<16>(cpl, offsets, src, B, N, S, C, val, out, stream);
    default: return gather_cpl<32>(cpl, offsets, src, B, N, S, C, val, out, stream);
  }
}

}  // namespace
