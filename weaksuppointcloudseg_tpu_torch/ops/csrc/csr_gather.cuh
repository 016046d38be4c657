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
// versions bit for bit. The lane layout below changes which lane adds a
// channel, never the order of its sum.
//
// Layout: L lanes per destination row, CPL channels a lane, chosen from C
// alone.
// - C >= 32: a warp a row (L = 32); lane l owns channels c0 + l + 32 i
//   (i < CPL = 1, 2 or 4; wider rows loop over chunks of 32 CPL), so each
//   load instruction reads 128 contiguous bytes of a source row.
// - C < 32: a lane owns CPL = min(NARROW_CPL, the power of two >= C)
//   contiguous channels, and a row takes L = the power of two >= C / CPL
//   lanes: one lane at C <= 4 (of 1, 2, 4 and 8 lanes a row, one was the
//   fastest for B13 at C=3 on an H100), 2 at 5-8, 4 at 9-16 (B6 at 14
//   channels), 8 at 17-31. A lane reads its row's source index, and forms
//   the value's row (B6: the slot's division by k and its weight), once
//   per slot for all its channels; channel pairs load as one float2
//   (bf16x2) where C is even and the base aligned. Before, rows of
//   5-31 channels took one lane per channel, each repeating that work.
// Source slots are read Val::kUnroll at a time, so that many rows' values
// are in flight before the adds, which keep their order.

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
constexpr int NARROW_CPL = 4;  // channels a lane owns in rows of C < 32

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

// Each value type gives, for a source slot, a Row whose at(c) is the
// value of channel c and pair(c) those of channels c and c + 1 (read where
// vec: C even and the base aligned for it), and names how many source
// slots a lane keeps in flight (kUnroll): 8 for plain rows (faster at
// C=64 than 4 on an H100), 4 where a value takes several loads.

// f32 contributions [B, S, C]
struct F32Val {
  static constexpr int kUnroll = 8;
  const float* g;
  int S, C;
  bool vec;
  struct Row {
    const float* p;
    __device__ __forceinline__ float at(int c) const { return p[c]; }
    __device__ __forceinline__ float2 pair(int c) const {
      return *reinterpret_cast<const float2*>(p + c);
    }
  };
  __device__ __forceinline__ Row row(int b, int s) const {
    return Row{g + ((size_t)b * S + s) * C};
  }
};

inline F32Val f32_val(const float* g, int S, int C) {
  return F32Val{g, S, C, C % 2 == 0 && (uintptr_t)g % 8 == 0};
}

// bf16 contributions [B, S, C], widened exactly
struct Bf16Val {
  static constexpr int kUnroll = 4;
  const __nv_bfloat16* g;
  int S, C;
  bool vec;
  struct Row {
    const __nv_bfloat16* p;
    __device__ __forceinline__ float at(int c) const {
      return __bfloat162float(p[c]);
    }
    __device__ __forceinline__ float2 pair(int c) const {
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + c));
    }
  };
  __device__ __forceinline__ Row row(int b, int s) const {
    return Row{g + ((size_t)b * S + s) * C};
  }
};

inline Bf16Val bf16_val(const __nv_bfloat16* g, int S, int C) {
  return Bf16Val{g, S, C, C % 2 == 0 && (uintptr_t)g % 4 == 0};
}

// this lane's CPL values of one source row in the chunk at c0 (0 past C)
template <int L, int CPL, class Row>
__device__ __forceinline__ void lane_values(const Row& r, int c0, int sub,
                                            int C, bool vec,
                                            float (&v)[CPL]) {
  if constexpr (L == 32) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = c0 + sub + 32 * i;
      v[i] = c < C ? r.at(c) : 0.f;
    }
  } else {
    if constexpr (CPL % 2 == 0) {
      if (vec) {  // c even and C even: c < C covers c + 1
#pragma unroll
        for (int i = 0; i < CPL; i += 2) {
          const int c = c0 + sub * CPL + i;
          const float2 x = c < C ? r.pair(c) : make_float2(0.f, 0.f);
          v[i] = x.x;
          v[i + 1] = x.y;
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = c0 + sub * CPL + i;
      v[i] = c < C ? r.at(c) : 0.f;
    }
  }
}

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
      for (int u = 0; u < UNROLL; ++u) {
        lane_values<L, CPL>(val.row(b, s[u]), c0, sub, C, val.vec, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], v[u][i]);
    }
    for (; q < end; ++q) {
      float v[CPL];
      lane_values<L, CPL>(val.row(b, sb[q]), c0, sub, C, val.vec, v);
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = L == 32 ? c0 + sub + 32 * i : c0 + sub * CPL + i;
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

// one lane a row, CPL halved down to cpl (a power of two <= NARROW_CPL)
template <int CPL, class Val>
cudaError_t one_lane(int cpl, const int32_t* offsets, const int32_t* src,
                     int B, int N, int S, int C, Val val, float* out,
                     cudaStream_t stream) {
  if constexpr (CPL > 1) {
    if (cpl < CPL) {
      return one_lane<CPL / 2>(cpl, offsets, src, B, N, S, C, val, out, stream);
    }
  }
  return launch_gather<1, CPL>(offsets, src, B, N, S, C, val, out, stream);
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
  if (C >= 32) {
    const int per = (C + 31) / 32;
    if (per == 1) return launch_gather<32, 1>(offsets, src, B, N, S, C, val, out, stream);
    if (per == 2) return launch_gather<32, 2>(offsets, src, B, N, S, C, val, out, stream);
    return launch_gather<32, 4>(offsets, src, B, N, S, C, val, out, stream);
  }
  const int cpl = pow2_at_least(C) < NARROW_CPL ? pow2_at_least(C) : NARROW_CPL;
  switch (pow2_at_least((C + cpl - 1) / cpl)) {  // lanes; > 1: cpl = NARROW_CPL
    case 1: return one_lane<NARROW_CPL>(cpl, offsets, src, B, N, S, C, val, out, stream);
    case 2: return launch_gather<2, NARROW_CPL>(offsets, src, B, N, S, C, val, out, stream);
    case 4: return launch_gather<4, NARROW_CPL>(offsets, src, B, N, S, C, val, out, stream);
    case 8: return launch_gather<8, NARROW_CPL>(offsets, src, B, N, S, C, val, out, stream);
    case 16: return launch_gather<16, NARROW_CPL>(offsets, src, B, N, S, C, val, out, stream);
    default: return launch_gather<32, NARROW_CPL>(offsets, src, B, N, S, C, val, out, stream);
  }
}

}  // namespace
