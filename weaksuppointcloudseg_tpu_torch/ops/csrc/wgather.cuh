// The weighted neighbour sum of kernel B6's gather (wgather.cu), shared
// with kernel B9 (knn_wgather.cu) as its epilogue:
//   s = sum_j w_j * f[t_j, c],
// bf16 features widened to f32, one f32 fmaf chain in slot order
// j = 0..k-1. A neighbour outside [0, N) adds nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// nbr(j, t, w) yields slot j's neighbour row t and weight w.
template <class Nbr>
__device__ __forceinline__ float weighted_sum(const __nv_bfloat16* __restrict__ fb,
                                              int N, int Cf, int c, int k,
                                              Nbr nbr) {
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    int t;
    float w;
    nbr(j, t, w);
    if ((unsigned)t < (unsigned)N) {
      acc = fmaf(w, __bfloat162float(fb[(size_t)t * Cf + c]), acc);
    }
  }
  return acc;
}

}  // namespace
