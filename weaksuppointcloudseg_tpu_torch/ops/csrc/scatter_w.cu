// Kernel B6 (scatter): out[b, idx[b,p,j], :] += w[b,p,j] * ct[b,p,:], the
// backward of the weighted gathers B6 and B9 (the smoothness loss's
// cotangent of f).
//
// Replaces weaksuppointcloudseg_tpu/ops/scatter_pallas.py::
// scatter_add_weighted_pallas (body _scatter_w_kernel), which builds a
// combined weighted one-hot matrix per tile and sums with one matmul
// because a TPU has no scattered atomic adds.
//
// What bounds it on an H100: the bytes. At B=64, P=N=2048, k=10, C=51 it
// reads idx and w (10.5 MB) and the f32 cotangent (26.7 MB) once and
// writes out (26.7 MB) once: 0.019 ms at 3.35 TB/s.
//
// Design: B13's gather-sum over the inverse graph (scatter_add.cu,
// csr_gather.cuh, built first). Each
// destination row sums __fmul_rn(w[p,j], ct[p,c]) over its source slots in
// ascending order and is written once: no float atomics, the same bits on
// every launch, and bit for bit the plain version's index_add_ of w * ct.
// A source slot's Row (WVal) holds its point's ct row and its weight: the
// division of the slot by k and the weight's load are paid once per lane
// and slot, whatever its channels. At 51 channels (ShapeNet) a warp takes
// a row, two channels a lane; at 14 (S3DIS) csr_gather's narrow layout
// gives a row 4 lanes of 4 channels, read as float2 pairs.
// Summing over the inverse of the transform stage's k=20 graph, whose
// first 10 columns the smoothness loss uses, was tried and dropped: the
// gather then visits twice the slots (0.298 ms on an H100 against 0.177
// ms plus a 0.04 ms build of the loss's own graph's inverse,
// scripts/torch_scatter_profile.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_gather.cuh"

namespace {

// w [B, P, k] times ct [B, P, C] at a slot s = p * k + j: the slot's
// division by k and its weight once per row, the product per channel
struct WVal {
  static constexpr int kUnroll = 4;
  const float* w;
  const float* ct;
  int P, C;
  FastDiv by_k;
  bool vec;
  struct Row {
    const float* p;
    float w;
    __device__ __forceinline__ float at(int c) const { return __fmul_rn(w, p[c]); }
    __device__ __forceinline__ float2 pair(int c) const {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      return make_float2(__fmul_rn(w, x.x), __fmul_rn(w, x.y));
    }
  };
  __device__ __forceinline__ Row row(int b, int s) const {
    const size_t bp = (size_t)b * P + by_k(s);
    return Row{ct + bp * C, w[(size_t)b * P * by_k.d + s]};
  }
};

}  // namespace

// idx [B,P,k] int32, w [B,P,k] f32, ct [B,P,C] f32; offsets [B,N+1] /
// src [B,P*k] int32: the inverse of idx, built first (work as for
// inverse_graph_launch). out [B,N,C] f32, written whole. Returns a
// cudaError_t.
extern "C" int scatter_add_weighted_launch(const void* w, const void* ct,
                                           const void* idx, void* offsets,
                                           void* src,
                                           void* work, long long work_elems,
                                           int B, int P, int k, int N, int C,
                                           void* out, void* stream) {
  if (k < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int err = inverse_graph_launch(idx, B, P, k, N, offsets, src, work,
                                       work_elems, stream);
  if (err != 0) return err;
  const int S = P * k;
  return (int)csr_gather((const int32_t*)offsets, (const int32_t*)src, B, N,
                         S, C,
                         WVal{(const float*)w, (const float*)ct, P, C,
                              make_fastdiv(k, S),
                              C % 2 == 0 && (uintptr_t)ct % 8 == 0},
                         (float*)out, reinterpret_cast<cudaStream_t>(stream));
}
