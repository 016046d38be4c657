// k-nearest selection over distance rows held in shared memory, shared by
// kernels B1 (knn_edge.cu) and B12 (knn.cu): one warp per row, the row
// stored as int32 keys whose signed integer order is the selection order.
//
// Exact mode stores order_key(d): the f32 bits made monotone under signed
// compare (a negative value's magnitude bits flipped, -0 read as +0), every
// NaN as KEY_NAN, above +inf, where the plain version's stable sort puts
// NaN. Equal keys go to the lowest column. Fast mode stores fast_key: the
// bits of max(d, 0) (NaN kept as KEY_NAN) with the low idx_bits replaced by
// the column, so keys are unique. A selected entry becomes KEY_KNOCKOUT,
// above every other key, so a row of NaN or infinite distances still
// yields k distinct columns in range.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int KEY_NAN = 0x7FC00000;
constexpr int KEY_KNOCKOUT = 0x7FFFFFFF;

__device__ __forceinline__ int order_key(float d) {
  if (d != d) return KEY_NAN;
  const int bits = __float_as_int(__fadd_rn(d, 0.f));  // -0 + 0 = +0
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

// The distance an exact-mode key stands for (KEY_NAN gives a NaN).
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
}

__device__ __forceinline__ int fast_key(float d, int col, int idx_mask) {
  const int bits = d != d ? KEY_NAN : __float_as_int(fmaxf(d, 0.f));
  return (bits & ~idx_mask) | col;
}

// Lane-local minimum over columns lane, lane+32, ... (the scan runs in
// increasing column order with a strict compare, so the lowest column wins).
__device__ __forceinline__ void lane_min(const int* row, int n, int lane,
                                         int& best_key, int& best_col) {
  int bk = KEY_KNOCKOUT, bc = KEY_KNOCKOUT;
#pragma unroll 8
  for (int j = lane; j < n; j += 32) {
    const int v = row[j];
    if (v < bk) { bk = v; bc = j; }
  }
  best_key = bk;
  best_col = bc;
}

// Minimum (key, column) over the warp's lanes, the lowest column on equal
// keys; every lane ends with the winner. UNIQUE (fast mode's keys, which
// hold their column) skips the tie compare.
template <bool UNIQUE>
__device__ __forceinline__ void warp_min(int& key, int& col) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, off);
    const int oc = __shfl_xor_sync(0xffffffffu, col, off);
    if (ok < key || (!UNIQUE && ok == key && oc < col)) { key = ok; col = oc; }
  }
}

}  // namespace
