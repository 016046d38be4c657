// The distance pass and k selection of kernels B1 (knn_edge.cu), B12
// (knn.cu) and B15 (knn_gather.cu): a register-tiled f32 Gram with a
// streaming top-k.
//
// For every point i of every cloud b the kernel computes the squared
// distances from x[b,i] to all x[b,j] in IEEE f32, in the Pallas kernels'
// order of additions (knn_pallas.py:121-127, edgeconv_pallas.py:110-119),
//   d = (-2 x_i.x_j + |x_i|^2) + |x_j|^2,
// and selects the k nearest, nearest first. Exact mode keeps d unclamped
// and breaks ties by the lowest index (lax.top_k's order); fast mode clamps
// d at 0 and orders by the packed int32 "distance bits with the low
// idx_bits replaced by the column", so near-ties may order differently
// (held to an agreement rate) and the selected distance has its low
// idx_bits cleared. In both modes NaN distances come after +inf, in column
// order, as the plain version's stable sort puts them. Columns at or past
// n_valid are padding: exact mode reads their distance as +inf, fast mode
// as the key FAST_PAD | column (after every number, before NaN); B12 and
// B15 pass n_valid = N.
//
// Every distance is one fixed chain of f32 operations, so the three
// kernels select the same graph on the same bf16 points (widened exactly
// to f32), bit for bit: the norms sum the squares in channel order
// (sqnorm_kernel); each dot product starts at 0 and takes fmaf over
// channels 0..ceil4(C)-1 in order (the padding channels are zero);
// d = (-2 acc + |x_i|^2) + |x_j|^2 with no contraction; keys are
// select.cuh's order_key / fast_key. The result is the k smallest entries
// of the total order (key, column): exact keys tie only at equal
// distances, where the lower column comes first; fast keys are unique;
// KEY_NAN sorts above every number.
//
// Design. A block of 4 warps owns TT_RM = 128 query rows (32 a warp, one
// a lane) and walks the columns once, in tiles of TT_TN = 32 points. Each
// thread accumulates an 8 x 4 micro-tile of dot products in registers
// (rows rg + 4q of its warp's 32, columns cg + 8i of the tile, lane =
// 8 rg + cg), so one float4 of channels costs 8 + 4 conflict-free LDS.128
// for 128 FMAs. Points sit in shared memory as rows of ks floats (ks / 4
// odd, so 8 consecutive rows' float4s fall in distinct banks). The query
// rows load once when ceil4(C) <= 64; wider points are walked in chunks
// of 32 channels, in order, with the query rows' chunk staged beside the
// columns'. Each (tile, chunk) step is double-buffered with cp.async: the
// next step's loads are in flight while this one's FMAs run.
// Selection streams, and the B x N x N matrix never reaches device
// memory. Each row has a threshold: the float just above its k-th
// distance so far (NaN, which passes everything, until it has k). After a
// tile, a distance at or above its row's threshold is dropped with one
// compare; a survivor's distance goes to the tile's distance buffer and
// its bit to the row's survivor mask. Then lane r of the warp takes row
// r's survivors into the row's list of k entries: the first k as they
// come, then as a 4-ary max-heap whose root an entry below it replaces
// (a sift-down of log4 k levels). A warp owns its rows across the whole
// tile, so selection needs no block barrier. The k survivors are the k
// smallest of the total order whatever the order of arrival and however
// late a threshold tightens; the epilogue ranks them into sorted order.
// Shared memory does not grow with N: at C=64, k=20 it is 89.5 KB a block
// (two blocks per SM), at C=3 41.5 KB (four, bound by 128 registers).
//
// Epilogue contract: for every row i < N, every lane of the row's warp
// calls
//   e.finish<FAST>(b, row, lane, list, idx_mask)
// with list the row's k entries, sorted (entry_col, entry_value decode
// them). A warp finishes its TT_WR rows in increasing order, and a row's
// list stays in place until the kernel ends, tile_list_stride(k) entries
// after the previous row's, so an epilogue may finish a run of its rows
// together at the last of them.
//
// The kernel body is knn_tiles_body; knn_tiles_kernel (B12, B15) and
// B1's knn_edge_kernel are __global__ functions that call it, so each
// kernel keeps its own name in a trace.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int TT_WARPS = 4;
constexpr int TT_THREADS = 32 * TT_WARPS;
constexpr int TT_MQ = 8;              // query rows of a thread's micro-tile
constexpr int TT_MI = 4;              // columns of a thread's micro-tile
constexpr int TT_WR = 4 * TT_MQ;      // query rows per warp (one a lane)
constexpr int TT_RM = TT_WR * TT_WARPS;  // query rows per block
constexpr int TT_TN = 8 * TT_MI;      // columns per tile
constexpr int TT_KC = 32;             // channels per chunk past 64
constexpr int TT_K_MAX = 64;          // the largest k
constexpr uint64_t TT_EMPTY = ~0ull;  // above every real entry
constexpr int FAST_PAD = 0x7F000000;  // fast-mode key bits of a padding column

// Entries between the starts of two neighbouring rows' lists (odd, so
// neighbouring lanes' lists start in other banks).
__host__ __device__ constexpr int tile_list_stride(int k) { return k | 1; }

// |x_p|^2 in f32, channels summed in order (one thread per point).
__global__ void sqnorm_kernel(const float* __restrict__ x, int points, int C,
                              float* __restrict__ norms) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= points) return;
  float s = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = x[(size_t)p * C + c];
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  norms[p] = s;
}

// ---- 64-bit entries: the key's order as unsigned, then the column ----

template <bool FAST>
__device__ __forceinline__ uint64_t make_entry(float d, int col, int idx_mask) {
  const int key = FAST ? fast_key(d, col, idx_mask) : order_key(d);
  return ((uint64_t)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)col;
}

__device__ __forceinline__ int entry_key(uint64_t e) {
  return (int)((uint32_t)(e >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int entry_col(uint64_t e) { return (int)(uint32_t)e; }

// The selected squared distance an entry stands for.
template <bool FAST>
__device__ __forceinline__ float entry_value(uint64_t e, int idx_mask) {
  const int key = entry_key(e);
  return FAST ? __int_as_float(key & ~idx_mask) : key_value(key);
}

// The filter threshold of a row whose k-th entry is e: a distance d can
// enter the k smallest only if !(d >= t). Exact: t is the float just above
// the k-th value (a tie at that value passes and the list orders it by
// column). Fast: t is the smallest float whose key bits exceed the k-th
// key's, so a clamped d < t may still win by its column bits. NaN, which
// passes everything, while the list is not full or its k-th is +inf or
// NaN.
template <bool FAST>
__device__ __forceinline__ float next_threshold(uint64_t e, int idx_mask) {
  const int key = entry_key(e);
  if (key >= 0x7F800000) return __int_as_float(0x7FC00000);
  return FAST ? __int_as_float((key | idx_mask) + 1) : key_value(key + 1);
}

// Move entry c down from slot i of the 4-ary max-heap `heap` of k entries
// (the children of slot i are 4i + 1 .. 4i + 4) until its children are
// smaller. Returns the entry that ends in slot i.
__device__ __forceinline__ uint64_t sift_down(uint64_t* heap, int k, int i,
                                              uint64_t c) {
  const int i0 = i;
  uint64_t top = c;
  for (;;) {
    const int ch0 = 4 * i + 1;
    if (ch0 >= k) break;
    int ch = ch0;
    uint64_t v = heap[ch0];
#pragma unroll
    for (int d = 1; d < 4; ++d) {
      if (ch0 + d < k) {
        const uint64_t w = heap[ch0 + d];
        if (w > v) {
          v = w;
          ch = ch0 + d;
        }
      }
    }
    if (!(v > c)) break;
    heap[i] = v;
    if (i == i0) top = v;
    i = ch;
  }
  heap[i] = c;
  return top;
}

// Take one tile's survivors into one row's list (one lane per row). The
// list holds the k smallest entries so far: the first k enter as they
// come and then become a max-heap; after that an entry below the root
// (`top`, kept in a register; TT_EMPTY while the list is not full)
// replaces it and sifts down. `bits` holds the row's survivors as 8
// bytes, byte cg for tile columns cg + 8i (bit i); their distances are in
// `drow`.
template <bool FAST>
__device__ __forceinline__ void take_survivors(uint64_t bits, const float* drow,
                                               int j0, int k, int idx_mask,
                                               uint64_t* heap, int& len,
                                               uint64_t& top) {
  while (bits) {
    const int p = __ffsll((long long)bits) - 1;
    bits &= bits - 1;
    const int ct = (p >> 3) + 8 * (p & 7);  // the tile column of bit p
    const uint64_t c = make_entry<FAST>(drow[ct], j0 + ct, idx_mask);
    if (len < k) {
      heap[len++] = c;
      if (len == k) {
        for (int i = (k - 2) / 4; i >= 0; --i) {
          top = sift_down(heap, k, i, heap[i]);
        }
      }
    } else if (c < top) {
      top = sift_down(heap, k, 0, c);
    }
  }
}

// Sort a row's list of k entries in place (all lanes of its warp): each
// entry's rank is the number of entries below it (they are distinct).
__device__ __forceinline__ void sort_list(uint64_t* list, int k, int lane) {
  uint64_t e0 = lane < k ? list[lane] : TT_EMPTY;
  uint64_t e1 = lane + 32 < k ? list[lane + 32] : TT_EMPTY;
  int r0 = 0, r1 = 0;
  for (int t = 0; t < k; ++t) {
    const uint64_t v = list[t];
    r0 += v < e0;
    r1 += v < e1;
  }
  __syncwarp();
  if (lane < k) list[r0] = e0;
  if (lane + 32 < k) list[r1] = e1;
  __syncwarp();
}

// ---- cp.async staging of point rows ----

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage channels [c0, c0 + kc) of points [p0, p0 + count) (p < n) as rows
// of ks floats; channels >= C inside the chunk are written as zeros. Rows
// of points >= n are left as they are (their results are never used).
// `vec`: C % 4 == 0 and x 16-byte aligned, so the copies are 16 bytes. A
// thread walks the elements tid, tid + TT_THREADS, ... keeping its (row,
// element) pair by increments, without a division per element.
__device__ __forceinline__ void stage_points(const float* __restrict__ xb,
                                             int p0, int count, int n, int C,
                                             int c0, int kc, int ks, bool vec,
                                             float* dst) {
  const int w = vec ? kc / 4 : kc;  // elements per row
  const int dr = TT_THREADS / w, de = TT_THREADS % w;
  int r = threadIdx.x / w, e = threadIdx.x % w;
  for (; r < count; r += dr, e += de) {
    if (e >= w) {
      e -= w;
      ++r;
      if (r >= count) break;
    }
    const int p = p0 + r;
    if (p >= n) break;
    if (vec) {
      const int c = c0 + 4 * e;
      float* d = dst + r * ks + 4 * e;
      if (c < C) {
        cp_async16(d, xb + (size_t)p * C + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      const int c = c0 + e;
      float* d = dst + r * ks + e;
      if (c < C) {
        cp_async4(d, xb + (size_t)p * C + c);
      } else {
        *d = 0.f;
      }
    }
  }
}

// The shared-memory geometry of one launch.
struct TileGeometry {
  int cpad;     // ceil4(C): the channels every dot product runs over
  int kc;       // channels per chunk (a multiple of 4)
  int ks;       // floats per staged point row (ks / 4 odd)
  int nchunks;  // chunks per point; 1: the query rows stay resident
};

inline TileGeometry tile_geometry(int C) {
  TileGeometry g;
  g.cpad = (C + 3) / 4 * 4;
  g.kc = g.cpad <= 64 ? g.cpad : TT_KC;
  g.ks = (g.kc / 4) % 2 == 1 ? g.kc : g.kc + 4;
  g.nchunks = (g.cpad + g.kc - 1) / g.kc;
  return g;
}

// Bytes of one block's shared memory: the row lists, the survivor masks,
// the tile's survivor distances and the thresholds, then the resident
// query rows and two stages.
inline size_t tile_smem(const TileGeometry& g, int k) {
  const size_t sel = (size_t)TT_RM * tile_list_stride(k) * 8 + TT_RM * 8 +
                     (size_t)TT_RM * TT_TN * 4 + TT_RM * 4;
  const size_t rows = (size_t)TT_RM * g.ks * 4;
  const size_t cols = (size_t)TT_TN * g.ks * 4;
  return sel + (g.nchunks == 1 ? rows + 2 * cols : 2 * (rows + cols));
}

// One block's work: TT_RM query rows against all N columns of cloud
// blockIdx.y, then the epilogue. x [B,N,C] f32 with |x_p|^2 in norms.
template <bool FAST, class Epilogue>
__device__ __forceinline__ void knn_tiles_body(
    const float* __restrict__ x, const float* __restrict__ norms, int N, int C,
    TileGeometry geo, int k, int n_valid, int idx_mask, bool vec,
    Epilogue epi) {
  extern __shared__ uint64_t smem64[];
  const int ls = tile_list_stride(k);
  uint64_t* list = smem64;               // [TT_RM][ls] the rows' heaps
  uint64_t* mask = list + TT_RM * ls;    // [TT_RM] survivor bytes
  float* dtile = reinterpret_cast<float*>(mask + TT_RM);  // [TT_RM][TT_TN]
  float* thr = dtile + TT_RM * TT_TN;    // [TT_RM]
  float* tiles = thr + TT_RM;
  const int ks = geo.ks, kc = geo.kc, nchunks = geo.nchunks;
  const bool resident = nchunks == 1;
  const int rows_f = TT_RM * ks, cols_f = TT_TN * ks;
  float* rows_res = tiles;  // [TT_RM][ks] when resident
  float* stage0 = tiles + (resident ? rows_f : 0);
  const int stage_f = (resident ? 0 : rows_f) + cols_f;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TT_RM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int wrow = warp * TT_WR;  // the warp's first local row
  const float* xb = x + (size_t)b * N * C;
  const float* nb = norms + (size_t)b * N;

  for (int e = threadIdx.x; e < TT_RM; e += TT_THREADS) {
    thr[e] = __int_as_float(0x7FC00000);  // NaN: everything passes
  }
  // lane r keeps row wrow + r's list length and largest entry
  int len = 0;
  uint64_t top = TT_EMPTY;

  const int ntiles = (N + TT_TN - 1) / TT_TN;
  const int steps = ntiles * nchunks;
  auto stage_step = [&](int s) {
    const int t = s / nchunks, ch = s - t * nchunks;
    float* st = stage0 + (s & 1) * stage_f;
    if (!resident) {
      stage_points(xb, row0, TT_RM, N, C, ch * kc, kc, ks, vec, st);
      st += rows_f;
    }
    stage_points(xb, t * TT_TN, TT_TN, N, C, ch * kc, kc, ks, vec, st);
  };
  if (resident) stage_points(xb, row0, TT_RM, N, C, 0, kc, ks, vec, rows_res);
  stage_step(0);
  cp_async_commit();

  float rn[TT_MQ];
#pragma unroll
  for (int q = 0; q < TT_MQ; ++q) {
    const int row = row0 + wrow + rg + 4 * q;
    rn[q] = row < N ? nb[row] : 0.f;
  }
  float acc[TT_MQ][TT_MI];
  float cn[TT_MI];

  for (int s = 0; s < steps; ++s) {
    const int t = s / nchunks, ch = s - t * nchunks;
    const int j0 = t * TT_TN;
    if (s + 1 < steps) stage_step(s + 1);
    cp_async_commit();
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < TT_MI; ++i) {
        const int j = j0 + cg + 8 * i;
        cn[i] = j < N ? nb[j] : 0.f;
#pragma unroll
        for (int q = 0; q < TT_MQ; ++q) acc[q][i] = 0.f;
      }
    }
    cp_async_wait1();
    __syncthreads();  // step s has landed in every thread's view

    // ---- the Gram micro-tile over this chunk's channels, in order ----
    const float* st = stage0 + (s & 1) * stage_f;
    const float* rp = (resident ? rows_res : st) + (wrow + rg) * ks;
    const float* cp = (resident ? st : st + rows_f) + cg * ks;
    const int nq = min(kc, geo.cpad - ch * kc) / 4;
#pragma unroll 2
    for (int c4 = 0; c4 < nq; ++c4) {
      float4 r[TT_MQ], v[TT_MI];
#pragma unroll
      for (int q = 0; q < TT_MQ; ++q)
        r[q] = *reinterpret_cast<const float4*>(rp + 4 * q * ks + 4 * c4);
#pragma unroll
      for (int i = 0; i < TT_MI; ++i)
        v[i] = *reinterpret_cast<const float4*>(cp + 8 * i * ks + 4 * c4);
#pragma unroll
      for (int q = 0; q < TT_MQ; ++q)
#pragma unroll
        for (int i = 0; i < TT_MI; ++i)
          acc[q][i] = fmaf(r[q].x, v[i].x, acc[q][i]);
#pragma unroll
      for (int q = 0; q < TT_MQ; ++q)
#pragma unroll
        for (int i = 0; i < TT_MI; ++i)
          acc[q][i] = fmaf(r[q].y, v[i].y, acc[q][i]);
#pragma unroll
      for (int q = 0; q < TT_MQ; ++q)
#pragma unroll
        for (int i = 0; i < TT_MI; ++i)
          acc[q][i] = fmaf(r[q].z, v[i].z, acc[q][i]);
#pragma unroll
      for (int q = 0; q < TT_MQ; ++q)
#pragma unroll
        for (int i = 0; i < TT_MI; ++i)
          acc[q][i] = fmaf(r[q].w, v[i].w, acc[q][i]);
    }
    __syncthreads();  // stage s & 1 is free for step s + 2
    if (ch != nchunks - 1) continue;

    // ---- filter: survivors' distances and masks, warp-local ----
#pragma unroll
    for (int q = 0; q < TT_MQ; ++q) {
      const int lr = wrow + rg + 4 * q;
      const float t_row = thr[lr];
      float* drow = dtile + lr * TT_TN;
      unsigned bits = 0;
#pragma unroll
      for (int i = 0; i < TT_MI; ++i) {
        const int j = j0 + cg + 8 * i;
        float d = __fadd_rn(__fmul_rn(-2.f, acc[q][i]), rn[q]);
        d = __fadd_rn(d, cn[i]);
        if (j >= n_valid) d = FAST ? __int_as_float(FAST_PAD) : INFINITY;
        if (!(d >= t_row) && j < N) {
          bits |= 1u << i;
          drow[cg + 8 * i] = d;
        }
      }
      reinterpret_cast<uint8_t*>(mask + lr)[cg] = row0 + lr < N ? bits : 0;
    }
    __syncwarp();
    // ---- selection: lane r takes row wrow + r's survivors ----
    {
      const int lr = wrow + lane;
      const uint64_t m = mask[lr];
      if (m) {
        take_survivors<FAST>(m, dtile + lr * TT_TN, j0, k, idx_mask,
                             list + lr * ls, len, top);
        thr[lr] = next_threshold<FAST>(top, idx_mask);
      }
    }
    __syncwarp();
  }

  // ---- the epilogue, row by row ----
  for (int r = 0; r < TT_WR; ++r) {
    const int row = row0 + wrow + r;
    if (row >= N) break;
    sort_list(list + (wrow + r) * ls, k, lane);
    epi.template finish<FAST>(b, row, lane, list + (wrow + r) * ls, idx_mask);
  }
}

template <bool FAST, class Epilogue>
__global__ void __launch_bounds__(TT_THREADS) knn_tiles_kernel(
    const float* __restrict__ x, const float* __restrict__ norms, int N, int C,
    TileGeometry geo, int k, int n_valid, int idx_mask, bool vec,
    Epilogue epi) {
  knn_tiles_body<FAST>(x, norms, N, C, geo, k, n_valid, idx_mask, vec, epi);
}

// The shapes the tiled kernels take: 1 <= k <= min(k_max, N), k_max <=
// TT_K_MAX; 1 <= B <= 65535 (the grid's y); points with a channel.
inline bool tiles_shape_ok(int B, int N, int C, int k, int k_max) {
  return B >= 1 && B <= 65535 && N >= 1 && C >= 1 && k >= 1 && k <= k_max &&
         k <= TT_K_MAX && k <= N;
}

// Launch `kernel` (knn_tiles_kernel<FAST, Epilogue> or a __global__ of
// the same parameters that calls knn_tiles_body) over x [B,N,C] f32 whose
// norms are already in `norms`.
template <class Kernel, class Epilogue>
cudaError_t tiles_kernel_launch(Kernel kernel, const float* x, int B, int N,
                                int C, int k, int n_valid, int idx_bits,
                                const float* norms, const Epilogue& epi,
                                cudaStream_t s) {
  const TileGeometry geo = tile_geometry(C);
  const size_t smem = tile_smem(geo, k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte aligned rows
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid((N + TT_RM - 1) / TT_RM, B);
  kernel<<<grid, TT_THREADS, smem, s>>>(x, norms, N, C, geo, k, n_valid,
                                        (1 << idx_bits) - 1, vec, epi);
  return cudaGetLastError();
}

// Norms into the [B,N] scratch, then knn_tiles_kernel with epilogue `epi`
// over all N columns. Returns cudaErrorInvalidValue for a shape outside
// tiles_shape_ok.
template <bool FAST, class Epilogue>
cudaError_t knn_tiles_launch(const float* x, int B, int N, int C, int k,
                             int k_max, int idx_bits, float* norms,
                             Epilogue epi, cudaStream_t s) {
  if (!tiles_shape_ok(B, N, C, k, k_max)) return cudaErrorInvalidValue;
  const int points = B * N;
  sqnorm_kernel<<<(points + 255) / 256, 256, 0, s>>>(x, points, C, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tiles_kernel_launch(knn_tiles_kernel<FAST, Epilogue>, x, B, N, C, k,
                             N, idx_bits, norms, epi, s);
}

}  // namespace
