// Kernels B10 and B17: out = exp(-max(|f_i|^2 - 2 f_i.f_j + |f_j|^2, 0)) @ u
// over the points j of the same sample whose 128-point tile the tile mask
// keeps, the Gaussian-affinity matvec of the matrix-free label propagation.
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
// What bounds it on an H100: instruction issue, and no one pipe. Per kept
// ordered pair the affinity costs 10 instructions on the FP32 side (a
// 6-long dot, FADD, FFMA, a NaN-keeping min, MUFU.EX2): the Gram stays in
// IEEE f32, since exp(-1e3 d^2) amplifies Gram error about a thousandfold
// (ROADMAP C1). The apply at the CG's K=13 would add 13 FFMAs; on tensor
// cores it costs 1.5 mma.sync and 2.5 splitting instructions a pair. The
// innermost loop issues 15 instructions a pair (cuobjdump -sass), at about
// half of one instruction a cycle per scheduler: the FP32, MUFU and tensor
// pipes are each under half busy by count, and a copy issuing a third fewer
// mma.sync is only 8% faster (scripts/torch_affinity_sweep.py --probe).
// A surface-sampled room keeps ~4% of the tile pairs (the mask,
// ops/affinity.py), unevenly: in bench.py's 131,072-point room a row tile
// keeps 42.6 column tiles on the mean and 200 at most, and
// room_label_prop's pad blocks keep every other pad tile (499 in the
// padded room).
//
// Design:
// - The work plan (ops/affinity.py::tile_plan, built once per label
//   propagation beside the mask) lists each row tile's kept column tiles in
//   ascending order and cuts them into items of at most SEGMENT_TILES (8).
//   One block is one item, a (sample, row tile, segment): no block waits
//   on the heaviest row tile. A row tile of one item writes out directly;
//   the others write [K, 128] partials to a workspace, and a second kernel
//   adds them in item order. Every sum runs in an order fixed by the mask,
//   S and K's route: columns ascending within an item (eight at a time
//   inside an mma), then item by item. Neither the grid, the SM count nor
//   the order in which blocks run enters it, and there are no atomics.
// - One pass writes each point's record: its features times sqrt(log2 e),
//   zeros past F, and its norm by the dot's own FMA chain. Then t = 2 x.y -
//   |x|^2 - |y|^2 = -d log2 e, exp(-d) = 2^t is one MUFU.EX2, and a point's
//   t to itself is exactly 0. The scaling rounds each feature once, which
//   moves a kept pair's exponent by at most ~4 sqrt(30 log2 e) 2^-24
//   max |f|: sqrt(30) / max |f| of the Gram's own cancellation bound.
// - ex2.approx.ftz.f32: 2 ulp (the CUDA Programming Guide's bound for
//   exp2f), flushing results below 2^-126 to 0; min.NaN keeps a NaN
//   distance NaN, as the plain version's clamp does. The tolerance holds
//   the kernel to 1e-5 of sum_j W_ij |u_j| beside twice the Gram bound.
// - The apply. K = 1 (the degree pass) on the FP32 pipe: a thread owns ROWS
//   (R = 2) rows, and each broadcast load of a column's record serves both.
//   K >= 2 on tensor cores: mma.sync m16n8k8 TF32 with the affinities and u
//   split into hi + lo and three products, each exact, with f32 sums: below
//   3 x 2^-20 of w |u| a pair (never one TF32 product: ~5e-4 on every
//   matvec stalls the CG, C1).
// - Column tiles are staged in double-buffered shared memory by cp.async
//   (16-byte copies of records, and of u where N % 4 == 0 in the [B,K,N]
//   layout), the next tile in flight while this one is consumed: one
//   barrier per tile.
// - S, R, TC_MIN_K and TC_WARPS were chosen by scripts/
//   torch_affinity_sweep.py (patched copies timed on the bench room and the
//   padded room, PERF.md): at S = 16, TC_WARPS = 8, R = 1, K = 1 on
//   tensor cores or K = 13 on the FP32 pipe the kernel is slower; S = 4 and
//   TC_WARPS = 4 tie on the bench room and lose on the padded one, and
//   R = 4 is within 2%.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;   // the mask's tile: rows of an item, columns of a tile
constexpr int FMAX = 6;     // features
constexpr int REC = 8;      // a point's record: FMAX scaled features, norm, 0
constexpr int ROWS = 2;     // R: rows of a thread of the FP32 apply
constexpr int THREADS = TILE / ROWS;
constexpr int TC_MIN_K = 2;  // K from which the apply is on tensor cores
constexpr int TC_WARPS = 2;  // warps of a tensor-core item
constexpr int TC_M = TILE / (16 * TC_WARPS);  // 16-row m-tiles of a warp
constexpr int USTRIDE = TILE + 4;  // u row stride: conflict-free B fragments
// sqrt(log2 e): features scaled by it give distances in units of log2, so
// that exp(-d) = 2^-(scaled d), one MUFU.EX2 with no multiply
constexpr float SCALE = 1.2011224087864498f;
static_assert(TILE % ROWS == 0 && TILE % 8 == 0, "tiles");
static_assert(TC_M >= 1 && TC_M * 16 * TC_WARPS == TILE, "tensor-core rows");

__device__ __forceinline__ float dot6(const float (&x)[FMAX],
                                      const float (&y)[FMAX]) {
  float s = x[0] * y[0];
#pragma unroll
  for (int c = 1; c < FMAX; ++c) s = fmaf(x[c], y[c], s);
  return s;
}

// exp(-max(d, 0)) of the scaled records x, y (norms nx, ny): t = 2 x.y -
// nx - ny = -d log2 e, then a NaN-propagating min with 0 and MUFU.EX2. A
// point and itself: t = 2 n - 2 n = 0 exactly (the same FMA chain).
__device__ __forceinline__ float gauss(const float (&x)[FMAX], float nx,
                                       const float (&y)[FMAX], float ny) {
  const float t = fmaf(2.f, dot6(x, y), -(nx + ny));
  float m, w;
  asm("min.NaN.f32 %0, %1, 0f00000000;" : "=f"(m) : "f"(t));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(w) : "f"(m));
  return w;
}

// x = hi + lo: hi is x cut to TF32 (what the tensor core reads of x), lo
// the exact f32 rest (|lo| < 2^-10 |x|), of which it reads the top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, a 16x8 (row), b 8x8 (col), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rec[b, p] = (SCALE f[b, p], zeros past F, |SCALE f|^2 by dot6's chain, 0)
template <bool KN>
__global__ void __launch_bounds__(256) affinity_prep_kernel(
    const float* __restrict__ feat, long long total, int N, int F,
    float* __restrict__ rec) {
  const long long p = (long long)blockIdx.x * 256 + threadIdx.x;
  if (p >= total) return;
  const long long b = p / N;
  const int n = (int)(p - b * N);
  const float* fb = feat + b * N * F;
  float x[FMAX];
#pragma unroll
  for (int c = 0; c < FMAX; ++c) {
    x[c] = c < F ? SCALE * fb[KN ? (size_t)c * N + n : (size_t)n * F + c] : 0.f;
  }
  float4* r = reinterpret_cast<float4*>(rec + p * REC);
  r[0] = make_float4(x[0], x[1], x[2], x[3]);
  r[1] = make_float4(x[4], x[5], dot6(x, x), 0.f);
}

__device__ __forceinline__ void load_rec(const float* r, float (&x)[FMAX],
                                         float& n) {
  const float4 a = *reinterpret_cast<const float4*>(r);
  const float4 c = *reinterpret_cast<const float4*>(r + 4);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = c.x;
  x[5] = c.y;
  n = c.z;
}

// Stage the records of the column tile from c0 into dc [TILE][REC] and its
// K rows of u into du (row stride us); columns past N (nc) are zero-filled.
template <int K, bool KN>
__device__ __forceinline__ void stage_columns(
    float* dc, float* du, int us, const float* recb, const float* ub, int c0,
    int nc, int N, int vec, int tid, int nth) {
  for (int e = tid; e < TILE * 2; e += nth) {
    const int j = e >> 1;
    const bool in = j < nc;
    cp_async16(dc + e * 4, recb + (in ? (size_t)(c0 + j) * REC + (e & 1) * 4 : 0),
               in ? 16 : 0);
  }
  if (KN && vec) {
    constexpr int CH = TILE / 4;
    for (int e = tid; e < K * CH; e += nth) {
      const int k = e / CH, j = (e - k * CH) * 4;
      const float* src = ub + (size_t)k * N;
      const bool in = j < nc;
      cp_async16(du + k * us + j, in ? src + c0 + j : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < K * TILE; e += nth) {
      const int k = e / TILE, j = e - k * TILE, p = c0 + j;
      const bool in = j < nc;
      cp_async4(du + k * us + j,
                in ? ub + (KN ? (size_t)k * N + p : (size_t)p * K + k) : ub,
                in ? 4 : 0);
    }
  }
}

// Where item `item` of row tile (b, it) puts the sum of (local row r,
// class k): out directly when it is its row tile's only item, else its
// partial in the workspace.
template <int K, bool KN>
__device__ __forceinline__ void put(float* out, float* ws, bool direct,
                                    int item, int b, int it, int r, int k,
                                    int N, float v) {
  const int row = it * TILE + r;
  if (row >= N) return;
  if (direct) {
    out[KN ? ((size_t)b * K + k) * N + row : ((size_t)b * N + row) * K + k] = v;
  } else {
    ws[((size_t)item * K + k) * TILE + r] = v;
  }
}

// The FP32 apply (K < TC_MIN_K): a thread owns rows tid + i THREADS; its
// records and K sums stay in registers. Each broadcast load of a column's
// record serves R rows, each float4 of u four columns.
template <int K, bool KN>
__global__ void __launch_bounds__(THREADS) affinity_items_kernel(
    const float* __restrict__ rec, const float* __restrict__ u,
    const int* __restrict__ cols, const int* __restrict__ item_start,
    const int* __restrict__ item_row, const int* __restrict__ row_items,
    int N, int nt, int vec, float* __restrict__ out, float* __restrict__ ws) {
  __shared__ __align__(16) float s_c[2][TILE * REC];
  __shared__ __align__(16) float s_u[2][K * TILE];

  const int item = blockIdx.x, tid = threadIdx.x;
  const int rid = item_row[item];
  const int b = rid / nt, it = rid - b * nt;
  const bool direct = row_items[rid + 1] - row_items[rid] == 1;
  const int t0 = item_start[item];
  const int ntiles = item_start[item + 1] - t0;
  const float* recb = rec + (size_t)b * N * REC;
  const float* ub = u + (size_t)b * N * K;

  float rf[ROWS][FMAX], rn[ROWS], acc[ROWS][K];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = min(it * TILE + tid + i * THREADS, N - 1);
    load_rec(recb + (size_t)row * REC, rf[i], rn[i]);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[i][k] = 0.f;
  }

  // column tile g of the item into buffer g & 1
  auto load = [&](int g) {
    const int c0 = cols[t0 + g] * TILE;
    stage_columns<K, KN>(s_c[g & 1], s_u[g & 1], TILE, recb, ub, c0,
                         min(TILE, N - c0), N, vec, tid, THREADS);
  };
  if (ntiles > 0) load(0);
  cp_async_commit();
  for (int g = 0; g < ntiles; ++g) {
    cp_async_wait_all();
    __syncthreads();  // tile g landed; every thread is done with g - 1
    if (g + 1 < ntiles) load(g + 1);
    cp_async_commit();
    const float* sc = s_c[g & 1];
    const float* su = s_u[g & 1];
    const int nc = min(TILE, N - cols[t0 + g] * TILE);
    for (int j = 0; j < nc; j += 4) {  // columns past nc hold u = 0
      float w[ROWS][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float y[FMAX], yn;
        load_rec(sc + (j + q) * REC, y, yn);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) w[i][q] = gauss(rf[i], rn[i], y, yn);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 uv = *reinterpret_cast<const float4*>(su + k * TILE + j);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          float a = fmaf(w[i][0], uv.x, acc[i][k]);
          a = fmaf(w[i][1], uv.y, a);
          a = fmaf(w[i][2], uv.z, a);
          acc[i][k] = fmaf(w[i][3], uv.w, a);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      put<K, KN>(out, ws, direct, item, b, it, tid + i * THREADS, k, N,
                 acc[i][k]);
    }
  }
}

// The tensor-core apply (K >= TC_MIN_K): warp w owns rows 16 TC_M w ..
// 16 TC_M (w + 1) - 1 as TC_M m-tiles of 16. Each k-step of 8 columns, lane
// (g = lane / 4, t = lane % 4) computes the affinities of its A fragment
// (rows g and g + 8 of each m-tile, columns t and t + 4) on the FP32 pipe
// as above, splits them and its B fragment of u (columns t and t + 4,
// class g of each 8) into TF32 hi + lo, and issues lo.hi + hi.lo + hi.hi
// per (m-tile, 8 classes): each product is exact, and the dropped lo.lo
// and the truncation of both lo's are below 3 x 2^-20 (2.9e-6) of w |u|, so
// the apply keeps f32-level error (single TF32 would put ~5e-4 on every
// matvec, ROADMAP C1).
template <int K, bool KN>
__global__ void __launch_bounds__(TC_WARPS * 32) affinity_items_tc_kernel(
    const float* __restrict__ rec, const float* __restrict__ u,
    const int* __restrict__ cols, const int* __restrict__ item_start,
    const int* __restrict__ item_row, const int* __restrict__ row_items,
    int N, int nt, int vec, float* __restrict__ out, float* __restrict__ ws) {
  constexpr int NT = (K + 7) / 8;  // 8-class n-tiles
  constexpr int NTH = TC_WARPS * 32;
  __shared__ __align__(16) float s_c[2][TILE * REC];
  __shared__ __align__(16) float s_u[2][NT * 8 * USTRIDE];

  const int item = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rid = item_row[item];
  const int b = rid / nt, it = rid - b * nt;
  const bool direct = row_items[rid + 1] - row_items[rid] == 1;
  const int t0 = item_start[item];
  const int ntiles = item_start[item + 1] - t0;
  const float* recb = rec + (size_t)b * N * REC;
  const float* ub = u + (size_t)b * N * K;

  // local rows 16 (TC_M warp + mi) + g + 8 h
  float rf[TC_M][2][FMAX], rn[TC_M][2], acc[TC_M][NT][4];
#pragma unroll
  for (int mi = 0; mi < TC_M; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row =
          min(it * TILE + 16 * (TC_M * warp + mi) + g + 8 * h, N - 1);
      load_rec(recb + (size_t)row * REC, rf[mi][h], rn[mi][h]);
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nn][e] = 0.f;
    }
  }
  // class rows past K are never copied
  for (int e = K * USTRIDE + tid; e < NT * 8 * USTRIDE; e += NTH) {
    s_u[0][e] = s_u[1][e] = 0.f;
  }

  auto load = [&](int gs) {
    const int c0 = cols[t0 + gs] * TILE;
    stage_columns<K, KN>(s_c[gs & 1], s_u[gs & 1], USTRIDE, recb, ub, c0,
                         min(TILE, N - c0), N, vec, tid, NTH);
  };
  if (ntiles > 0) load(0);
  cp_async_commit();
  for (int gs = 0; gs < ntiles; ++gs) {
    cp_async_wait_all();
    __syncthreads();  // tile gs landed; every thread is done with gs - 1
    if (gs + 1 < ntiles) load(gs + 1);
    cp_async_commit();
    const float* sc = s_c[gs & 1];
    const float* su = s_u[gs & 1];
    const int nc = min(TILE, N - cols[t0 + gs] * TILE);
    for (int kb = 0; kb < nc; kb += 8) {  // a k-step: the warp stays converged
      const int j = kb + t;               // columns j and j + 4
      float y[2][FMAX], yn[2];
      load_rec(sc + j * REC, y[0], yn[0]);
      load_rec(sc + (j + 4) * REC, y[1], yn[1]);
      uint32_t ah[TC_M][4], al[TC_M][4];
#pragma unroll
      for (int mi = 0; mi < TC_M; ++mi) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a_e: row g + 8 (e & 1), column j + 4 (e >> 1)
          const int h = e & 1, q = e >> 1;
          split_tf32(gauss(rf[mi][h], rn[mi][h], y[q], yn[q]), ah[mi][e],
                     al[mi][e]);
        }
      }
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(su[(nn * 8 + g) * USTRIDE + j], bh0, bl0);
        split_tf32(su[(nn * 8 + g) * USTRIDE + j + 4], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < TC_M; ++mi) {
          mma_tf32(acc[mi][nn], al[mi], bh0, bh1);
          mma_tf32(acc[mi][nn], ah[mi], bl0, bl1);
          mma_tf32(acc[mi][nn], ah[mi], bh0, bh1);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < TC_M; ++mi) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // c_e: row g + 8 (e >> 1), class 2t + (e & 1)
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        const int k = nn * 8 + 2 * t + (e & 1);
        if (k < K) {
          put<K, KN>(out, ws, direct, item, b, it,
                     16 * (TC_M * warp + mi) + g + 8 * (e >> 1), k, N,
                     acc[mi][nn][e]);
        }
      }
    }
  }
}

// out of a row tile with two or more items, class blockIdx.y: its items'
// partials added in item (segment) order
template <bool KN>
__global__ void __launch_bounds__(TILE) affinity_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ row_items, int N,
    int K, int nt, float* __restrict__ out) {
  const int rid = blockIdx.x, k = blockIdx.y, r = threadIdx.x;
  const int first = row_items[rid], nseg = row_items[rid + 1] - first;
  const int b = rid / nt, row = (rid - b * nt) * TILE + r;
  if (nseg < 2 || row >= N) return;
  const size_t step = (size_t)K * TILE;
  const float* p = ws + ((size_t)first * K + k) * TILE + r;
  float s = p[0];
#pragma unroll 8
  for (int q = 1; q < nseg; ++q) s += p[q * step];
  out[KN ? ((size_t)b * K + k) * N + row : ((size_t)b * N + row) * K + k] = s;
}

template <bool KN>
cudaError_t launch(const float* feat, const float* u, const int* cols,
                   const int* item_start, const int* item_row,
                   const int* row_items, int n_items, int B, int N, int F,
                   int K, float* rec, float* ws, float* out, cudaStream_t st) {
  const int nt = (N + TILE - 1) / TILE;
  const long long total = (long long)B * N;
  affinity_prep_kernel<KN><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      feat, total, N, F, rec);
  const int vec = KN && N % 4 == 0 && (uintptr_t)u % 16 == 0;
  switch (K) {
#define AFFINITY_CASE(k)                                                    \
  case k:                                                                   \
    if constexpr (k >= TC_MIN_K) {                                          \
      affinity_items_tc_kernel<k, KN><<<n_items, TC_WARPS * 32, 0, st>>>(   \
          rec, u, cols, item_start, item_row, row_items, N, nt, vec, out,   \
          ws);                                                              \
    } else {                                                                \
      affinity_items_kernel<k, KN><<<n_items, THREADS, 0, st>>>(            \
          rec, u, cols, item_start, item_row, row_items, N, nt, vec, out,   \
          ws);                                                              \
    }                                                                       \
    break;
    AFFINITY_CASE(1) AFFINITY_CASE(2) AFFINITY_CASE(3) AFFINITY_CASE(4)
    AFFINITY_CASE(5) AFFINITY_CASE(6) AFFINITY_CASE(7) AFFINITY_CASE(8)
    AFFINITY_CASE(9) AFFINITY_CASE(10) AFFINITY_CASE(11) AFFINITY_CASE(12)
    AFFINITY_CASE(13) AFFINITY_CASE(14) AFFINITY_CASE(15) AFFINITY_CASE(16)
#undef AFFINITY_CASE
    default:
      return cudaErrorInvalidValue;
  }
  affinity_combine_kernel<KN><<<dim3(B * nt, K), TILE, 0, st>>>(
      ws, row_items, N, K, nt, out);
  return cudaGetLastError();
}

}  // namespace

// kn=1: feat [B,F,N], u and out [B,K,N]; kn=0: feat [B,N,F], u and out
// [B,N,K]; f32, contiguous. The plan (ops/affinity.py::tile_plan, int32):
// cols [T] kept column tiles by row tile, item_start [n_items + 1] (item i
// sums cols[item_start[i]:item_start[i + 1]]), item_row [n_items] (b * nt +
// row tile), row_items [B * nt + 1] (a row tile's first item), nt =
// ceil(N / 128), every row tile one item or more. Scratch: rec [B, N, 8]
// (16-byte aligned), ws [n_items, K, 128]. 1 <= F <= 6, 1 <= K <= 16.
// Returns a cudaError_t.
extern "C" int affinity_matvec_launch(const void* feat, const void* u,
                                      const void* cols, const void* item_start,
                                      const void* item_row,
                                      const void* row_items, int n_items,
                                      int B, int N, int F, int K, int kn,
                                      void* rec, void* ws, void* out,
                                      void* stream) {
  if (F < 1 || F > FMAX || K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  if (n_items < B || (uintptr_t)rec % 16 != 0) return (int)cudaErrorInvalidValue;
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  const auto* f = (const float*)feat;
  const auto* uu = (const float*)u;
  const auto* c = (const int*)cols;
  const auto* is = (const int*)item_start;
  const auto* ir = (const int*)item_row;
  const auto* ri = (const int*)row_items;
  return (int)(kn ? launch<true>(f, uu, c, is, ir, ri, n_items, B, N, F, K,
                                 (float*)rec, (float*)ws, (float*)out, st)
                  : launch<false>(f, uu, c, is, ir, ri, n_items, B, N, F, K,
                                  (float*)rec, (float*)ws, (float*)out, st));
}
