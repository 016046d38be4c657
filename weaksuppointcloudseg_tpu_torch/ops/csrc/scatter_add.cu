// Kernel B13: out[b, idx[b,p,j], :] += g[b,p,j,:], the backward of the
// neighbour gather, as a gather-sum over the inverse graph; and the
// inverse graph itself, which B4 (scatter_bn.cu) and B6's scatter
// (scatter_w.cu) sum over too.
//
// Replaces weaksuppointcloudseg_tpu/ops/scatter_pallas.py::scatter_add_pallas
// (body _scatter_kernel), which builds one-hot tiles and sums with MXU
// matmuls because a TPU has no scattered atomic adds. That sums in a fixed
// order; so does this kernel, without atomics.
//
// What bounds it on an H100: the bytes. At B=64, P=N=2048, k=20, C=64 the
// cotangent g is 671 MB of f32 and idx 10.5 MB, read once; out is 33.5 MB,
// written once: 0.21 ms at 3.35 TB/s (C=3: 0.013 ms). The inverse alone
// reads idx and writes offsets and src once: 21 MB, 0.0064 ms.
//
// Design:
// 1. The inverse graph: offsets [B, N+1] and src [B, P*k] (flat slots
//    p*k + j, ascending within each destination's segment; past
//    offsets[b, N], the skipped slots' places hold -1), a counting sort
//    made stable. Two routes, chosen by shape alone (inverse_graph_route,
//    mirrored by ops/scatter.py::inverse_route):
//    (a) the cluster build, one launch: one thread-block cluster of
//        CLUSTER = 8 blocks (the portable size) per cloud, CLUSTER_WARPS =
//        8 warps a block (inverse_cluster_kernel). Block r is the source
//        of slots [r*SEG, (r+1)*SEG) and the owner of rows [r*RPO,
//        (r+1)*RPO) and of CSR places [r*SEG, (r+1)*SEG), SEG =
//        ceil(P*k / 8), RPO = ceil(N / 8): the places, not the rows, are
//        split evenly, so a hub row costs its owner nothing extra. Passes,
//        with a cluster barrier after each: (1) each warp counts its
//        contiguous piece of the block's slots into its own 16-bit
//        counters, two warps to a word (int atomics: exact counts; a
//        block's slots, fewer than 65,536, bound each), and the block sums
//        them per row; (2) each owner reads its rows' counts from every
//        source block through distributed shared memory, in source-block
//        order, and scans them; (3) with the earlier owners' totals
//        carried, it writes the rows' offsets and each source block's
//        cursor per row back into that block's shared memory; (4) each
//        block turns its counters into each warp's cursor relative to the
//        block's, and each warp walks its piece in order, 32 slots at a
//        time: a shared atomic gives each lane a place, which is the
//        stable one unless two lanes share a target; only then are the
//        lanes ranked, one ballot per bit of the target; the slot is
//        stored into the owner's segment through distributed shared
//        memory. (5) Each owner writes its offsets and its places to
//        global memory in full lines. So idx is read once and offsets and
//        src written once, coalesced; no global workspace. Shared memory
//        a block, in ints: 4 N counter words, N block counts (then
//        cursors), SEG places, RPO offsets and 36 for the scan: 4 ((4 + 1)
//        N + SEG + RPO + 36) bytes, at most 227 KB. ShapeNet (N=2048,
//        k=20; SEG 5,120): 62,608 B, three blocks an SM. S3DIS (N=4096,
//        k=10: 104,592 B, two an SM; k=20, B4's graph, SEG 10,240:
//        125,072 B, one). The classifier (N=1024, k=20): 31,376 B. Larger
//        graphs (P = N past 7,616 rows at k=20, 9,109 at k=10) take (b). Where a block's time
//        goes: scripts/torch_inverse_phases.py.
//    (b) the three-launch build, up to N = 58,112 rows (a row
//        count of ints in shared memory): each cloud's slots are cut into
//        chunks of INV_CHUNK; inverse_count_kernel counts each chunk's
//        targets into a [B, chunks, N] global workspace;
//        inverse_scan_kernel, one block per cloud, turns the counts into
//        the rows' offsets and each chunk's cursor per row;
//        inverse_place_kernel recounts its chunk per warp and places as
//        (4) does, into src in global memory: each 4-byte store lands at
//        a random place and is an L2 transaction of its own (about 0.06
//        ms at B=64, N=2048, k=20 on an H100, scripts/
//        torch_scatter_profile.py).
//    Both give the same offsets and src bit for bit. Targets outside
//    [0, N) are skipped.
// 2. csr_gather (csr_gather.cuh): each destination row sums its segment in
//    order in f32 and is written once: bit for bit the plain version's
//    index_add_ on the CPU, and the same on every launch. At C=64 a warp
//    takes a row (two channels a lane, 128-byte loads of each source row);
//    at C=3 a lane takes a row, 32 rows a warp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_gather.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int INV_CHUNK = 4096;  // slots of a count or place block
constexpr int INV_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_PLACE_WARPS = 8;
constexpr int PREFETCH = 4;  // slot loads a thread keeps in flight
constexpr int CLUSTER = 8;   // blocks of a cloud's cluster (portable size)
constexpr int CLUSTER_WARPS = 8;  // warps of each block, two to a counter word
constexpr size_t SMEM_CAP = 227 * 1024;  // shared memory a block can use

// the lanes whose key equals this lane's (keys below 2^16): one ballot per
// key bit, what __match_any_sync computes, with the ballots independent of
// each other so that they run back to back
__device__ __forceinline__ unsigned same_key_lanes(int key) {
  unsigned grp = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit < 16; ++bit) {
    const bool on = (key >> bit) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, on);
    grp &= on ? set : ~set;
  }
  return grp;
}

// A warp's cursors per target row: plain ints (the three-launch build:
// absolute places), or 16-bit halves of words two warps share (the cluster
// build: places relative to the block's cursor of the row, base[t]; a
// block's slots, fewer than 65,536, bound every half). Counting adds to
// the word with an int atomic; placing reads and writes the warp's own
// half with 16-bit loads and stores, which leave the other half alone.
struct IntCursors {
  int* c;
  __device__ __forceinline__ void count(int t) const { atomicAdd(&c[t], 1); }
  __device__ __forceinline__ int get(int t) const { return c[t]; }
  __device__ __forceinline__ void set(int t, int v) const { c[t] = v; }
  __device__ __forceinline__ int base(int) const { return 0; }
};

struct HalfCursors {
  unsigned* w;      // [N] words; this warp's half is half h of each
  const int* b;     // [N] the block's cursor per row
  int h;
  __device__ __forceinline__ void count(int t) const {
    atomicAdd(&w[t], 1u << (16 * h));
  }
  __device__ __forceinline__ int get(int t) const {
    return reinterpret_cast<const unsigned short*>(w + t)[h];
  }
  __device__ __forceinline__ void set(int t, int v) const {
    reinterpret_cast<unsigned short*>(w + t)[h] = (unsigned short)v;
  }
  __device__ __forceinline__ int base(int t) const { return b[t]; }
};

// one warp's piece [s0, s1) of a cloud's slots ib, counted per target row
// into the warp's cursors (shared-memory int atomics: exact counts)
template <class Cur>
__device__ __forceinline__ void count_piece(const int32_t* __restrict__ ib,
                                            int s0, int s1, int N, int lane,
                                            Cur cur) {
  for (int s = s0 + lane; s < s1; s += 32 * PREFETCH) {
    int t[PREFETCH];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int q = s + 32 * u;
      t[u] = q < s1 ? ib[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      if ((unsigned)t[u] < (unsigned)N) cur.count(t[u]);
    }
  }
}

// one warp's piece [s0, s1), in order, 32 slots at a time: each kept slot
// sl goes to store(place, sl), its place the warp's cursor of its target
// plus its rank among the earlier slots of the piece with that target.
// Each step reads the cursors, then every lane writes its lane id at its
// target and reads it back: where every lane reads its own, no two lanes
// share a target, and each moves its cursor by one. Only where lanes
// collide are they ranked, one ballot per bit of the target, and the last
// of each group moves the cursor past it. Plain shared loads and stores.
template <class Cur, class Store>
__device__ __forceinline__ void place_piece(const int32_t* __restrict__ ib,
                                            int s0, int s1, int N, int lane,
                                            Cur cur, Store store) {
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
  for (int s = s0; s < s1; s += 32 * PREFETCH) {
    int t[PREFETCH];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int q = s + 32 * u + lane;
      t[u] = q < s1 ? ib[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const bool ok = (unsigned)t[u] < (unsigned)N;
      int pos = ok ? cur.get(t[u]) : 0;
      __syncwarp();  // every lane has read its cursor
      if (ok) cur.set(t[u], lane);
      __syncwarp();
      const bool alone = !ok || cur.get(t[u]) == lane;
      int next = pos + 1;
      if (__ballot_sync(0xffffffffu, !alone)) {
        // lanes share a target: rank every lane among those with its key
        // (N for a skipped slot); the last of a group moves the cursor
        const unsigned grp = same_key_lanes(ok ? t[u] : N);
        next = (grp >> lane) == 1u ? pos + __popc(grp) : -1;
        pos += __popc(grp & lower);
      }
      __syncwarp();  // every lane has read the ids
      if (ok && next >= 0) cur.set(t[u], next);
      __syncwarp();  // the cursors have moved before the next step reads
      if (ok) store(cur.base(t[u]) + pos, s + 32 * u + lane);
    }
  }
}

// ---------------------------------------------- (a) the cluster build

// words of per-warp cursors, two warps a word
constexpr int CLUSTER_WORDS = (CLUSTER_WARPS + 1) / 2;

// the scan's warp sums and four scalars
constexpr int CLUSTER_MISC = 32 + 4;

// shared memory of a block of the cluster build, in ints: the warps'
// cursor words [CLUSTER_WORDS][N], the block's counts [N], its places
// [SEG], its rows' offsets [RPO] and CLUSTER_MISC (the kernel has no
// static shared memory: this is all it takes)
__host__ __device__ inline long long cluster_ints(long long S, long long N) {
  const long long seg = S > CLUSTER ? (S + CLUSTER - 1) / CLUSTER : 1;
  return (CLUSTER_WORDS + 1) * N + seg + (N + CLUSTER - 1) / CLUSTER +
         CLUSTER_MISC;
}

// one cluster per cloud b = blockIdx.y, block rank r = blockIdx.x (header,
// design 1a)
__global__ void __launch_bounds__(32 * CLUSTER_WARPS)
inverse_cluster_kernel(const int32_t* __restrict__ idx, int S, int N,
                       int32_t* __restrict__ offsets,
                       int32_t* __restrict__ src) {
  constexpr int W = CLUSTER_WARPS, T = 32 * W, WORDS = CLUSTER_WORDS;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int sh[];
  const int seg_len = S > CLUSTER ? (S + CLUSTER - 1) / CLUSTER : 1;
  const int rpo = (N + CLUSTER - 1) / CLUSTER;
  // [WORDS][N] the warps' counts, then their cursors relative to the
  // block's, warp w in the half at bit 16 (w & 1) of word w / 2
  unsigned* cur = reinterpret_cast<unsigned*>(sh);
  int* tot = sh + WORDS * N; // [N] the block's counts, then its cursors
  int* seg = tot + N;        // [seg_len] the places this block owns
  int* offs = seg + seg_len; // [rpo] the offsets of the rows it owns
  int* wsum = offs + rpo;    // [32] the scan's warp sums
  int& round_sh = wsum[32];  // a scan round's total
  int& owner_total = wsum[33];  // the places of the rows this block owns
  int& base_sh = wsum[34];   // the places of the earlier owners' rows
  int& total_sh = wsum[35];  // the cloud's kept slots
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* ib = idx + (size_t)b * S;

  for (int e = threadIdx.x; e < (WORDS + 1) * N; e += T) sh[e] = 0;
  __syncthreads();
  // (1) the block's source slots [c0, c1), warp w's piece [s0, s1)
  const int c0 = min(S, r * seg_len), c1 = min(S, c0 + seg_len);
  const int per = (c1 - c0 + W - 1) / W;
  const int s0 = min(c1, c0 + warp * per), s1 = min(c1, s0 + per);
  const HalfCursors mine{cur + (warp >> 1) * N, tot, warp & 1};
  count_piece(ib, s0, s1, N, lane, mine);
  __syncthreads();
  for (int t = threadIdx.x; t < N; t += T) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const unsigned v = cur[j * N + t];
      c += (int)(v & 0xffffu) + (int)(v >> 16);
    }
    tot[t] = c;
  }
  cluster.sync();  // every block's counts are in (and every block runs)

  // (2) the owned rows [r0, r1): in-degrees over the source blocks in
  // order, scanned in rounds of T rows
  const int r0 = min(N, r * rpo), r1 = min(N, r0 + rpo);
  int carry = 0;
  for (int t0 = r0; t0 < r1; t0 += T) {
    const int t = t0 + threadIdx.x;
    int deg = 0;
    if (t < r1) {
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) deg += cluster.map_shared_rank(tot, q)[t];
    }
    int incl = deg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < W ? wsum[lane] : 0;
      int vi = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, vi, off);
        if (lane >= off) vi += o;
      }
      if (lane < W) wsum[lane] = vi - v;  // exclusive
      if (lane == 31) round_sh = vi;      // the round's total
    }
    __syncthreads();
    if (t < r1) offs[t - r0] = carry + wsum[warp] + incl - deg;
    carry += round_sh;
    __syncthreads();  // wsum and round_sh are read before the next round
  }
  if (threadIdx.x == 0) owner_total = carry;
  cluster.sync();  // every owner's total is in

  // (3) the earlier owners' totals carried: the owned rows' offsets, and
  // each source block's cursor per owned row written into its counts
  if (threadIdx.x == 0) {
    int base = 0, total = 0;
    for (int q = 0; q < CLUSTER; ++q) {
      const int v = *cluster.map_shared_rank(&owner_total, q);
      base += q < r ? v : 0;
      total += v;
    }
    base_sh = base;
    total_sh = total;
  }
  __syncthreads();
  const int total = total_sh;
  for (int t = r0 + threadIdx.x; t < r1; t += T) {
    int run = base_sh + offs[t - r0];
    offs[t - r0] = run;
    int v[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) v[q] = cluster.map_shared_rank(tot, q)[t];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      cluster.map_shared_rank(tot, q)[t] = run;
      run += v[q];
    }
  }
  cluster.sync();  // every block's cursors are in

  // (4) the warps' cursors relative to the block's (the earlier warps'
  // counts of the row); each slot stored at its place, in the owner's
  // segment
  for (int t = threadIdx.x; t < N; t += T) {
    unsigned run = 0;
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const unsigned v = cur[j * N + t], lo = v & 0xffffu;
      cur[j * N + t] = run | ((run + lo) << 16);
      run += lo + (v >> 16);
    }
  }
  __syncthreads();
  place_piece(ib, s0, s1, N, lane, mine, [&](int pos, int sl) {
    const int o = pos / seg_len;
    cluster.map_shared_rank(seg, o)[pos - o * seg_len] = sl;
  });
  cluster.sync();  // every place is filled

  // (5) the owned places (-1 past the last kept slot) and rows' offsets
  int32_t* sb = src + (size_t)b * S;
  for (int i = threadIdx.x; i < seg_len; i += T) {
    const int pos = r * seg_len + i;
    if (pos < S) sb[pos] = pos < total ? seg[i] : -1;
  }
  int32_t* ob = offsets + (size_t)b * (N + 1);
  for (int t = r0 + threadIdx.x; t < r1; t += T) ob[t] = offs[t - r0];
  if (r == 0 && threadIdx.x == 0) ob[N] = total;
}

// ------------------------------------------- (b) the three-launch build

// (b1) cnt[b, c, t] = the slots of chunk c of cloud b that target row t
__global__ void __launch_bounds__(INV_THREADS) inverse_count_kernel(
    const int32_t* __restrict__ idx, int S, int N, int32_t* __restrict__ cnt) {
  extern __shared__ int hist[];  // [N]
  const int c = blockIdx.x, b = blockIdx.y, nch = gridDim.x;
  for (int t = threadIdx.x; t < N; t += INV_THREADS) hist[t] = 0;
  __syncthreads();
  const int s0 = c * INV_CHUNK, s1 = min(S, s0 + INV_CHUNK);
  const int32_t* ib = idx + (size_t)b * S;
  for (int s = s0 + threadIdx.x; s < s1; s += PREFETCH * INV_THREADS) {
    int t[PREFETCH];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int q = s + u * INV_THREADS;
      t[u] = q < s1 ? ib[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      if ((unsigned)t[u] < (unsigned)N) atomicAdd(&hist[t[u]], 1);
    }
  }
  __syncthreads();
  int32_t* out = cnt + ((size_t)b * nch + c) * N;
  for (int t = threadIdx.x; t < N; t += INV_THREADS) out[t] = hist[t];
}
// (b2) offsets of cloud b's rows, each chunk's cursors (in place of its
// counts), and -1 in src past the last kept slot
__global__ void __launch_bounds__(SCAN_THREADS) inverse_scan_kernel(
    int S, int N, int nch, int32_t* __restrict__ cnt,
    int32_t* __restrict__ offsets, int32_t* __restrict__ src) {
  __shared__ int wsum[SCAN_THREADS / 32];
  __shared__ int carry_sh;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* cb = cnt + (size_t)b * nch * N;
  int32_t* ob = offsets + (size_t)b * (N + 1);
  int carry = 0;  // the kept slots of the rows before this round
  for (int t0 = 0; t0 < N; t0 += SCAN_THREADS) {
    const int t = t0 + threadIdx.x;
    int deg = 0;
    if (t < N) {
      for (int c = 0; c < nch; ++c) deg += cb[(size_t)c * N + t];
    }
    int incl = deg;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = wsum[lane];  // SCAN_THREADS / 32 == 32 warps
      int vi = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, vi, off);
        if (lane >= off) vi += o;
      }
      wsum[lane] = vi - v;  // exclusive
      if (lane == 31) carry_sh = vi;  // the round's total
    }
    __syncthreads();
    if (t < N) {
      int run = carry + wsum[warp] + incl - deg;
      ob[t] = run;
      for (int c = 0; c < nch; ++c) {
        const int v = cb[(size_t)c * N + t];
        cb[(size_t)c * N + t] = run;
        run += v;
      }
    }
    carry += carry_sh;
    __syncthreads();  // wsum and carry_sh are read before the next round
  }
  if (threadIdx.x == 0) ob[N] = carry;
  int32_t* sb = src + (size_t)b * S;
  for (int q = carry + threadIdx.x; q < S; q += SCAN_THREADS) sb[q] = -1;
}

// (b3) stable placement of chunk c of cloud b at the cursors of (b2)
__global__ void __launch_bounds__(32 * MAX_PLACE_WARPS) inverse_place_kernel(
    const int32_t* __restrict__ idx, int S, int N,
    const int32_t* __restrict__ cursors, int32_t* __restrict__ src) {
  extern __shared__ int cur[];  // [W][N]
  const int W = blockDim.x / 32, T = blockDim.x;
  const int c = blockIdx.x, b = blockIdx.y, nch = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < W * N; e += T) cur[e] = 0;
  __syncthreads();
  const int c0 = c * INV_CHUNK, c1 = min(S, c0 + INV_CHUNK);
  const int per = (c1 - c0 + W - 1) / W;
  const int s0 = min(c1, c0 + warp * per), s1 = min(c1, s0 + per);
  const int32_t* ib = idx + (size_t)b * S;
  const IntCursors mine{cur + warp * N};
  count_piece(ib, s0, s1, N, lane, mine);
  __syncthreads();
  // the warps' cursors: row t's run starts at the chunk's cursor and takes
  // the warps in order
  const int32_t* base = cursors + ((size_t)b * nch + c) * N;
  for (int t = threadIdx.x; t < N; t += T) {
    int run = base[t];
    for (int w = 0; w < W; ++w) {
      const int v = cur[w * N + t];
      cur[w * N + t] = run;
      run += v;
    }
  }
  __syncthreads();
  int32_t* sb = src + (size_t)b * S;
  place_piece(ib, s0, s1, N, lane, mine,
              [&](int pos, int sl) { sb[pos] = sl; });
}

// the three-launch build's place warps: as many as shared memory holds, at
// most MAX_PLACE_WARPS
int place_warps(int N) {
  int W = MAX_PLACE_WARPS;
  while (W > 1 && 4 * (size_t)W * N > SMEM_CAP) --W;
  return W;
}

cudaError_t launch_cluster(const int32_t* idx, int B, int S, int N,
                           int32_t* offsets, int32_t* src, size_t smem,
                           cudaStream_t s) {
  // raise the kernel's shared-memory limit once, to what any launch so far
  // needed (a call costs host time on every launch otherwise)
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        inverse_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess) {  // as many blocks an SM as shared memory holds
      err = cudaFuncSetAttribute(inverse_cluster_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, B, 1);
  cfg.blockDim = dim3(32 * CLUSTER_WARPS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, inverse_cluster_kernel, idx, S, N, offsets,
                            src);
}

cudaError_t launch_chunks(const int32_t* idx, int B, int S, int N,
                          int32_t* offsets, int32_t* src, int32_t* work,
                          cudaStream_t s) {
  const int nch = (S + INV_CHUNK - 1) / INV_CHUNK;
  const size_t hist_smem = 4 * (size_t)N;
  const int W = place_warps(N);
  const size_t place_smem = 4 * (size_t)W * N;
  // the kernels' shared-memory limits, raised once as in launch_cluster
  static size_t hist_set = 0, place_set = 0;
  cudaError_t err = cudaSuccess;
  if (hist_smem > hist_set) {
    err = cudaFuncSetAttribute(inverse_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hist_smem);
    if (err != cudaSuccess) return err;
    hist_set = hist_smem;
  }
  if (place_smem > place_set) {
    err = cudaFuncSetAttribute(inverse_place_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)place_smem);
    if (err == cudaSuccess) {  // as many blocks an SM as shared memory holds
      err = cudaFuncSetAttribute(inverse_place_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    place_set = place_smem;
  }
  if (nch > 0) {
    inverse_count_kernel<<<dim3(nch, B), INV_THREADS, hist_smem, s>>>(
        idx, S, N, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  inverse_scan_kernel<<<B, SCAN_THREADS, 0, s>>>(S, N, nch, work, offsets, src);
  err = cudaGetLastError();
  if (err != cudaSuccess || nch == 0) return err;
  inverse_place_kernel<<<dim3(nch, B), 32 * W, place_smem, s>>>(
      idx, S, N, work, src);
  return cudaGetLastError();
}

}  // namespace

// The build's route for a [B, P, k] graph with N rows (header, design 1),
// by shape alone: 1 the cluster build, where a block's shared memory
// (4 ((8 + 1) N + ceil(P k / 8) + ceil(N / 8)) bytes) fits in 227 KB; else
// 2 the three-launch build, where a row count of ints fits (N <= 58,112);
// else 0 (no route). *smem: the bytes of shared memory of the route's
// largest block; *work: the int32 workspace it needs per cloud (0 for the
// cluster build).
extern "C" int inverse_graph_route(int P, int k, int N, long long* smem,
                                   long long* work) {
  const long long S = (long long)P * k;
  *smem = 0;
  *work = 0;
  if (P < 0 || k < 0 || N < 1 || S >= (1LL << 31)) return 0;
  const long long cluster = 4 * cluster_ints(S, N);
  if (cluster <= (long long)SMEM_CAP) {
    *smem = cluster;
    return 1;
  }
  if (4 * (long long)N > (long long)SMEM_CAP) return 0;
  *smem = 4LL * place_warps(N) * N;
  *work = (S + INV_CHUNK - 1) / INV_CHUNK * N;
  return 2;
}

// idx [B,P,k] int32 -> offsets [B,N+1] int32, src [B,P*k] int32 (see the
// header) by the cluster build; cudaErrorInvalidValue where its shared
// memory does not fit (route 1 above).
extern "C" int inverse_graph_cluster_launch(const void* idx, int B, int P,
                                            int k, int N, void* offsets,
                                            void* src, void* stream) {
  long long smem = 0, work = 0;
  if (B < 1 || B > 65535 || inverse_graph_route(P, k, N, &smem, &work) != 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_cluster((const int32_t*)idx, B, P * k, N,
                             (int32_t*)offsets, (int32_t*)src, (size_t)smem,
                             reinterpret_cast<cudaStream_t>(stream));
}

// The same by the three-launch build, at any shape it takes (N up to
// 58,112), with work: int32 scratch of work_elems >= B * ceil(P*k /
// INV_CHUNK) * N.
extern "C" int inverse_graph_chunks_launch(const void* idx, int B, int P,
                                           int k, int N, void* offsets,
                                           void* src, void* work,
                                           long long work_elems,
                                           void* stream) {
  const long long S = (long long)P * k;
  const long long nch = (S + INV_CHUNK - 1) / INV_CHUNK;
  if (B < 1 || B > 65535 || P < 0 || k < 0 || N < 1 || S >= (1LL << 31) ||
      4 * (size_t)N > SMEM_CAP || work_elems < B * nch * N) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_chunks((const int32_t*)idx, B, (int)S, N,
                            (int32_t*)offsets, (int32_t*)src, (int32_t*)work,
                            reinterpret_cast<cudaStream_t>(stream));
}

// The inverse by the route inverse_graph_route picks (work: B times its
// per-cloud workspace, none for the cluster build). Returns a cudaError_t
// (cudaErrorInvalidValue where no route takes the shape).
extern "C" int inverse_graph_launch(const void* idx, int B, int P, int k,
                                    int N, void* offsets, void* src,
                                    void* work, long long work_elems,
                                    void* stream) {
  long long smem = 0, per_cloud = 0;
  const int route = inverse_graph_route(P, k, N, &smem, &per_cloud);
  if (route == 1) {
    return inverse_graph_cluster_launch(idx, B, P, k, N, offsets, src, stream);
  }
  if (route == 2) {
    return inverse_graph_chunks_launch(idx, B, P, k, N, offsets, src, work,
                                       work_elems, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// g [B,P,k,C] f32 summed along the inverse graph of the [B,P,k] graph idx
// into out [B,N,C] f32 (every element written); the inverse is built first
// into offsets and src (work as for inverse_graph_launch). Returns a
// cudaError_t.
extern "C" int scatter_add_launch(const void* g, const void* idx,
                                  void* offsets, void* src, void* work,
                                  long long work_elems, int B, int P, int k,
                                  int N, int C, void* out, void* stream) {
  const int err = inverse_graph_launch(idx, B, P, k, N, offsets, src, work,
                                       work_elems, stream);
  if (err != 0) return err;
  const int S = P * k;
  return (int)csr_gather((const int32_t*)offsets, (const int32_t*)src, B, N,
                         S, C, f32_val((const float*)g, S, C), (float*)out,
                         reinterpret_cast<cudaStream_t>(stream));
}
