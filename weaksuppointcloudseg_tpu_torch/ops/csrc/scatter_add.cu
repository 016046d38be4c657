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
// written once: 0.21 ms at 3.35 TB/s (C=3: 0.013 ms).
//
// Design:
// 1. The inverse graph, in three launches: offsets [B, N+1] and src
//    [B, P*k] (flat slots p*k + j, ascending within each destination's
//    segment; past offsets[b, N], the skipped slots' places hold -1). A
//    counting sort made stable: each cloud's slots are cut into chunks of
//    INV_CHUNK; (a) inverse_count_kernel counts each chunk's targets in
//    shared memory (int atomics: exact counts) into a [B, chunks, N]
//    workspace; (b) inverse_scan_kernel, one block per cloud, turns the
//    counts into the rows' offsets (a block-wide scan over the rows, in
//    rounds of one row a thread) and each chunk's cursor per row (the
//    row's offset plus the counts of the earlier chunks), and marks the
//    tail; (c) inverse_place_kernel recounts its chunk per warp (W
//    contiguous pieces), turns the chunk's cursors into per-warp cursors,
//    and each warp walks its piece in order, 32 slots at a time: a shared
//    atomic gives each lane a place, which is the stable one unless two
//    lanes share a target; only then are the lanes ranked, one ballot per
//    bit of the target. So each segment ascends whatever the in-degree:
//    hubs (an all-equal cloud sends every point to the same k rows) cost
//    nothing extra. Targets outside [0, N) are skipped. At B=64, N=2048,
//    k=20 on an H100 the build takes ~0.06 ms (scripts/
//    torch_scatter_profile.py), most of it the placing stores: each
//    4-byte store lands at a random place and is an L2 transaction of its
//    own. A one-block-per-cloud variant that placed in shared memory and
//    copied out coalesced was no faster.
// 2. csr_gather (csr_gather.cuh): each destination row sums its segment in
//    order in f32 and is written once: bit for bit the plain version's
//    index_add_ on the CPU, and the same on every launch. At C=64 a warp
//    takes a row (two channels a lane, 128-byte loads of each source row);
//    at C=3 a lane takes a row, 32 rows a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_gather.cuh"

namespace {

constexpr int INV_CHUNK = 4096;  // slots of a count or place block
constexpr int INV_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_PLACE_WARPS = 8;
constexpr int PREFETCH = 4;  // slot loads a thread keeps in flight

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

// (a) cnt[b, c, t] = the slots of chunk c of cloud b that target row t
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

// (b) offsets of cloud b's rows, each chunk's cursors (in place of its
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

// (c) stable placement of chunk c of cloud b at the cursors of (b)
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
  int* mine = cur + warp * N;
  for (int s = s0 + lane; s < s1; s += 32 * PREFETCH) {
    int t[PREFETCH];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int q = s + 32 * u;
      t[u] = q < s1 ? ib[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      if ((unsigned)t[u] < (unsigned)N) atomicAdd(&mine[t[u]], 1);
    }
  }
  __syncthreads();
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
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
  int32_t* sb = src + (size_t)b * S;
  for (int s = s0; s < s1; s += 32 * PREFETCH) {
    int t[PREFETCH];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int q = s + 32 * u + lane;
      t[u] = q < s1 ? ib[q] : -1;
    }
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int sl = s + 32 * u + lane;
      const bool ok = (unsigned)t[u] < (unsigned)N;
      // each lane takes a place with a shared atomic; where no other lane
      // has its target, that place is the stable one
      int pos = ok ? atomicAdd(&mine[t[u]], 1) : 0;
      __syncwarp();
      const int after = ok ? mine[t[u]] : 0;  // past every lane's place
      __syncwarp();
      if (__ballot_sync(0xffffffffu, ok && after != pos + 1)) {
        // lanes share a target and took its places in an unknown order:
        // rank every lane among those with its key (N for a skipped slot)
        const unsigned grp = same_key_lanes(ok ? t[u] : N);
        pos = after - __popc(grp) + __popc(grp & lower);
      }
      if (ok) sb[pos] = sl;
    }
  }
}

}  // namespace

// idx [B,P,k] int32 -> offsets [B,N+1] int32, src [B,P*k] int32 (see the
// header); work: int32 scratch of work_elems >= B * ceil(P*k / INV_CHUNK)
// * N. Returns a cudaError_t (cudaErrorInvalidValue when a row count of N
// ints does not fit in shared memory: N > ~58,000).
extern "C" int inverse_graph_launch(const void* idx, int B, int P, int k,
                                    int N, void* offsets, void* src,
                                    void* work, long long work_elems,
                                    void* stream) {
  const int S = P * k;
  const int nch = (S + INV_CHUNK - 1) / INV_CHUNK;
  const size_t limit = 227 * 1024;
  if (B < 1 || B > 65535 || N < 1 || S < 0 || 4 * (size_t)N > limit ||
      work_elems < (long long)B * nch * N) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t hist_smem = 4 * (size_t)N;
  int W = MAX_PLACE_WARPS;
  while (W > 1 && 4 * (size_t)W * N > limit) --W;
  const size_t place_smem = 4 * (size_t)W * N;
  // raise the kernels' shared-memory limits once, to what any launch so far
  // needed (a call costs host time on every launch otherwise)
  static size_t hist_set = 0, place_set = 0;
  cudaError_t err = cudaSuccess;
  if (hist_smem > hist_set) {
    err = cudaFuncSetAttribute(inverse_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hist_smem);
    if (err != cudaSuccess) return (int)err;
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
    if (err != cudaSuccess) return (int)err;
    place_set = place_smem;
  }
  if (nch > 0) {
    inverse_count_kernel<<<dim3(nch, B), INV_THREADS, hist_smem, s>>>(
        (const int32_t*)idx, S, N, (int32_t*)work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  inverse_scan_kernel<<<B, SCAN_THREADS, 0, s>>>(
      S, N, nch, (int32_t*)work, (int32_t*)offsets, (int32_t*)src);
  err = cudaGetLastError();
  if (err != cudaSuccess || nch == 0) return (int)err;
  inverse_place_kernel<<<dim3(nch, B), 32 * W, place_smem, s>>>(
      (const int32_t*)idx, S, N, (const int32_t*)work, (int32_t*)src);
  return (int)cudaGetLastError();
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
                         S, C, F32Val{(const float*)g, S, C}, (float*)out,
                         reinterpret_cast<cudaStream_t>(stream));
}
