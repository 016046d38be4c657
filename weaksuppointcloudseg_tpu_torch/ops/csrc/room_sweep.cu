// The room sweep of the S3DIS test path on the card: a raw room [n, C]
// (float32 or float64 rows: xyz in metres, rgb 0-255, ..., the class label
// last) cut into 1 m x 1 m blocks on a num_x x num_y grid, each kept
// block's drawn rows gathered and normalised.
//
// Replaces no Pallas kernel: the JAX package sweeps a room with numpy on
// the host (weaksuppointcloudseg_tpu/data/s3dis.py::room_to_blocks, a
// mask per block). It was added because a host sweep was the largest
// share of a room request while the card idled, and because the blocks it
// makes go to the card anyway (the eval forward and the room LP run
// there). The host keeps the draws (numpy, on the
// caller's generator); it fetches only each block's count for them.
//
// Two entry points, bitwise what the JAX package's sweep computes (the
// plain versions in ops/room_sweep.py, the port's CPU path, are the tests'
// oracle on the card):
//
// room_sweep_members_launch: each block's member rows, in ascending point
//   index, a stable counting sort in four launches:
//   1. count: every warp owns a tile of `tile` consecutive points and
//      counts, in a histogram of its own in shared memory, the blocks its
//      points fall in: a point's own block (floor of x and y, in float64),
//      and where the point lies on an interior block edge (x == floor(x)
//      >= 1, or y) the block below it on that axis, on a corner the
//      diagonal one too (the reference's inclusive bounds). A block off
//      the grid (x < 0, or x == limit at a whole metre) takes nothing: it
//      is a spare bucket, never read. Counts go to
//      hist[block][tile].
//   2. rows: one CTA per block scans its row of hist (exclusive), giving
//      each tile's first slot inside the block, and writes the block's
//      count.
//   3. starts: one CTA scans the counts (exclusive): where each block's
//      members start.
//   4. scatter: every warp walks its tile again in order, 32 points at a
//      time, and gives each of its entries the slot start + the tile's
//      offset + the entries of that block already placed by the warp +
//      those of lower lanes in this group (a ballot over the lanes that
//      hold the same block; a point has at most one entry per block). So
//      a block's members come out in ascending point index, own points and
//      edge copies merged, with no sort and no atomics on global memory.
//
// room_sweep_gather_launch: one CTA per kept block gathers its drawn rows
//   (picks are positions in members, start + draw, made on the host),
//   takes the block's min of x and y over them (exact in any order), and
//   writes the 9 channels in the reference's float64 arithmetic: x -
//   (min x + 0.5), y - (min y + 0.5), z, rgb / 255, xyz / limit, each
//   rounded once to float32; the label truncated to int32. The build uses
//   no fast-math flag, so the double divisions are IEEE round-to-nearest.
//
// What bounds them on an H100: the bytes. The benchmark's largest room
// (1,536,576 float64 rows of 7, 48 blocks of 4096) needs x and y of every
// row read once and its 1,536,576 members written once: 30.7 MB, 0.0092
// ms at 3.35 TB/s (the kernels read x and y twice, in the count and the
// scatter). The gather reads each of 48 x 4096 picked rows (56 bytes), its
// pick and member (8 bytes) and writes 40 bytes a point: 20.4 MB, 0.0061
// ms. Every pass over the room is coalesced on its rows; only the members'
// scatter and the rows' gather are not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;        // warps of a bucketing CTA
constexpr int SCAN_THREADS = 256;   // a row's scan
constexpr int STARTS_THREADS = 1024;
constexpr int GATHER_THREADS = 256;
constexpr size_t SMEM_LIMIT = 48 * 1024;

// Point p's blocks: own, below in x, below in y, diagonal; -1 where none.
template <typename T>
__device__ __forceinline__ void point_keys(const T* __restrict__ raw,
                                           long long p, int ncols, int num_x,
                                           int num_y, int key[4]) {
  const double x = (double)raw[p * ncols];
  const double y = (double)raw[p * ncols + 1];
  const double fx = floor(x), fy = floor(y);
  const bool in_x = fx >= 0.0 && fx < (double)num_x;
  const bool in_y = fy >= 0.0 && fy < (double)num_y;
  const bool edge_x = x == fx && fx >= 1.0 && fx <= (double)num_x;
  const bool edge_y = y == fy && fy >= 1.0 && fy <= (double)num_y;
  const int ix = (in_x || edge_x) ? (int)fx : 0;
  const int iy = (in_y || edge_y) ? (int)fy : 0;
  key[0] = (in_x && in_y) ? ix * num_y + iy : -1;
  key[1] = (edge_x && in_y) ? (ix - 1) * num_y + iy : -1;
  key[2] = (edge_y && in_x) ? ix * num_y + iy - 1 : -1;
  key[3] = (edge_x && edge_y) ? (ix - 1) * num_y + iy - 1 : -1;
}

template <typename T>
__global__ void count_kernel(const T* __restrict__ raw, long long n, int ncols,
                             int num_x, int num_y, int tile, int tiles,
                             int* __restrict__ hist) {
  extern __shared__ int run_all[];  // [warps][nblocks]
  const int nblocks = num_x * num_y;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * warps + warp;
  if (t >= tiles) return;  // whole warps; no CTA barrier below
  int* run = run_all + warp * nblocks;
  for (int k = lane; k < nblocks; k += 32) run[k] = 0;
  __syncwarp();
  const long long p0 = (long long)t * tile;
  const long long p1 = p0 + tile < n ? p0 + tile : n;
  for (long long p = p0 + lane; p < p1; p += 32) {
    int key[4];
    point_keys(raw, p, ncols, num_x, num_y, key);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (key[s] >= 0) atomicAdd(&run[key[s]], 1);
    }
  }
  __syncwarp();
  for (int k = lane; k < nblocks; k += 32) hist[(long long)k * tiles + t] = run[k];
}

// In-place exclusive scan of a[0, len) by the whole CTA, in chunks of
// blockDim.x; returns the total to every thread.
__device__ int cta_exclusive_scan(int* a, int len) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  int carry = 0;
  for (int base = 0; base < len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < len ? a[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? warp_sum[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    if (i < len) a[i] = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    carry += warp_sum[warps - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
  return carry;
}

// CTA k: hist's row k -> each tile's offset inside block k; counts[k].
__global__ void __launch_bounds__(SCAN_THREADS) rows_kernel(
    int* __restrict__ hist, int tiles, int* __restrict__ counts) {
  const int total = cta_exclusive_scan(hist + (long long)blockIdx.x * tiles, tiles);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(STARTS_THREADS) starts_kernel(
    const int* __restrict__ counts, int nblocks, int* __restrict__ starts) {
  for (int k = threadIdx.x; k < nblocks; k += blockDim.x) starts[k] = counts[k];
  __syncthreads();
  cta_exclusive_scan(starts, nblocks);
}

__device__ __forceinline__ int pick_key(const int key[4], unsigned slot) {
  return slot == 0 ? key[0] : slot == 1 ? key[1] : slot == 2 ? key[2] : key[3];
}

template <typename T>
__global__ void scatter_kernel(const T* __restrict__ raw, long long n,
                               int ncols, int num_x, int num_y, int tile,
                               int tiles, const int* __restrict__ hist,
                               const int* __restrict__ starts,
                               int* __restrict__ members) {
  extern __shared__ int run_all[];  // [warps][nblocks]: the next slot
  const int nblocks = num_x * num_y;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * warps + warp;
  if (t >= tiles) return;
  int* run = run_all + warp * nblocks;
  for (int k = lane; k < nblocks; k += 32) {
    run[k] = starts[k] + hist[(long long)k * tiles + t];
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1;
  const long long p0 = (long long)t * tile;
  const long long p1 = p0 + tile < n ? p0 + tile : n;
  for (long long base = p0; base < p1; base += 32) {
    const long long p = base + lane;
    int key[4] = {-1, -1, -1, -1};
    if (p < p1) point_keys(raw, p, ncols, num_x, num_y, key);
    unsigned pending = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) pending |= (key[s] >= 0 ? 1u : 0u) << s;
    // one block a round: the lowest lane's next pending block, placed
    // for every lane that holds it, in lane (= point) order
    for (unsigned any = __ballot_sync(FULL, pending != 0); any;
         any = __ballot_sync(FULL, pending != 0)) {
      const int leader = __ffs(any) - 1;
      const int mine = pending ? pick_key(key, __ffs(pending) - 1) : -1;
      const int k = __shfl_sync(FULL, mine, leader);
      int hit = -1;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (((pending >> s) & 1u) && key[s] == k) hit = s;
      }
      const unsigned holders = __ballot_sync(FULL, hit >= 0);
      if (hit >= 0) {
        members[run[k] + __popc(holders & below)] = (int)p;
        pending &= ~(1u << hit);
      }
      __syncwarp();
      if (lane == leader) run[k] += __popc(holders);
      __syncwarp();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS) gather_kernel(
    const T* __restrict__ raw, long long n, int ncols,
    const int* __restrict__ members, long long n_members,
    const int* __restrict__ picks, int num_point, double lx, double ly,
    double lz, float* __restrict__ blocks, int* __restrict__ labels) {
  __shared__ double warp_min[2][GATHER_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long b = blockIdx.x;
  const int* pk = picks + b * num_point;
  double mx = INFINITY, my = INFINITY;
  for (int j = threadIdx.x; j < num_point; j += GATHER_THREADS) {
    const int q = pk[j];
    if (q < 0 || q >= n_members) __trap();  // out of range: stop, never clamp
    const int row = members[q];
    if (row < 0 || row >= n) __trap();
    mx = fmin(mx, (double)raw[(long long)row * ncols]);
    my = fmin(my, (double)raw[(long long)row * ncols + 1]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmin(mx, __shfl_xor_sync(FULL, mx, o));
    my = fmin(my, __shfl_xor_sync(FULL, my, o));
  }
  if (lane == 0) {
    warp_min[0][warp] = mx;
    warp_min[1][warp] = my;
  }
  __syncthreads();
  mx = warp_min[0][0];
  my = warp_min[1][0];
#pragma unroll
  for (int w = 1; w < GATHER_THREADS / 32; ++w) {
    mx = fmin(mx, warp_min[0][w]);
    my = fmin(my, warp_min[1][w]);
  }
  const double cx = mx + 0.5, cy = my + 0.5;  // BLOCK_SIZE / 2
  for (int j = threadIdx.x; j < num_point; j += GATHER_THREADS) {
    const T* r = raw + (long long)members[pk[j]] * ncols;
    const double x = (double)r[0], y = (double)r[1], z = (double)r[2];
    float* o = blocks + (b * num_point + j) * 9;
    o[0] = (float)(x - cx);
    o[1] = (float)(y - cy);
    o[2] = (float)z;
    o[3] = (float)((double)r[3] / 255.0);
    o[4] = (float)((double)r[4] / 255.0);
    o[5] = (float)((double)r[5] / 255.0);
    o[6] = (float)(x / lx);
    o[7] = (float)(y / ly);
    o[8] = (float)(z / lz);
    labels[b * num_point + j] = (int)(double)r[ncols - 1];
  }
}

// Warps of a bucketing CTA: as many as fit their histograms in 48 KB.
int bucket_warps(int nblocks) {
  const long long fit = (long long)SMEM_LIMIT / (4LL * nblocks);
  return fit > MAX_WARPS ? MAX_WARPS : (int)fit;
}

template <typename T>
cudaError_t members_launch(const void* raw, long long n, int ncols, int num_x,
                           int num_y, int tile, int tiles, int* hist,
                           int* counts, int* starts, int* members,
                           cudaStream_t s) {
  const int nblocks = num_x * num_y;
  const int warps = bucket_warps(nblocks);
  const int grid = (tiles + warps - 1) / warps;
  const size_t smem = sizeof(int) * (size_t)warps * nblocks;
  count_kernel<T><<<grid, 32 * warps, smem, s>>>((const T*)raw, n, ncols, num_x,
                                                  num_y, tile, tiles, hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<<<nblocks, SCAN_THREADS, 0, s>>>(hist, tiles, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  starts_kernel<<<1, STARTS_THREADS, 0, s>>>(counts, nblocks, starts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<T><<<grid, 32 * warps, smem, s>>>(
      (const T*)raw, n, ncols, num_x, num_y, tile, tiles, hist, starts, members);
  return cudaGetLastError();
}

}  // namespace

// raw [n, ncols] float32 (f64 == 0) or float64 (f64 == 1); the grid
// num_x x num_y; tiles == ceil(n / tile), tile a multiple of 32; hist int32
// [num_x * num_y * tiles], counts and starts int32 [num_x * num_y], members
// int32 with room for every entry (at most 4 n). Block b's member rows are
// members[starts[b], starts[b] + counts[b]). Returns a cudaError_t
// (cudaErrorInvalidValue for a shape the launch cannot take).
extern "C" int room_sweep_members_launch(const void* raw, int f64, long long n,
                                         int ncols, int num_x, int num_y,
                                         int tile, int tiles, void* hist,
                                         void* counts, void* starts,
                                         void* members, void* stream) {
  if (n < 1 || ncols < 2 || num_x < 1 || num_y < 1 || tile < 32 ||
      tile % 32 != 0 || (long long)num_x * num_y > (long long)SMEM_LIMIT / 4 ||
      (long long)tiles * tile < n || (long long)(tiles - 1) * tile >= n ||
      4 * n > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int* h = (int*)hist;
  int* c = (int*)counts;
  int* st = (int*)starts;
  int* m = (int*)members;
  const cudaError_t err =
      f64 ? members_launch<double>(raw, n, ncols, num_x, num_y, tile, tiles, h, c, st, m, s)
          : members_launch<float>(raw, n, ncols, num_x, num_y, tile, tiles, h, c, st, m, s);
  return (int)err;
}

// raw as above (ncols >= 7 for rgb and the label: columns 3:6 and the
// last); members int32 [n_members]; picks int32 [K, num_point], positions
// in members; limit the room's extent; blocks float32 [K, num_point, 9],
// labels int32 [K, num_point].
extern "C" int room_sweep_gather_launch(const void* raw, int f64, long long n,
                                        int ncols, const void* members,
                                        long long n_members, const void* picks,
                                        int K, int num_point, double lx,
                                        double ly, double lz, void* blocks,
                                        void* labels, void* stream) {
  if (n < 1 || ncols < 7 || n_members < 1 || n_members > INT32_MAX ||
      K < 0 || num_point < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (K == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (f64) {
    gather_kernel<double><<<K, GATHER_THREADS, 0, s>>>(
        (const double*)raw, n, ncols, (const int*)members, n_members,
        (const int*)picks, num_point, lx, ly, lz, (float*)blocks, (int*)labels);
  } else {
    gather_kernel<float><<<K, GATHER_THREADS, 0, s>>>(
        (const float*)raw, n, ncols, (const int*)members, n_members,
        (const int*)picks, num_point, lx, ly, lz, (float*)blocks, (int*)labels);
  }
  return (int)cudaGetLastError();
}
