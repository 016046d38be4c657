// Kernel B14: the bf16 neighbour-row gather
//   out[b, p, j, :] = f[b, idx[b, p, j], :],
// an exact, bitwise copy.
//
// Replaces weaksuppointcloudseg_tpu/ops/gather_pallas.py::gather_rows_pallas
// (body _gather_kernel), which multiplies a one-hot [rows, N] tile by f on
// the MXU because a TPU has no fast indexed loads. Here every output row is
// a plain copy of one source row.
//
// What bounds it on an H100: the bytes. At B=64, N=2048, k=20, C=64 it must
// write out (335.5 MB of bf16) and read idx (10.5 MB) and f (16.8 MB) once:
// 0.1083 ms at 3.35 TB/s. A cloud's f is 256 KB, so the rows it re-reads k
// times on average come from L2.
//
// Design (a simple kernel first): one warp per output point (b, p). Its k
// rows of C values are k*C contiguous bf16 in out. The warp stages the k
// indices in shared memory, checking that each lies in [0, N) (an index
// outside stops the kernel with a trap, never a clamp), then its lanes copy
// the k*C values in chunks of VB bytes, neighbouring lanes on neighbouring
// chunks, so a warp's stores are contiguous. The rows on this path are 6
// bytes (C=3), 18 bytes (C=9) or 128 bytes (C=64) long, so no width is
// assumed: the launcher takes the widest chunk of 16, 8, 4 or 2 bytes that
// divides the row (2C bytes) and to which both f and out are aligned, and
// a chunk never crosses a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <int VB> struct Chunk;
template <> struct Chunk<16> { using T = uint4; };
template <> struct Chunk<8> { using T = uint2; };
template <> struct Chunk<4> { using T = uint32_t; };
template <> struct Chunk<2> { using T = uint16_t; };

// f [B,N,C] and out [B,P,k,C] as chunks: a row is row_chunks chunks.
template <int VB>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const typename Chunk<VB>::T* __restrict__ f,
    const int32_t* __restrict__ idx, int N, int P, int k, int row_chunks,
    long long points, typename Chunk<VB>::T* __restrict__ out) {
  extern __shared__ int sel_all[];  // [WARPS][k] staged indices
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* sel = sel_all + warp * k;
  const long long warps = (long long)gridDim.x * WARPS;
  const int per_point = k * row_chunks;
  for (long long pt = (long long)blockIdx.x * WARPS + warp; pt < points;
       pt += warps) {
    const long long b = pt / P;
    __syncwarp();  // the previous point's indices are consumed
    for (int j = lane; j < k; j += 32) {
      const int nbr = idx[pt * k + j];
      if (nbr < 0 || nbr >= N) __trap();  // out of range: stop, never clamp
      sel[j] = nbr;
    }
    __syncwarp();
    const typename Chunk<VB>::T* src = f + b * N * row_chunks;
    typename Chunk<VB>::T* dst = out + pt * per_point;
    for (int e = lane; e < per_point; e += 32) {
      const int j = e / row_chunks;
      const int c = e - j * row_chunks;
      dst[e] = src[(long long)sel[j] * row_chunks + c];
    }
  }
}

template <int VB>
cudaError_t launch(const void* f, const void* idx, int N, int P, int k,
                   int C, long long points, void* out, int grid, size_t smem,
                   cudaStream_t s) {
  using T = typename Chunk<VB>::T;
  gather_rows_kernel<VB><<<grid, THREADS, smem, s>>>(
      (const T*)f, (const int32_t*)idx, N, P, k, 2 * C / VB, points, (T*)out);
  return cudaGetLastError();
}

bool fits(int C, const void* f, const void* out, int vb) {
  return (2 * C) % vb == 0 && (uintptr_t)f % vb == 0 &&
         (uintptr_t)out % vb == 0;
}

}  // namespace

// f bf16 [B,N,C], idx int32 [B,P,k], out bf16 [B,P,k,C]. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the launch cannot take).
extern "C" int gather_rows_launch(const void* f, const void* idx, int B, int N,
                                  int P, int k, int C, void* out,
                                  void* stream) {
  const size_t smem = sizeof(int) * (size_t)WARPS * k;
  if (B < 0 || N < 1 || P < 0 || k < 1 || C < 1 || smem > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const long long points = (long long)B * P;
  if (points == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const long long want = (points + WARPS - 1) / WARPS;
  const int grid = (int)(want < (long long)sms * 16 ? want : (long long)sms * 16);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (fits(C, f, out, 16)) {
    err = launch<16>(f, idx, N, P, k, C, points, out, grid, smem, s);
  } else if (fits(C, f, out, 8)) {
    err = launch<8>(f, idx, N, P, k, C, points, out, grid, smem, s);
  } else if (fits(C, f, out, 4)) {
    err = launch<4>(f, idx, N, P, k, C, points, out, grid, smem, s);
  } else {
    err = launch<2>(f, idx, N, P, k, C, points, out, grid, smem, s);
  }
  return (int)err;
}
