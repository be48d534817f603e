// Windowed (banded) neighbourhood gather:
//   out[b, m, k, :] = x[b, idx[b, m, k], :]  if start <= idx[b, m, k] < start + S
//                   = 0                      otherwise,
// with start the window start of query row m's tile of 128 rows, read per
// tile from starts (G,) (stride 0 between clouds) or per cloud and tile from
// starts (B, G) (stride G).
//
// Replaces afford_motion_tpu/ops/pallas/banded.py (`gather_banded` ->
// `_gather_banded_impl` -> `_gather_kernel`). The TPU kernel multiplies a
// one-hot matrix over the window with the window's rows on its matrix unit,
// because a row copy costs it a scalar operation per row; a row whose
// index misses the window has no hit in the one-hot and comes out zero. A
// GPU copies rows at memory speed, so no one-hot is built and no product is
// computed here: the rows are copied as raw 2- or 4-byte words, bit-exact for
// f32 and bf16 (for finite x the one-hot product is exact too), and the
// window test supplies the zero rows.
//
// What bounds it on the H100: bytes, as csrc/gather.cu: every output row is
// written once, every source row read about K times, mostly from L2. Design:
// one warp per output row, lanes stride over the channels.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kTileQueries = 128;  // TQ of the window policy

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_banded_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                     const int* __restrict__ starts, int starts_stride, int n, int c, int m,
                     int k, int s, long long rows, T* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long rows_per_batch = static_cast<long long>(m) * k;
  const long long b = row / rows_per_batch;
  const int tile = static_cast<int>((row - b * rows_per_batch) / k) / kTileQueries;
  const int src_row = idx[row];
  const int rel = src_row - starts[b * starts_stride + tile];
  T* dst = out + row * static_cast<long long>(c);
  if (rel >= 0 && rel < s) {
    const T* src = x + (b * n + src_row) * static_cast<long long>(c);
    for (int ch = threadIdx.x & 31; ch < c; ch += 32) dst[ch] = src[ch];
  } else {
    for (int ch = threadIdx.x & 31; ch < c; ch += 32) dst[ch] = 0;
  }
}

template <typename T>
void launch(const void* x, const int* idx, const int* starts, int stride, int b, int n, int c,
            int m, int k, int s, void* out, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * m * k;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_banded_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), idx, starts, stride, n, c, m, k, s, rows, static_cast<T*>(out));
}

}  // namespace

// x (b, n, c) and out (b, m, k, c) in float32 (elem_bytes 4) or bfloat16 (2);
// idx (b, m, k) int32; starts int32, (m / 128,) with starts_stride 0 or
// (b, m / 128) with starts_stride m / 128, each in [0, n - s].
extern "C" int amt_gather_banded(const void* x, const int* idx, const int* starts,
                                 int starts_stride, int b, int n, int c, int m, int k, int s,
                                 int elem_bytes, void* out, void* stream) {
  if (b <= 0 || n <= 0 || c <= 0 || m <= 0 || m % kTileQueries != 0 || k <= 0 || s <= 0 ||
      s > n || (starts_stride != 0 && starts_stride != m / kTileQueries)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (static_cast<long long>(b) * m * k + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<uint32_t>(x, idx, starts, starts_stride, b, n, c, m, k, s, out, st);
  } else if (elem_bytes == 2) {
    launch<uint16_t>(x, idx, starts, starts_stride, b, n, c, m, k, s, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
