// Neighbourhood row gather: out[b, m, k, :] = x[b, idx[b, m, k], :].
//
// Replaces the forward of afford_motion_tpu/ops/pallas/gather.py
// (`gather_rows` -> `_gather_fwd_impl` -> `_gather_kernel`). The TPU kernel
// gathers bf16 through f32; here rows are copied as raw 2- or 4-byte words,
// so the result is bit-exact for f32 and bf16 alike.
//
// What bounds it on the H100: bytes. Every output row is written once and
// every source row read about K times (mostly from L2: a cloud's rows are
// at most 8192 x 515 x 4 B). Design: one warp per output row, lanes stride
// over the channels, so both the read of the source row and the write of
// the output row are contiguous across the warp. Row widths on the
// PointTransformer path (35..515 channels) are not multiples of 4 elements,
// which rules out 16-byte vector accesses without a second, padded layout;
// that is left to a later change.
//
// Indices are not range-checked here (nor on the TPU); they come from the
// kNN of the same cloud.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ idx, int n, int c,
                   long long rows_per_batch, long long rows, T* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long b = row / rows_per_batch;
  const T* src = x + (b * n + idx[row]) * static_cast<long long>(c);
  T* dst = out + row * static_cast<long long>(c);
  for (int ch = threadIdx.x & 31; ch < c; ch += 32) dst[ch] = src[ch];
}

template <typename T>
void launch(const void* x, const int* idx, int b, int n, int c, int m, int k, void* out,
            cudaStream_t stream) {
  const long long rows_per_batch = static_cast<long long>(m) * k;
  const long long rows = rows_per_batch * b;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), idx, n, c, rows_per_batch, rows, static_cast<T*>(out));
}

}  // namespace

extern "C" int amt_gather_rows(const void* x, const int* idx, int b, int n, int c, int m,
                               int k, int elem_bytes, void* out, void* stream) {
  if (b <= 0 || n <= 0 || c <= 0 || m <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (static_cast<long long>(b) * m * k + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<uint32_t>(x, idx, b, n, c, m, k, out, st);
  } else if (elem_bytes == 2) {
    launch<uint16_t>(x, idx, b, n, c, m, k, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
