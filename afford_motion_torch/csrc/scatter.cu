// Scatter-add of neighbourhood rows, the backward of the row gather:
//   out[b, idx[b, p], :] = sum over p, in ascending p, of g[b, p, :]
// with p = m * K + k the flat position in the (M, K) neighbourhood table,
// the sum started from zero and taken in float32.
//
// Replaces the backward of afford_motion_tpu/ops/pallas/gather.py
// (`_scatter_add_impl` -> `_scatter_kernel`). The TPU kernel walks the
// positions in order on one core and read-modify-writes the destination row
// in VMEM, so every destination sums its contributions in ascending
// position. That order is the contract here too: a float atomicAdd into the
// output would sum in an order that changes from run to run, and training
// resumes bit for bit only if the backward is deterministic.
//
// Design: a segment reduce by destination, in five small kernels on one
// stream. The first four (segment_lists.cuh: count, scan, fill, sort) give
// every destination the ascending list of the positions that point at it;
// (5) one warp per destination row walks its sorted slice and adds the rows
// of g in that order, lanes over channels, a few accumulators per lane.
// Rows nobody points at come out zero. bf16 rows are read as bf16, summed in
// float32 and rounded to bf16 once at the end, which equals casting g to
// float32, summing and casting the sum.
//
// What bounds it on the H100: bytes. g is read once (up to 562 MB in
// float32 at the first encoder level), the output written once; the index
// and list traffic is 4 bytes per position against C * 2..4 bytes of g.
// The sort in (4) is quadratic in a destination's in-degree, which is about
// K (8 or 16) on a kNN graph.
//
// Indices are not range-checked (they come from the kNN of the same cloud).
#include "segment_lists.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ g, const int* __restrict__ start,
              const int* __restrict__ end, const int* __restrict__ sorted, int c,
              long long rows, T* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int lo = start[row], hi = end[row];
  T* dst = out + row * c;
  for (int ch0 = 0; ch0 < c; ch0 += 32 * kAcc) {
    float acc[kAcc];
#pragma unroll
    for (int u = 0; u < kAcc; ++u) acc[u] = 0.0f;
    for (int t = lo; t < hi; ++t) {
      const T* src = g + static_cast<long long>(sorted[t]) * c;
#pragma unroll
      for (int u = 0; u < kAcc; ++u) {
        const int ch = ch0 + u * 32 + lane;
        if (ch < c) acc[u] = __fadd_rn(acc[u], load_f32(src + ch));
      }
    }
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      const int ch = ch0 + u * 32 + lane;
      if (ch < c) store_f32(dst + ch, acc[u]);
    }
  }
}

}  // namespace

// g (b, mk, c) and out (b, n, c) in float32 (elem_bytes 4) or bfloat16 (2);
// idx (b, mk) int32 in [0, n). Scratch, all int32: counts and start (b * n
// each), unsorted and sorted (b * mk each); their contents on entry do not
// matter.
extern "C" int amt_scatter_add_rows(const void* g, const int* idx, int b, int n, int c, int mk,
                                    int elem_bytes, int* counts, int* start, int* unsorted,
                                    int* sorted, void* out, void* stream) {
  if (b <= 0 || n <= 0 || c <= 0 || mk <= 0 || (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(b) * n;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = build_lists(idx, b, n, mk, counts, start, unsorted, sorted, KeepAll(), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (elem_bytes == 4) {
    reduce_kernel<float><<<blocks_for(rows, kWarpsPerBlock), kThreads, 0, st>>>(
        static_cast<const float*>(g), start, counts, sorted, c, rows, static_cast<float*>(out));
  } else {
    reduce_kernel<__nv_bfloat16><<<blocks_for(rows, kWarpsPerBlock), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), start, counts, sorted, c, rows,
        static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
