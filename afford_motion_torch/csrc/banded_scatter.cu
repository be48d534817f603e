// Windowed (banded) scatter-add, the backward of the banded gather:
//   out[b, d, :] = sum over the tiles t, ascending, of
//                    (sum over the positions p of tile t with idx[b, p] == d,
//                     ascending, of g[b, p, :]),
// both sums started from zero and taken in float32. p = m * K + k is the flat
// position in the (M, K) neighbourhood table and its tile is m / 128. A
// position whose index lies outside its tile's window [start, start + S)
// contributes nothing, as its gathered row was zero.
//
// Replaces the backward of afford_motion_tpu/ops/pallas/banded.py
// (`_gather_banded_bwd` -> `_scatter_banded_impl` -> `_scatter_kernel` and
// the fold of the per-tile window slices that follows it). The TPU kernel
// multiplies each tile's transposed one-hot with the tile's rows of g into a
// (S, C) slice and then adds the overlapping slices of all tiles into the
// (N, C) result. The two-level sum above is that structure with an order
// fixed: within a tile by position, across tiles by tile. It is not the flat
// order of csrc/scatter.cu: where a destination collects from two tiles the
// association differs. No one-hot is built and no product is computed.
//
// Design: as csrc/scatter.cu, a segment reduce by destination without float
// atomics (training must repeat bit for bit). segment_lists.cuh gives every
// destination the ascending list of its positions, with the out-of-window
// positions left out; one warp per destination row walks the list, lanes
// over channels, and keeps a tile partial that is folded into the total
// when the tile changes (positions ascend, so tiles do). bf16 rows are read
// as bf16, summed in float32 and rounded once at the end.
//
// What bounds it on the H100: bytes. g is read once, the output written
// once; index and list traffic is 4 bytes per position against C * 2..4.
#include "segment_lists.cuh"

namespace {

constexpr int kTileQueries = 128;  // TQ of the window policy

// keeps the positions whose index lies in their tile's window
struct InWindow {
  const int* starts;
  int starts_stride;
  int tile_positions;  // 128 * K
  int s;
  __device__ bool operator()(long long b, int local_pos, int dest) const {
    const int rel = dest - starts[b * starts_stride + local_pos / tile_positions];
    return rel >= 0 && rel < s;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_banded_kernel(const T* __restrict__ g, const int* __restrict__ start,
                     const int* __restrict__ end, const int* __restrict__ sorted, int n, int c,
                     int mk, int tile_positions, long long rows, T* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int lo = start[row], hi = end[row];
  const int first = static_cast<int>(row / n) * mk;  // the cloud's first flat position
  T* dst = out + row * c;
  for (int ch0 = 0; ch0 < c; ch0 += 32 * kAcc) {
    float total[kAcc], part[kAcc];
#pragma unroll
    for (int u = 0; u < kAcc; ++u) total[u] = part[u] = 0.0f;
    int tile = -1;
    for (int t = lo; t < hi; ++t) {
      const int p = sorted[t];
      const int p_tile = (p - first) / tile_positions;
      if (p_tile != tile) {
#pragma unroll
        for (int u = 0; u < kAcc; ++u) {
          total[u] = __fadd_rn(total[u], part[u]);
          part[u] = 0.0f;
        }
        tile = p_tile;
      }
      const T* src = g + static_cast<long long>(p) * c;
#pragma unroll
      for (int u = 0; u < kAcc; ++u) {
        const int ch = ch0 + u * 32 + lane;
        if (ch < c) part[u] = __fadd_rn(part[u], load_f32(src + ch));
      }
    }
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      const int ch = ch0 + u * 32 + lane;
      if (ch < c) store_f32(dst + ch, __fadd_rn(total[u], part[u]));
    }
  }
}

}  // namespace

// g (b, m * k, c) and out (b, n, c) in float32 (elem_bytes 4) or bfloat16
// (2); idx (b, m * k) int32; starts int32, (m / 128,) with starts_stride 0 or
// (b, m / 128) with starts_stride m / 128, each in [0, n - s]. Scratch, all
// int32: counts and start (b * n each), unsorted and sorted (b * m * k each);
// their contents on entry do not matter.
extern "C" int amt_scatter_banded(const void* g, const int* idx, const int* starts,
                                  int starts_stride, int b, int n, int c, int m, int k, int s,
                                  int elem_bytes, int* counts, int* start, int* unsorted,
                                  int* sorted, void* out, void* stream) {
  if (b <= 0 || n <= 0 || c <= 0 || m <= 0 || m % kTileQueries != 0 || k <= 0 || s <= 0 ||
      s > n || (elem_bytes != 4 && elem_bytes != 2) ||
      (starts_stride != 0 && starts_stride != m / kTileQueries)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mk = m * k;
  const int tile_positions = kTileQueries * k;
  const long long rows = static_cast<long long>(b) * n;
  auto st = static_cast<cudaStream_t>(stream);
  const InWindow keep{starts, starts_stride, tile_positions, s};
  const cudaError_t err = build_lists(idx, b, n, mk, counts, start, unsorted, sorted, keep, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (elem_bytes == 4) {
    reduce_banded_kernel<float><<<blocks_for(rows, kWarpsPerBlock), kThreads, 0, st>>>(
        static_cast<const float*>(g), start, counts, sorted, n, c, mk, tile_positions, rows,
        static_cast<float*>(out));
  } else {
    reduce_banded_kernel<__nv_bfloat16><<<blocks_for(rows, kWarpsPerBlock), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), start, counts, sorted, n, c, mk, tile_positions,
        rows, static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
