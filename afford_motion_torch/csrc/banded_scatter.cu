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
// Design: ordered_scatter.cuh, keeping the positions whose index lies in
// their tile's window: the positions grouped stably by their destination's
// range of 128 rows, then by destination, with no atomics in device memory
// and nothing to clear; then one warp a destination walks its list, which
// ascends by position and so by tile, lanes over channels, a tile partial
// folded into the total when the tile changes. Rows nobody points at come
// out zero. bf16 rows are read as bf16, summed in float32 and rounded once
// at the end.
//
// What bounds it on the H100: bytes. g is read once, the output written
// once; the lists cost a few reads and writes of 4 bytes a position against
// C * 2..4 bytes of g.
#include "ordered_scatter.cuh"

namespace {
constexpr int kTileQueries = 128;  // TQ of the window policy
}  // namespace

// g (b, m * k, c) and out (b, n, c) in float32 (elem_bytes 4) or bfloat16
// (2); idx (b, m * k) int32; starts int32, (m / 128,) with starts_stride 0 or
// (b, m / 128) with starts_stride m / 128; m * k < 2^24 and n <= 131072. The
// sums' launch configuration: passes (channel passes of ceil(c / passes)
// channels, at most 32 * wide), wide (channels a lane, 1 to 4) and budget
// (0 or 1: see sums_kernel in ordered_scatter.cuh). scratch:
// amt_scatter_scratch(b, n, m * k) int32 entries whose contents on entry do
// not matter.
extern "C" int amt_scatter_banded(const void* g, const int* idx, const int* starts,
                                  int starts_stride, int b, int n, int c, int m, int k, int s,
                                  int elem_bytes, int passes, int wide, int budget,
                                  int* scratch, void* out, void* stream) {
  if (m <= 0 || m % kTileQueries != 0 || k <= 0 || s <= 0 || s > n ||
      (starts_stride != 0 && starts_stride != m / kTileQueries) || passes < 1 || passes > c ||
      static_cast<long long>(m) * k > kPosMask) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tp = kTileQueries * k;
  return static_cast<int>(ordered_scatter<true>(g, idx, b, n, c, m * k, elem_bytes,
                                                (c + passes - 1) / passes, wide, budget,
                                                InWindow{starts, starts_stride, tp, s}, tp,
                                                scratch, out, static_cast<cudaStream_t>(stream)));
}
