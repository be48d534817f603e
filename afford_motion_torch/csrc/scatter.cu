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
// Design: ordered_scatter.cuh, with every position kept: the positions
// grouped stably by their destination's range of 128 rows, then by
// destination, with no atomics in device memory and nothing to clear; then
// one warp a destination sums its rows in list order, lanes over channels.
// Rows nobody points at come out zero. bf16 rows are read as bf16, summed
// in float32 and rounded to bf16 once at the end, which equals casting g to
// float32, summing and casting the sum.
//
// What bounds it on the H100: bytes. g is read once, the output written
// once; the lists cost a few reads and writes of 4 bytes a position against
// C * 2..4 bytes of g.
//
// Indices are not range-checked (they come from the kNN of the same cloud).
#include "ordered_scatter.cuh"

// int32 entries of scratch that amt_scatter_add_rows and amt_scatter_banded
// need
extern "C" long long amt_scatter_scratch(int b, int n, int mk) { return scratch_ints(b, n, mk); }

// g (b, mk, c) and out (b, n, c) in float32 (elem_bytes 4) or bfloat16 (2);
// idx (b, mk) int32 in [0, n); mk < 2^24 and n <= 131072. The sums' launch
// configuration: passes (channel passes of ceil(c / passes) channels, at
// most 32 * wide), wide (channels a lane, 1 to 4) and budget (0 or 1: see
// sums_kernel in ordered_scatter.cuh). scratch:
// amt_scatter_scratch(b, n, mk) int32 entries whose contents on entry do
// not matter.
extern "C" int amt_scatter_add_rows(const void* g, const int* idx, int b, int n, int c, int mk,
                                    int elem_bytes, int passes, int wide, int budget,
                                    int* scratch, void* out, void* stream) {
  if (passes < 1 || passes > c) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ordered_scatter<false>(
      g, idx, b, n, c, mk, elem_bytes, (c + passes - 1) / passes, wide, budget,
      AllPositions{}, 1, scratch, out, static_cast<cudaStream_t>(stream)));
}
