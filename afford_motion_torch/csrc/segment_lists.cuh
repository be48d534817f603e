// Per-destination position lists for the ordered scatter-adds (scatter.cu and
// banded_scatter.cu): for every destination row, the flat positions
// p = m * K + k of the (M, K) neighbourhood table that point at it, sorted
// ascending. Four small kernels on one stream: (1) count the positions that
// point at each destination (integer atomics: a count does not depend on
// their order); (2) exclusive scan of the counts, one block per cloud, gives
// every destination its slice of one list array; (3) each position drops
// itself into its destination's slice through an integer cursor (the order
// inside a slice is arbitrary here); (4) one warp per destination sorts its
// slice ascending by rank counting (positions are unique) into a second
// array. A `Keep` functor says which positions take part at all: the plain
// scatter keeps every one, the banded scatter only those whose index lies in
// their tile's window.
//
// Everything is in an anonymous namespace: each source that includes this
// file gets its own copy of the kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kAcc = 4;  // accumulators (channels) per lane and pass
constexpr unsigned kFull = 0xffffffffu;

struct KeepAll {
  __device__ bool operator()(long long /*b*/, int /*local_pos*/, int /*dest*/) const { return true; }
};

template <typename Keep>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ idx, int n, int mk, long long positions,
             int* __restrict__ counts, Keep keep) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= positions) return;
  const long long b = p / mk;
  const int dest = idx[p];
  if (!keep(b, static_cast<int>(p - b * mk), dest)) return;
  atomicAdd(&counts[b * n + dest], 1);
}

// counts[b, :] -> start[b, :] = b * mk + exclusive prefix; the counts are
// overwritten with the same values and serve as the fill cursors.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int* __restrict__ start, int n, int mk) {
  __shared__ int warp_sums[32];
  int* c = counts + static_cast<long long>(blockIdx.x) * n;
  int* s = start + static_cast<long long>(blockIdx.x) * n;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += c[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int total = warp_sums[lane];
    int acc = total;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, acc, d);
      if (lane >= d) acc += v;
    }
    warp_sums[lane] = acc - total;
  }
  __syncthreads();
  int run = static_cast<int>(blockIdx.x) * mk + warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int cnt = c[i];
    s[i] = run;
    c[i] = run;
    run += cnt;
  }
}

template <typename Keep>
__global__ void __launch_bounds__(kThreads)
fill_kernel(const int* __restrict__ idx, int n, int mk, long long positions,
            int* __restrict__ cursor, int* __restrict__ unsorted, Keep keep) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= positions) return;
  const long long b = p / mk;
  const int dest = idx[p];
  if (!keep(b, static_cast<int>(p - b * mk), dest)) return;
  const int slot = atomicAdd(&cursor[b * n + dest], 1);
  unsorted[slot] = static_cast<int>(p);
}

// After the fill, cursor[d] is the end of destination d's slice. Positions
// are unique, so an element's rank is the number of smaller ones.
__global__ void __launch_bounds__(kThreads)
sort_kernel(const int* __restrict__ start, const int* __restrict__ end,
            const int* __restrict__ unsorted, long long rows, int* __restrict__ sorted) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lo = start[row], len = end[row] - lo;
  for (int i = threadIdx.x & 31; i < len; i += 32) {
    const int mine = unsorted[lo + i];
    int rank = 0;
    for (int t = 0; t < len; ++t) rank += unsorted[lo + t] < mine;
    sorted[lo + rank] = mine;
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

inline unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// idx (b, mk) int32 -> start / counts (b * n each; after the call counts[d]
// is the end of d's slice) and sorted (b * mk; slice d holds d's positions
// ascending, as offsets into the flat (b * mk) table). unsorted is scratch.
template <typename Keep>
cudaError_t build_lists(const int* idx, int b, int n, int mk, int* counts, int* start,
                        int* unsorted, int* sorted, Keep keep, cudaStream_t st) {
  const long long positions = static_cast<long long>(b) * mk;
  const long long rows = static_cast<long long>(b) * n;
  if (positions > 0x7fffffffLL || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * rows, st);
  if (err != cudaSuccess) return err;
  count_kernel<<<blocks_for(positions, kThreads), kThreads, 0, st>>>(idx, n, mk, positions,
                                                                    counts, keep);
  scan_kernel<<<static_cast<unsigned>(b), kScanThreads, 0, st>>>(counts, start, n, mk);
  fill_kernel<<<blocks_for(positions, kThreads), kThreads, 0, st>>>(idx, n, mk, positions,
                                                                   counts, unsorted, keep);
  sort_kernel<<<blocks_for(rows, kWarpsPerBlock), kThreads, 0, st>>>(start, counts, unsorted,
                                                                    rows, sorted);
  return cudaSuccess;
}

}  // namespace
