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
// stream. (1) count the positions that point at each destination (integer
// atomics: a count does not depend on their order); (2) exclusive scan of
// the counts, one block per cloud, gives every destination its slice of one
// list array; (3) each position drops itself into its destination's slice
// through an integer cursor (the order inside a slice is arbitrary here);
// (4) one warp per destination sorts its slice ascending by rank counting
// (positions are unique) into a second array; (5) one warp per destination
// row walks its sorted slice and adds the rows of g in that order, lanes
// over channels, a few accumulators per lane. Rows nobody points at come
// out zero. bf16 rows are read as bf16, summed in float32 and rounded to
// bf16 once at the end, which equals casting g to float32, summing and
// casting the sum.
//
// What bounds it on the H100: bytes. g is read once (up to 562 MB in
// float32 at the first encoder level), the output written once; the index
// and list traffic is 4 bytes per position against C * 2..4 bytes of g.
// The sort in (4) is quadratic in a destination's in-degree, which is about
// K (8 or 16) on a kNN graph.
//
// Indices are not range-checked (they come from the kNN of the same cloud).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kAcc = 4;  // accumulators (channels) per lane and pass
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ idx, int n, int mk, long long positions,
             int* __restrict__ counts) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= positions) return;
  const long long b = p / mk;
  atomicAdd(&counts[b * n + idx[p]], 1);
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

__global__ void __launch_bounds__(kThreads)
fill_kernel(const int* __restrict__ idx, int n, int mk, long long positions,
            int* __restrict__ cursor, int* __restrict__ unsorted) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= positions) return;
  const long long b = p / mk;
  const int slot = atomicAdd(&cursor[b * n + idx[p]], 1);
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

unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
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
  const long long positions = static_cast<long long>(b) * mk;
  const long long rows = static_cast<long long>(b) * n;
  if (positions > 0x7fffffffLL || rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<blocks_for(positions, kThreads), kThreads, 0, st>>>(idx, n, mk, positions,
                                                                    counts);
  scan_kernel<<<static_cast<unsigned>(b), kScanThreads, 0, st>>>(counts, start, n, mk);
  fill_kernel<<<blocks_for(positions, kThreads), kThreads, 0, st>>>(idx, n, mk, positions,
                                                                   counts, unsorted);
  sort_kernel<<<blocks_for(rows, kWarpsPerBlock), kThreads, 0, st>>>(start, counts, unsorted,
                                                                    rows, sorted);
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
