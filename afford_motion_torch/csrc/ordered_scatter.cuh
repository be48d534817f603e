// The ordered scatter-add shared by the row gather's backward (scatter.cu)
// and the banded gather's backward (banded_scatter.cu): every destination
// row gets the float32 sum, from zero, of the rows of g at the positions
// p = m * K + k whose index names it, in ascending position; the banded one
// drops the positions whose index lies outside their tile's window and sums
// in two levels (see sum_list). No float atomics anywhere: training resumes
// bit for bit only if the backward is deterministic.
//
// Five launches on one stream build every destination's ascending list of
// positions, then sum:
//   (1) count_kernel: each block of 1024 consecutive positions counts its
//       positions per range of 128 destinations (shared-memory atomics)
//       and writes the counts, range-major;
//   (2) scan_kernel: an exclusive scan of those counts, one block a cloud,
//       gives every (range, block of positions) its offset in one array;
//   (3) place_kernel: each block of positions drops every position into
//       its range's part of that array, warps over contiguous parts of the
//       block, ranks among the same range in a step of 32 from
//       `__match_any_sync`: each range's part ascends by position;
//   (4) lists_kernel: one block a range counts its part per destination,
//       scans, and places each position into its destination's list the
//       same way: each list ascends by position;
//   (5) sums_kernel: one warp a destination and channel pass walks the
//       destination's list, lanes over channels, the passes of equal width
//       (C = 131 is two passes of 66, not 128 and 3) and in neighbouring
//       warps.
// The lists take no atomics in device memory and nothing to clear; their
// cost is a few reads and writes of 4 bytes a position beside the C * 2..4
// bytes a position of g that the sums read. The sums keep few registers:
// the rows are scattered, so what bounds them is the row loads the card
// has in flight, and many warps an SM, each a few loads ahead by the
// compiler's unrolling, keep more in flight than deep batches in fewer
// warps did.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kChunk = 1024;      // positions a block of (1) and (3)
constexpr int kRange = 128;       // destinations a range, (1) to (4)
constexpr int kMaxRanges = 1024;  // ranges a cloud: n <= 131072
constexpr int kPosBits = 24;      // a grouped entry: destination in the range << 24 | position
constexpr int kPosMask = (1 << kPosBits) - 1;

// rows are read and written as raw words: float32, or bfloat16 as uint16_t
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Which positions take part: all of them (the row gather), or those whose
// index lies in their tile's window [start, start + s) (the banded gather;
// a tile is 128 query rows, tile_positions positions).
struct AllPositions {
  __device__ __forceinline__ bool keep(int /*b*/, int /*pos*/, int /*v*/) const { return true; }
};
struct InWindow {
  const int* starts;
  int stride, tile_positions, s;
  __device__ __forceinline__ bool keep(int b, int pos, int v) const {
    const int start = starts[static_cast<long long>(b) * stride + pos / tile_positions];
    return static_cast<unsigned>(v - start) < static_cast<unsigned>(s);
  }
};

// (1) counts[b, range, chunk] of the chunk's kept positions whose
// destination lies in the range
template <typename Keep>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ idx, int mk, int ranges, int chunks, Keep keep,
             int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int chunk = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < ranges; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int* ip = idx + static_cast<long long>(b) * mk;
  const int lo = chunk * kChunk, hi = min(lo + kChunk, mk);
#pragma unroll 4
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) {
    const int v = ip[p];
    if (keep.keep(b, p, v)) atomicAdd(&hist[v / kRange], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ranges; i += kThreads)
    counts[(static_cast<long long>(b) * ranges + i) * chunks + chunk] = hist[i];
}

// (2) counts[b, :n] -> start[b, :n] = b * mk + exclusive prefix
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int* __restrict__ start, int n, int mk) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int* cnt = counts + static_cast<long long>(blockIdx.x) * n;
  int* out = start + static_cast<long long>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = static_cast<int>(blockIdx.x) * mk;
  for (int i0 = 0; i0 < n; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    const int v = i < n ? cnt[i] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int total = warp_sums[lane];
      int acc = total;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, acc, d);
        if (lane >= d) acc += u;
      }
      warp_sums[lane] = acc - total;
    }
    __syncthreads();
    const int run = carry + warp_sums[warp] + incl - v;
    if (i < n) out[i] = run;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = run + v;
    __syncthreads();
  }
}

// Stable placement by key: the warp's items [lo, hi), 32 at a time, the
// next step's loads started before this step's placement; an item v =
// load(i) with key(v, i) >= 0 goes into slot offs[key]++ in order (a
// negative key: not placed). All lanes of the warp call it.
template <typename Load, typename Key, typename Put>
__device__ __forceinline__ void place_stable(int lo, int hi, int* offs, Load load, Key key,
                                             Put put) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1;
  int v = lo + lane < hi ? load(lo + lane) : 0;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int next = i + 32 < hi ? load(i + 32) : 0;
    const int k = i < hi ? key(v, i) : -1;
    const unsigned peers = __match_any_sync(kFull, k >= 0 ? k : -1 - lane);
    int slot = 0;
    if (k >= 0) slot = offs[k] + __popc(peers & lower);
    __syncwarp();
    if (k >= 0 && (peers >> lane) == 1u) offs[k] += __popc(peers);  // the last peer
    __syncwarp();
    if (k >= 0) put(v, i, k, slot);
    v = next;
  }
}

// (3) every kept position of the chunk into its range's part of `grouped`
template <typename Keep>
__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ idx, int mk, int ranges, int chunks, Keep keep,
             const int* __restrict__ start, int* __restrict__ grouped) {
  extern __shared__ int offs[];  // [kWarps][ranges]
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * ranges; i += kThreads) offs[i] = 0;
  __syncthreads();
  const int* ip = idx + static_cast<long long>(b) * mk;
  const int c_lo = chunk * kChunk, len = min(kChunk, mk - c_lo);
  const int lo = c_lo + len * warp / kWarps, hi = c_lo + len * (warp + 1) / kWarps;
  int* my_offs = offs + warp * ranges;
  auto range_of = [&](int v, int p) { return keep.keep(b, p, v) ? v / kRange : -1; };
#pragma unroll 4
  for (int p = lo + (threadIdx.x & 31); p < hi; p += 32) {
    const int r = range_of(ip[p], p);
    if (r >= 0) atomicAdd(&my_offs[r], 1);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < ranges; r += kThreads) {
    int run = start[(static_cast<long long>(b) * ranges + r) * chunks + chunk];
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = offs[w * ranges + r];
      offs[w * ranges + r] = run;
      run += cnt;
    }
  }
  __syncthreads();
  place_stable(lo, hi, my_offs, [&](int p) { return ip[p]; }, range_of,
               [&](int v, int p, int r, int slot) {
                 grouped[slot] = ((v - r * kRange) << kPosBits) | p;
               });
}

// (4) one block a range: its part of `grouped` into one list a destination,
// lists[first[d] .. last[d]) ascending; rows b * n + d of first / last. The
// part ends where its last chunk's positions end (out-of-window positions
// are not in `grouped`)
__global__ void __launch_bounds__(kThreads)
lists_kernel(const int* __restrict__ grouped, const int* __restrict__ counts,
             const int* __restrict__ start, int n, int ranges, int chunks,
             int* __restrict__ lists, int* __restrict__ first, int* __restrict__ last) {
  __shared__ int offs[kWarps][kRange];
  __shared__ int warp_sums[kRange / 32];
  const int b = blockIdx.y, range = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long at = (static_cast<long long>(b) * ranges + range) * chunks;
  const int lo = start[at];
  const int hi = start[at + chunks - 1] + counts[at + chunks - 1];
  for (int i = threadIdx.x; i < kWarps * kRange; i += kThreads) (&offs[0][0])[i] = 0;
  __syncthreads();
  const int w_lo = lo + static_cast<int>(static_cast<long long>(hi - lo) * warp / kWarps);
  const int w_hi = lo + static_cast<int>(static_cast<long long>(hi - lo) * (warp + 1) / kWarps);
#pragma unroll 4
  for (int i = w_lo + lane; i < w_hi; i += 32) atomicAdd(&offs[warp][grouped[i] >> kPosBits], 1);
  __syncthreads();
  // the range's destinations: counts -> list offsets (threads < 128)
  const int d = threadIdx.x;
  int tot = 0, incl = 0;
  if (d < kRange) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += offs[w][d];
    incl = tot;
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
  }
  __syncthreads();
  const int row = range * kRange + d;
  if (d < kRange) {
    int run = lo + incl - tot;
    for (int w = 0; w < warp; ++w) run += warp_sums[w];
    if (row < n) {
      first[static_cast<long long>(b) * n + row] = run;
      last[static_cast<long long>(b) * n + row] = run + tot;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = offs[w][d];
      offs[w][d] = run;
      run += cnt;
    }
  }
  __syncthreads();
  place_stable(w_lo, w_hi, offs[warp], [&](int i) { return grouped[i]; },
               [](int v, int) { return v >> kPosBits; },
               [&](int v, int, int, int slot) { lists[slot] = v & kPosMask; });
}

template <int A, typename W>
__device__ __forceinline__ void write_row(W* row, int cw, const float (&s)[A]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (lane + 32 * a < cw) store_f32(row + lane + 32 * a, s[a]);
}

// One destination's row over channels [0, cw) of g and out_row: the rows
// g[list[t]], t in [lo, hi), in order, from zero. With kTiles the sum has
// two levels, as the banded scatter's contract asks: the rows of one tile
// of positions (position / tile_positions) are added into a tile partial
// from zero, and the partials are added into the total in ascending tile
// order from zero; the list ascends, so its tiles do, and a partial is
// folded when the tile changes. The total lives in the warp's row of
// shared memory (`total`, 32 * A floats, each lane its own channels): it is
// touched only at a fold, and the registers it would take go to loads in
// flight.
template <int A, bool kTiles, typename W>
__device__ __forceinline__ void sum_list(const W* __restrict__ g, W* __restrict__ out_row,
                                         long long c, int cw, const int* __restrict__ list,
                                         int lo, int hi, int tile_positions, float* total) {
  const int lane = threadIdx.x & 31;
  float part[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    part[a] = 0.0f;
    if (kTiles) total[lane + 32 * a] = 0.0f;
  }
  int tile_end = 0;  // first position past the current tile
  for (int t = lo; t < hi; ++t) {
    const int pos = list[t];
    if (kTiles && pos >= tile_end) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        total[lane + 32 * a] = __fadd_rn(total[lane + 32 * a], part[a]);
        part[a] = 0.0f;
      }
      tile_end = (pos / tile_positions + 1) * tile_positions;
    }
    const W* src = g + static_cast<long long>(pos) * c;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int ch = lane + 32 * a;
      if (ch < cw) part[a] = __fadd_rn(part[a], to_f32(src[ch]));
    }
  }
  float s[A];
#pragma unroll
  for (int a = 0; a < A; ++a) s[a] = kTiles ? __fadd_rn(total[lane + 32 * a], part[a]) : part[a];
  write_row<A>(out_row, cw, s);
}

// (5) one warp a (destination row, channel pass) of cloud blockIdx.y, the
// passes of a row in neighbouring warps so that the row's parts are read
// close in time. The registers: budgeted for 8 blocks an SM, or as the
// compiler allocates them (kBudget), the choice measured per kernel.
template <typename W, int A, bool kTiles, bool kBudget>
__global__ void __launch_bounds__(kThreads, kBudget ? 8 : 1)
sums_kernel(const W* __restrict__ g, const int* __restrict__ lists,
            const int* __restrict__ first, const int* __restrict__ last, int n, int c, int mk,
            int width, int passes, int tile_positions, W* __restrict__ out) {
  __shared__ float totals[kTiles ? kWarps : 1][kTiles ? 32 * A : 1];
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kWarps + warp;
  if (item >= n * passes) return;
  const int d = passes == 1 ? item : item / passes;
  const int ch0 = (item - d * passes) * width;
  const long long row = static_cast<long long>(blockIdx.y) * n + d;
  sum_list<A, kTiles>(g + static_cast<long long>(blockIdx.y) * mk * c + ch0, out + row * c + ch0,
                      c, min(width, c - ch0), lists, first[row], last[row], tile_positions,
                      totals[kTiles ? warp : 0]);
}

// int32 entries of scratch that ordered_scatter needs
inline long long scratch_ints(int b, int n, int mk) {
  const long long ranges = (n + kRange - 1) / kRange, chunks = (mk + kChunk - 1) / kChunk;
  return 2 * b * ranges * chunks + 2LL * b * mk + 2LL * b * n;
}

template <typename W, int A, bool kTiles, bool kBudget>
void launch_sums(const void* g, const int* lists, const int* first, const int* last, int b, int n,
                 int c, int mk, int width, int tile_positions, void* out, cudaStream_t st) {
  const int passes = (c + width - 1) / width;
  const dim3 grid((n * passes + kWarps - 1) / kWarps, b);
  sums_kernel<W, A, kTiles, kBudget><<<grid, kThreads, 0, st>>>(
      static_cast<const W*>(g), lists, first, last, n, c, mk, width, passes, tile_positions,
      static_cast<W*>(out));
}

template <typename W, bool kTiles, bool kBudget>
void launch_sums_wide(int wide, const void* g, const int* lists, const int* first,
                      const int* last, int b, int n, int c, int mk, int width,
                      int tile_positions, void* out, cudaStream_t st) {
  switch (wide) {
#define AMT_SUMS(A)                                                                         \
  case A:                                                                                   \
    launch_sums<W, A, kTiles, kBudget>(g, lists, first, last, b, n, c, mk, width,           \
                                       tile_positions, out, st);                            \
    break;
    AMT_SUMS(1)
    AMT_SUMS(2)
    AMT_SUMS(3)
    AMT_SUMS(4)
#undef AMT_SUMS
  }
}

// The whole scatter-add; `keep` and `tile_positions` (kTiles) as above.
// g (b, mk, c) and out (b, n, c), float32 (elem_bytes 4) or bfloat16 (2);
// idx (b, mk); the sums' configuration: width, the channels a pass; wide,
// the channels a lane (width <= 32 * wide, wide 1 to 4); budget (0 or 1) as
// for sums_kernel; scratch: scratch_ints(b, n, mk) int32 entries.
template <bool kTiles, typename Keep>
cudaError_t ordered_scatter(const void* g, const int* idx, int b, int n, int c, int mk,
                            int elem_bytes, int width, int wide, int budget, Keep keep,
                            int tile_positions, int* scratch, void* out, cudaStream_t st) {
  const int ranges = (n + kRange - 1) / kRange, chunks = (mk + kChunk - 1) / kChunk;
  if (b <= 0 || b > 65535 || n <= 0 || ranges > kMaxRanges || c <= 0 || mk <= 0 ||
      mk > kPosMask || static_cast<long long>(b) * mk > 0x7fffffffLL ||
      (elem_bytes != 4 && elem_bytes != 2) || width < 1 || wide < 1 || wide > 4 ||
      width > 32 * wide || static_cast<long long>(n) * ((c + width - 1) / width) > 0x7fffffffLL ||
      (budget != 0 && budget != 1)) {
    return cudaErrorInvalidValue;
  }
  int* counts = scratch;
  int* start = counts + static_cast<long long>(b) * ranges * chunks;
  int* grouped = start + static_cast<long long>(b) * ranges * chunks;
  int* lists = grouped + static_cast<long long>(b) * mk;
  int* first = lists + static_cast<long long>(b) * mk;
  int* last = first + static_cast<long long>(b) * n;
  const dim3 chunk_grid(chunks, b);
  count_kernel<<<chunk_grid, kThreads, sizeof(int) * ranges, st>>>(idx, mk, ranges, chunks, keep,
                                                                   counts);
  scan_kernel<<<b, kScanThreads, 0, st>>>(counts, start, ranges * chunks, mk);
  place_kernel<<<chunk_grid, kThreads, sizeof(int) * kWarps * ranges, st>>>(
      idx, mk, ranges, chunks, keep, start, grouped);
  lists_kernel<<<dim3(ranges, b), kThreads, 0, st>>>(grouped, counts, start, n, ranges, chunks,
                                                     lists, first, last);
  if (elem_bytes == 4) {
    budget ? launch_sums_wide<float, kTiles, true>(wide, g, lists, first, last, b, n, c, mk,
                                                   width, tile_positions, out, st)
           : launch_sums_wide<float, kTiles, false>(wide, g, lists, first, last, b, n, c, mk,
                                                    width, tile_positions, out, st);
  } else {
    budget ? launch_sums_wide<uint16_t, kTiles, true>(wide, g, lists, first, last, b, n, c, mk,
                                                      width, tile_positions, out, st)
           : launch_sums_wide<uint16_t, kTiles, false>(wide, g, lists, first, last, b, n, c, mk,
                                                       width, tile_positions, out, st);
  }
  return cudaGetLastError();
}

}  // namespace
