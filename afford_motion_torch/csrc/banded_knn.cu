// Windowed (banded) kNN on curve-sorted clouds: every tile of 128 queries
// looks only at a window of S consecutive support rows, [start, start + S).
//
// Replaces afford_motion_tpu/ops/pallas/banded.py (`knn_banded` ->
// `_knn_kernel`) and keeps its semantics exactly. d = ((qx-sx)^2 + (qy-sy)^2)
// + (qz-sz)^2 in f32; the low 13 mantissa bits of d's bit pattern are
// replaced by the WINDOW-LOCAL column 0..S-1 (not the absolute row); the k
// smallest of those unique int32 keys come out ascending; idx = local column
// + start, dist = sqrt of the key with the column bits cleared. `start` is
// read per tile from starts (G,) (stride 0 between clouds) or per cloud and
// tile from starts (B, G) (stride G). The TPU kernel finds the keys with k
// passes of min + mask over the (128, S) tile; since the keys are unique,
// any exact selection gives the same output, whatever the order in which
// the rows are visited and however the window is split (the k smallest of a
// union are the k smallest of the parts' k smallest).
//
// What bounds it on the H100: instruction issue. The rounding is the
// contract, so no FMA: a pair costs 3 subtractions, 3 products, 2 sums and a
// compare, against 128 lanes an SM a clock (the "no-FMA floor"). The first
// design (a thread a query walking the whole window, a sorted insertion of
// ~2-3 instructions a slot taken by a warp whenever any lane needed it, i.e.
// at nearly every row) spent ~60 instructions a pair, and its calls with few
// tiles ran 32-128 blocks of 4 warps. Here, after csrc/knn.cu:
//   - a block takes 32, 64 or 128 of a tile's queries (one a thread) over
//     `groups` parts of the window, part g the window's 4-row groups g,
//     g + groups, ...; so every call fills the card without a second kernel;
//   - the tile's window comes into shared memory by one bulk copy
//     (`cp.async.bulk` completing on an mbarrier) and is read by broadcast,
//     4 rows from three 16-byte words;
//   - a warp first finds where its 32 queries lie in the window (each lane
//     the nearest of every 32nd row, the warp their mean) and walks its
//     part's rows outward from there, so the k-th distances fall within the
//     first rows;
//   - a row is compared on the bits of d, not on the key: key < kth implies
//     bits(d) <= (kth | 0x1FFF), so the key is formed only for a candidate,
//     which goes to its query's queue in shared memory; one vote every 16
//     rows says whether any lane has one; only when some lane's queue is full
//     does the warp merge the queues into the sorted k-lists in registers
//     (the queue sorted by a network, then a bitonic merge) and lower the
//     thresholds;
//   - the groups' lists are merged in a tree in shared memory, each step by
//     the same bitonic merge.
// The k-list has KMAX slots, the first KMAX - k held by INT_MIN, so the k-th
// key is always slot KMAX - 1. `flushes`, when given, receives the number of
// queue merges the warps took (each of kCap entries a lane), for the record
// of how the time splits between the selection and the distances; the path
// passes none.
//
// d is formed with __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot contract
// it into an FMA: idx and dist must be bit-equal to the plain PyTorch
// version. starts are not range-checked (nor on the TPU): they must lie in
// [0, n - s].
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTileQueries = 128;  // TQ of the window policy
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kCap = 8;            // queue entries a query
constexpr int kMaxGroups = 16;     // parts of the window a block
constexpr int kSteps = 4;          // 4-row groups a vote

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int d_bits(float qx, float qy, float qz, float px, float py,
                                      float pz) {
  const float dx = __fsub_rn(qx, px), dy = __fsub_rn(qy, py), dz = __fsub_rn(qz, pz);
  return __float_as_int(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

__device__ __forceinline__ void cas(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// the queue's kCap = 8 entries sorted ascending (a 19-comparator network)
__device__ __forceinline__ void sort8(int (&q)[8]) {
  cas(q[0], q[2]); cas(q[1], q[3]); cas(q[4], q[6]); cas(q[5], q[7]);
  cas(q[0], q[4]); cas(q[1], q[5]); cas(q[2], q[6]); cas(q[3], q[7]);
  cas(q[0], q[1]); cas(q[2], q[3]); cas(q[4], q[5]); cas(q[6], q[7]);
  cas(q[2], q[4]); cas(q[3], q[5]);
  cas(q[1], q[4]); cas(q[3], q[6]);
  cas(q[1], q[2]); cas(q[3], q[4]); cas(q[5], q[6]);
}

// a bitonic sequence of KMAX keys sorted ascending by log2(KMAX)
// half-cleaners
template <int KMAX>
__device__ __forceinline__ void bitonic_sort(int (&best)[KMAX]) {
#pragma unroll
  for (int stride = KMAX / 2; stride > 0; stride /= 2) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if ((i & stride) == 0) cas(best[i], best[i + stride]);
    }
  }
}

// the query's queue merged into its sorted list: the queue sorted, then
// best[KMAX - 1 - i] = min(best[KMAX - 1 - i], q[i]) leaves the KMAX smallest
// of both as a bitonic sequence, which log2(KMAX) half-cleaners sort
template <int KMAX>
__device__ __forceinline__ void flush(int (&best)[KMAX], int& count, int& lim, const int* queue) {
  int q[kCap];
#pragma unroll
  for (int i = 0; i < kCap; ++i) q[i] = i < count ? queue[i * blockDim.x + threadIdx.x] : INT_MAX;
  sort8(q);
#pragma unroll
  for (int i = 0; i < kCap; ++i) best[KMAX - 1 - i] = min(best[KMAX - 1 - i], q[i]);
  bitonic_sort<KMAX>(best);
  count = 0;
  lim = best[KMAX - 1] | kIdxMask;
}

// another part's k keys (ascending, other[j * stride], j < k) merged into
// the list the same way: the KMAX - k INT_MIN slots stay in front
template <int KMAX>
__device__ __forceinline__ void merge_list(int (&best)[KMAX], const int* other, int stride,
                                           int k) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < k) best[KMAX - 1 - i] = min(best[KMAX - 1 - i], other[i * stride]);
  }
  bitonic_sort<KMAX>(best);
}

__device__ __forceinline__ void write_key(int key, int start, int* idx_out, float* dist_out) {
  *idx_out = (key & kIdxMask) + start;
  *dist_out = sqrtf(fmaxf(__int_as_float(key & ~kIdxMask), 0.f));
}

// up to 1024 threads a block (64 registers a thread) for k-lists of up to
// 16 slots, 512 for longer ones
template <int KMAX>
constexpr int max_threads() {
  return KMAX <= 16 ? 1024 : 512;
}

// the 4-row groups of the window, visited by part `part` of `parts`: the
// part holds groups part, part + parts, ... (n4 of them) and visits them
// outward from the one nearest `center` (a window row), alternately above
// and below (step t: its index among the part's groups, branch-free)
struct PartWalk {
  int mid, m, above;
  __device__ PartWalk(int n4, int parts, int part, int center) {
    mid = min(n4 - 1, max(0, center / 4 - part + parts / 2) / parts);
    m = min(mid, n4 - mid);      // steps taken on both sides in turn, each
    above = n4 - mid > mid;      // then the rest on the longer side
  }
  __device__ __forceinline__ int at(int t) const {
    const int both = (t & 1) ? mid - ((t + 1) >> 1) : mid + (t >> 1);
    const int one = above ? mid + t - m : mid - 1 - t + m;
    return t < 2 * m ? both : one;
  }
};

// grid (tiles * 128 / queries, b); block (tile * 128 / queries + slice, b)
// takes `queries` of its tile's 128 queries (thread t: query slice *
// queries + t % queries) over `groups` parts of the window (group g =
// t / queries takes part g), the window in shared memory. Each warp first
// finds where in the window its 32 queries lie: every lane the nearest of
// the rows 32 i + 16, the warp the mean of those rows; its walk starts
// there.
template <int KMAX>
__global__ void __launch_bounds__(max_threads<KMAX>())
knn_banded_kernel(const float* __restrict__ query, const float* __restrict__ support,
                  const int* __restrict__ starts, int starts_stride, int m, int n, int s, int k,
                  int queries, int groups, int* __restrict__ idx_out,
                  float* __restrict__ dist_out, unsigned long long* __restrict__ flushes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  const int b = blockIdx.y;
  const int slices = kTileQueries / queries;
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int group = threadIdx.x / queries, qb = threadIdx.x % queries;
  float* win = reinterpret_cast<float*>(smem);                               // 3 floats a row
  int* queue = reinterpret_cast<int*>(smem + static_cast<size_t>(s) * 12);   // kCap a thread
  const int start = starts[static_cast<size_t>(b) * starts_stride + tile];
  const float* src = support + (static_cast<size_t>(b) * n + start) * 3;
  const unsigned bytes = static_cast<unsigned>(s) * 12u;
  const bool bulk = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0;

  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(&bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(win)), "l"(src), "r"(bytes), "r"(smem_addr(&bar))
        : "memory");
  }
  const size_t row = static_cast<size_t>(b) * m + tile * kTileQueries + slice * queries + qb;
  const float qx = query[row * 3], qy = query[row * 3 + 1], qz = query[row * 3 + 2];
  if (!bulk) {   // a support tensor at an offset that leaves the rows unaligned
    for (int i = threadIdx.x; i < s * 3; i += blockDim.x) win[i] = src[i];
  }
  __syncthreads();
  if (bulk) {
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&bar)), "r"(0u)
          : "memory");
    }
  }

  // where the warp's queries lie in the window
  int near = INT_MAX, at = 0;
  for (int w = 16; w < s; w += 32) {
    const int bits = d_bits(qx, qy, qz, win[3 * w], win[3 * w + 1], win[3 * w + 2]);
    if (bits < near) {
      near = bits;
      at = w;
    }
  }
  const int center =
      static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(at)) / 32);

  int best[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) best[j] = j < KMAX - k ? INT_MIN : INT_MAX;
  int lim = INT_MAX, count = 0, flushed = 0;
  const float4* w4 = reinterpret_cast<const float4*>(win);
  const int n4 = s / (4 * groups);   // the part's 4-row groups, a multiple of kSteps
  const PartWalk walk(n4, groups, group, center);
  for (int t = 0; t < n4; t += kSteps) {
    // kSteps groups of 4 rows, then one vote on whether any lane has a
    // candidate among them (the least of their bits, as a tree)
    int r0[kSteps], bits[kSteps][4], least[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int g4 = group + groups * walk.at(t + j);
      r0[j] = 4 * g4;
      const float4 a = w4[3 * g4], e = w4[3 * g4 + 1], f = w4[3 * g4 + 2];
      const float px[4] = {a.x, a.w, e.z, f.y};
      const float py[4] = {a.y, e.x, e.w, f.z};
      const float pz[4] = {a.z, e.y, f.x, f.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) bits[j][u] = d_bits(qx, qy, qz, px[u], py[u], pz[u]);
      least[j] = min(min(bits[j][0], bits[j][1]), min(bits[j][2], bits[j][3]));
    }
#pragma unroll
    for (int w = 1; w < kSteps; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < kSteps; j += 2 * w) least[j] = min(least[j], least[j + w]);
    }
    if (__any_sync(0xFFFFFFFFu, least[0] <= lim)) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // against the threshold as the last flush left it
          if (bits[j][u] <= lim) {
            queue[count * blockDim.x + threadIdx.x] = (bits[j][u] & ~kIdxMask) | (r0[j] + u);
            ++count;
          }
          if (__any_sync(0xFFFFFFFFu, count == kCap)) {
            flush<KMAX>(best, count, lim, queue);
            ++flushed;
          }
        }
      }
    }
  }
  flush<KMAX>(best, count, lim, queue);
  if (flushes != nullptr && (threadIdx.x & 31) == 0) {
    atomicAdd(flushes, static_cast<unsigned long long>(flushed + 1));
  }

  // the groups' lists merged in a tree: in round r, group g (a multiple of
  // 2^(r+1)) takes in the list of group g + 2^r from shared memory, [group]
  // [j][query of the block], k keys each
  int* lists = reinterpret_cast<int*>(smem);
  for (int stride = 1; stride < groups; stride *= 2) {
    __syncthreads();   // the window, the queues or the last round's lists are done with
    if (group % (2 * stride) == stride) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i >= KMAX - k) lists[(group * k + i - (KMAX - k)) * queries + qb] = best[i];
      }
    }
    __syncthreads();
    if (group % (2 * stride) == 0) {
      merge_list<KMAX>(best, lists + (group + stride) * k * queries + qb, queries, k);
    }
  }
  if (group != 0) return;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i >= KMAX - k) {
      write_key(best[i], start, idx_out + row * k + i - (KMAX - k),
                dist_out + row * k + i - (KMAX - k));
    }
  }
}

// dynamic shared memory of a block: the window and the queues, or the
// groups' lists where those are larger
size_t smem_bytes(int s, int k, int queries, int groups) {
  const size_t threads = static_cast<size_t>(queries) * groups;
  const size_t scan = static_cast<size_t>(s) * 12 + sizeof(int) * kCap * threads;
  const size_t lists = groups > 1 ? sizeof(int) * k * threads : 0;
  return scan > lists ? scan : lists;
}

template <int KMAX>
cudaError_t launch(const float* q, const float* sup, const int* starts, int stride, int b, int m,
                   int n, int s, int k, int queries, int groups, int* idx, float* dist,
                   unsigned long long* flushes, cudaStream_t stream) {
  if (queries * groups > max_threads<KMAX>()) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, k, queries, groups);
  cudaError_t e = cudaFuncSetAttribute(knn_banded_kernel<KMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((m / kTileQueries) * (kTileQueries / queries), b);
  knn_banded_kernel<KMAX><<<grid, queries * groups, smem, stream>>>(
      q, sup, starts, stride, m, n, s, k, queries, groups, idx, dist, flushes);
  return cudaGetLastError();
}

}  // namespace

// query (b, m, 3), support (b, n, 3) f32; starts int32, (m / 128,) with
// starts_stride 0 or (b, m / 128) with starts_stride m / 128; s the window
// size; idx, dist (b, m, k). A block takes `queries` (32, 64 or 128) of a
// tile's queries over `groups` (1, 2, 4, 8 or 16) parts of the window, each
// a multiple of 16 rows; queries * groups threads, at most 1024 (512 for
// k > 16). flushes (optional, one uint64 on the device): += the queue
// merges the warps took, the last one included.
extern "C" int amt_knn_banded(const float* query, const float* support, const int* starts,
                              int starts_stride, int b, int m, int n, int s, int k, int queries,
                              int groups, int* idx, float* dist, unsigned long long* flushes,
                              void* stream) {
  if (b <= 0 || b > 65535 || m <= 0 || m % kTileQueries != 0 || n <= 0 || s <= 0 || s > n ||
      s > (1 << kIdxBits) || k <= 0 || k > s || k > 64 ||
      (starts_stride != 0 && starts_stride != m / kTileQueries) ||
      (queries != 32 && queries != 64 && queries != kTileQueries) ||
      (groups != 1 && groups != 2 && groups != 4 && groups != 8 && groups != kMaxGroups) ||
      s % (4 * kSteps * groups) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 8) {
    e = launch<8>(query, support, starts, starts_stride, b, m, n, s, k, queries, groups, idx,
                  dist, flushes, st);
  } else if (k <= 16) {
    e = launch<16>(query, support, starts, starts_stride, b, m, n, s, k, queries, groups, idx,
                   dist, flushes, st);
  } else if (k <= 32) {
    e = launch<32>(query, support, starts, starts_stride, b, m, n, s, k, queries, groups, idx,
                   dist, flushes, st);
  } else {
    e = launch<64>(query, support, starts, starts_stride, b, m, n, s, k, queries, groups, idx,
                   dist, flushes, st);
  }
  return static_cast<int>(e);
}
