// Fused distance + top-k with the packed-index key of the TPU kernel.
//
// Replaces afford_motion_tpu/ops/pallas/knn.py (`knn_pallas` ->
// `_knn_kernel`) and keeps its semantics exactly, which are NOT exact top-k:
// d = ((qx-sx)^2 + (qy-sy)^2) + (qz-sz)^2 in f32, the low 13 mantissa bits of
// d's bit pattern are replaced by the support index, and the k smallest of
// those unique int32 keys are returned in ascending order. idx is the key's
// low 13 bits, dist = sqrt of the key with those bits cleared. The TPU kernel
// finds them with k passes of int-min + mask; since the keys are unique, any
// exact selection of the k smallest keys gives the same output, whatever the
// order in which the pairs are visited and whichever pairs are skipped
// because they cannot enter the k smallest.
//
// What bounds it on the H100: instruction issue, not memory. The rounding is
// the contract, so no FMA and no GEMM expansion: a pair costs 3
// subtractions, 3 products, 2 sums and a compare, 9 FP32/INT32 instructions
// at 128 lanes an SM a clock, and a scan of all M*N pairs (2^31 at the
// 8192x8192 level at batch 32) cannot go below ~0.6 ms for that call. So the
// design visits fewer pairs:
//   - each cloud's support points and queries are first sorted by cell of
//     a 16^3 grid over the support's bounding box, the cells numbered along
//     a Morton curve (`amt_knn_order`: one block a cloud, a counting sort);
//     a warp takes 32 consecutive queries, which lie close together, and the
//     support comes in chunks of 32 consecutive points, each with its
//     bounding box;
//   - a warp visits the chunks outward from the one where its queries'
//     cells fall, two at a time, and skips a chunk when, for every lane, the
//     box's lower bound on d is above the lane's threshold. The bound is d's
//     own formula on the gaps between the query and the box, in the same
//     rounding: rounding is monotone, so it is at most the rounded d of
//     every point in the box, and the skip is exact. Near chunks come first,
//     so the thresholds fall fast and most far chunks are skipped; 1024
//     threads a block (one block an SM, as the cloud fills its shared
//     memory) hide the walk's latency better than 512;
//   - in a chunk the compare is against the bits of d, not the key: key <
//     kth implies bits(d) <= (kth | 0x1FFF), so the key (with the point's
//     original index) is formed only for a candidate. One warp vote a point
//     says whether any lane has one; a candidate goes to its query's queue
//     in shared memory (kCap entries), and only when some lane's queue is
//     full does the warp merge the queues into the sorted k-lists in
//     registers (a chain of min/max, 2 instructions a slot) and lower its
//     thresholds (the WarpSelect pattern);
//   - the block's share of the ordered support (all of it, or one of `split`
//     parts) and its original indices come into shared memory by bulk copies
//     (`cp.async.bulk` completing on one mbarrier); the boxes are computed
//     there. Calls with too few queries to fill the card split the support
//     into parts scanned by separate blocks; a second small kernel merges the
//     parts' k-lists exactly (the top k of a union is the top k of the union
//     of the parts' top k).
// `visits`, when given, receives the number of chunks the warps scanned
// (each 32 queries x 32 points): the share of the M*N pairs the kernel
// visits on this data, for the record; the path passes none.
// The k-list has KMAX slots, the first KMAX - k held by INT_MIN (no key is
// INT_MIN: d is never -0.0), so the k-th key is always slot KMAX - 1.
//
// d and the bound are formed with __fmul_rn / __fadd_rn / __fsub_rn so nvcc
// cannot contract them into an FMA: idx and dist must be bit-equal to the
// plain PyTorch version.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kChunk = 32;       // support points a box
constexpr int kCap = 8;          // queue entries a query
constexpr int kMaxThreads = 1024;
constexpr int kCells = 16;       // cells an axis of the curve order

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float sq_sum(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// sorted ascending insert of a key that is unique in the list (a key not
// below the last slot leaves the list as it is)
template <int KMAX>
__device__ __forceinline__ void insert(int (&best)[KMAX], int key) {
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j) best[j] = min(best[j], max(best[j - 1], key));
  best[0] = min(best[0], key);
}

template <int KMAX>
__device__ __forceinline__ void init_list(int (&best)[KMAX], int k) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) best[j] = j < KMAX - k ? INT_MIN : INT_MAX;
}

// the k real slots of a list, as idx and sqrt distance
template <int KMAX>
__device__ __forceinline__ void write_list(const int (&best)[KMAX], int k, int* idx_out,
                                           float* dist_out) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= KMAX - k) {
      idx_out[j - (KMAX - k)] = best[j] & kIdxMask;
      const float dq = __int_as_float(best[j] & ~kIdxMask);
      dist_out[j - (KMAX - k)] = sqrtf(fmaxf(dq, 0.f));
    }
  }
}

template <int KMAX>
__device__ __forceinline__ void flush(int (&best)[KMAX], int& count, int& lim, const int* queue) {
#pragma unroll
  for (int i = 0; i < kCap; ++i) {
    insert<KMAX>(best, i < count ? queue[i * blockDim.x + threadIdx.x] : INT_MAX);
  }
  count = 0;
  lim = best[KMAX - 1] | kIdxMask;
}

// the lower bound on d of the points of chunk c (its box's min and max
// corners at boxes[2c], boxes[2c + 1]) for a query: d's formula on the gaps
// between the query and the box, in d's rounding (c clamped to the part)
__device__ __forceinline__ int box_bound(const float4* boxes, int c, int chunks, float qx,
                                         float qy, float qz) {
  c = min(max(c, 0), chunks - 1);
  const float4 blo = boxes[2 * c], bhi = boxes[2 * c + 1];
  const float gx = fmaxf(fmaxf(__fsub_rn(blo.x, qx), __fsub_rn(qx, bhi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(blo.y, qy), __fsub_rn(qy, bhi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(blo.z, qz), __fsub_rn(qz, bhi.z)), 0.f);
  return __float_as_int(sq_sum(gx, gy, gz));
}

// 4 bits spread to every third bit
__device__ __forceinline__ int spread3(int v) {
  v &= 0xF;
  v = (v | (v << 4)) & 0x0C3;
  v = (v | (v << 2)) & 0x249;
  return v;
}

// the cell of a point in a box of kCells cells an axis, numbered along a
// Morton curve
__device__ __forceinline__ int cell_of(const float* p, const float* lo, const float* scale) {
  int code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float c = fminf(fmaxf((p[a] - lo[a]) * scale[a], 0.f), kCells - 1.f);
    code |= spread3(static_cast<int>(c)) << a;
  }
  return code;
}

// exclusive prefix sum of the kCells^3 counts in place, by a block of 1024
// threads: kCells^3 / 1024 consecutive counts a thread, then the threads'
// sums across each warp and the warps' sums across the block
__device__ void exclusive_scan(int* count, int* warp_sums) {
  constexpr int kPer = kCells * kCells * kCells / 1024;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int own = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) own += count[threadIdx.x * kPer + j];
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w - warp_sums[lane];  // exclusive
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - own;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int v = count[threadIdx.x * kPer + j];
    count[threadIdx.x * kPer + j] = run;
    run += v;
  }
  __syncthreads();
}

// a counting sort of n points by cell, in one block: cells out in cell
// order, `order` the points' indices, `sorted` (if given) their coordinates.
// Within a cell the order is whatever the atomics give: the selection does
// not depend on the order of the pairs.
__device__ void sort_by_cell(const float* p, int n, const float* lo, const float* scale,
                             int* count, int* warp_sums, int* cells, int* order, float* sorted) {
  for (int c = threadIdx.x; c < kCells * kCells * kCells; c += blockDim.x) count[c] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    atomicAdd(&count[cell_of(p + 3 * i, lo, scale)], 1);
  }
  __syncthreads();
  exclusive_scan(count, warp_sums);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int cell = cell_of(p + 3 * i, lo, scale);
    const int at = atomicAdd(&count[cell], 1);
    cells[at] = cell;
    order[at] = i;
    if (sorted != nullptr) {
      sorted[3 * at] = p[3 * i];
      sorted[3 * at + 1] = p[3 * i + 1];
      sorted[3 * at + 2] = p[3 * i + 2];
    }
  }
  __syncthreads();
}

// one block a cloud: the support's bounding box, then the support points and
// the queries sorted by cell of that box (queries outside it are clamped to
// its faces: their cells only choose where a warp starts)
__global__ void __launch_bounds__(1024)
order_kernel(const float* __restrict__ support, const float* __restrict__ query, int n, int m,
             float* __restrict__ ssorted, int* __restrict__ sorder, int* __restrict__ scells,
             int* __restrict__ qorder, int* __restrict__ qcells) {
  __shared__ float s_box[32][6];
  __shared__ float s_lo[3], s_scale[3];
  __shared__ int s_count[kCells * kCells * kCells];
  __shared__ int s_warp_sums[32];
  const int b = blockIdx.x;
  const float* s = support + static_cast<size_t>(b) * n * 3;
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], s[3 * i + a]);
      box[3 + a] = fmaxf(box[3 + a], s[3 * i + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      box[a] = fminf(box[a], __shfl_xor_sync(0xFFFFFFFFu, box[a], o));
      box[3 + a] = fmaxf(box[3 + a], __shfl_xor_sync(0xFFFFFFFFu, box[3 + a], o));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) s_box[threadIdx.x >> 5][a] = box[a];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float lo = INFINITY, hi = -INFINITY;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      lo = fminf(lo, s_box[w][threadIdx.x]);
      hi = fmaxf(hi, s_box[w][3 + threadIdx.x]);
    }
    s_lo[threadIdx.x] = lo;
    s_scale[threadIdx.x] = hi > lo ? kCells / (hi - lo) : 0.f;
  }
  __syncthreads();
  const size_t sb = static_cast<size_t>(b) * n, qb = static_cast<size_t>(b) * m;
  sort_by_cell(s, n, s_lo, s_scale, s_count, s_warp_sums, scells + sb, sorder + sb,
               ssorted + sb * 3);
  sort_by_cell(query + qb * 3, m, s_lo, s_scale, s_count, s_warp_sums, qcells + qb, qorder + qb,
               nullptr);
}

// grid (query blocks, split, b), one query a thread: thread t of block x
// takes the query at ordered position x * blockDim.x + t, i.e. query
// qorder[b, that position]. Part p of the ordered support is positions
// [p * part_len, (p + 1) * part_len) of ssorted / sorder / scells. split ==
// 1: writes idx and dist; else the part's k keys a query into part_keys
// (b, m, split, k). visits (if not null): += the chunks each warp scanned.
// up to 1024 threads a block (64 registers a thread) for k-lists of up to
// 16 slots, 512 for longer ones
template <int KMAX>
constexpr int max_threads() {
  return KMAX <= 16 ? 1024 : 512;
}

template <int KMAX>
__global__ void __launch_bounds__(max_threads<KMAX>())
knn_scan_kernel(const float* __restrict__ query, const int* __restrict__ qorder,
                const int* __restrict__ qcells, const float* __restrict__ ssorted,
                const int* __restrict__ sorder, const int* __restrict__ scells, int m, int n,
                int k, int part_len, int* __restrict__ idx_out, float* __restrict__ dist_out,
                int* __restrict__ part_keys, unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  const int b = blockIdx.z;
  const int part = blockIdx.y;
  const int split = gridDim.y;
  const int base = part * part_len;
  const int chunks = part_len / kChunk;
  float* cloud = reinterpret_cast<float*>(smem);                                  // 3 a point
  int* orig = reinterpret_cast<int*>(smem + static_cast<size_t>(part_len) * 12);  // 1 a point
  float4* boxes = reinterpret_cast<float4*>(orig + part_len);                     // 2 a chunk
  int* queue = reinterpret_cast<int*>(boxes + 2 * chunks);                        // kCap a thread

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const size_t first = static_cast<size_t>(b) * n + base;
    const unsigned cloud_bytes = static_cast<unsigned>(part_len) * 12u;
    const unsigned orig_bytes = static_cast<unsigned>(part_len) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(&bar)),
                 "r"(cloud_bytes + orig_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(cloud)), "l"(ssorted + first * 3), "r"(cloud_bytes), "r"(smem_addr(&bar))
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(orig)), "l"(sorder + first), "r"(orig_bytes), "r"(smem_addr(&bar))
        : "memory");
  }

  // the query, and where its warp starts: the chunk of the part in which
  // the cell of the warp's lane 16 falls (a binary search of the part's cells)
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const int qi = qorder[static_cast<size_t>(b) * m + min(pos, m - 1)];
  const float* qp = query + (static_cast<size_t>(b) * m + qi) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const int probe = qcells[static_cast<size_t>(b) * m + min((pos & ~31) + 16, m - 1)];
  const int* sc = scells + static_cast<size_t>(b) * n + base;
  int lo = 0, hi = part_len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sc[mid] < probe) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int start = min(lo / kChunk, chunks - 1);

  __syncthreads();  // the mbarrier is initialised
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
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    float4 lo4 = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    float4 hi4 = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
    for (int j = c * kChunk; j < (c + 1) * kChunk; ++j) {
      lo4.x = fminf(lo4.x, cloud[3 * j]);
      lo4.y = fminf(lo4.y, cloud[3 * j + 1]);
      lo4.z = fminf(lo4.z, cloud[3 * j + 2]);
      hi4.x = fmaxf(hi4.x, cloud[3 * j]);
      hi4.y = fmaxf(hi4.y, cloud[3 * j + 1]);
      hi4.z = fmaxf(hi4.z, cloud[3 * j + 2]);
    }
    boxes[2 * c] = lo4;
    boxes[2 * c + 1] = hi4;
  }
  __syncthreads();

  int best[KMAX];
  init_list<KMAX>(best, k);
  int lim = INT_MAX, count = 0, visited = 0;
  const float4* c4 = reinterpret_cast<const float4*>(cloud);
  // chunks outward from the start, two a step (start + off and start - 1 -
  // off, their bounds computed together); the second is tested against the
  // threshold as the first left it (a bound does not change)
  const int steps = max(chunks - start, start);
  for (int off = 0; off < steps; ++off) {
    const int up = start + off, down = start - 1 - off;
    const int bound_up = box_bound(boxes, up, chunks, qx, qy, qz);
    const int bound_down = box_bound(boxes, down, chunks, qx, qy, qz);
    for (int side = 0; side < 2; ++side) {
      const int c = side ? down : up;
      if (c < 0 || c >= chunks ||
          !__any_sync(0xFFFFFFFFu, (side ? bound_down : bound_up) <= lim)) {
        continue;
      }
      ++visited;
      // the chunk's points, 8 groups of four in three 16-byte words
      for (int g = 0; g < kChunk / 4; ++g) {
        const int w = 3 * (c * (kChunk / 4) + g);
        const float4 a = c4[w], e = c4[w + 1], f = c4[w + 2];
        const float px[4] = {a.x, a.w, e.z, f.y};
        const float py[4] = {a.y, e.x, e.w, f.z};
        const float pz[4] = {a.z, e.y, f.x, f.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int bits = __float_as_int(
              sq_sum(__fsub_rn(qx, px[u]), __fsub_rn(qy, py[u]), __fsub_rn(qz, pz[u])));
          const bool hit = bits <= lim;
          if (__any_sync(0xFFFFFFFFu, hit)) {
            if (hit) {
              queue[count * blockDim.x + threadIdx.x] =
                  (bits & ~kIdxMask) | orig[c * kChunk + 4 * g + u];
              ++count;
            }
            if (__any_sync(0xFFFFFFFFu, count == kCap)) flush<KMAX>(best, count, lim, queue);
          }
        }
      }
    }
  }
  flush<KMAX>(best, count, lim, queue);
  if (visits != nullptr && (threadIdx.x & 31) == 0) {
    atomicAdd(visits, static_cast<unsigned long long>(visited));
  }

  if (pos >= m) return;
  const size_t row = static_cast<size_t>(b) * m + qi;
  if (split == 1) {
    write_list<KMAX>(best, k, idx_out + row * k, dist_out + row * k);
  } else {
    int* o = part_keys + (row * split + part) * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= KMAX - k) o[j - (KMAX - k)] = best[j];
    }
  }
}

// one thread a query: the k smallest of its parts' k keys
template <int KMAX>
__global__ void __launch_bounds__(128)
knn_merge_kernel(const int* __restrict__ part_keys, long long rows, int split, int k,
                 int* __restrict__ idx_out, float* __restrict__ dist_out) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  int best[KMAX];
  init_list<KMAX>(best, k);
  const int* keys = part_keys + row * split * k;
  for (int i = 0; i < split * k; ++i) insert<KMAX>(best, keys[i]);
  write_list<KMAX>(best, k, idx_out + row * k, dist_out + row * k);
}

template <int KMAX>
cudaError_t launch(const float* query, const int* qorder, const int* qcells,
                   const float* ssorted, const int* sorder, const int* scells, int b, int m,
                   int n, int k, int threads, int split, int* idx, float* dist, int* part_keys,
                   unsigned long long* visits, cudaStream_t stream) {
  const int part_len = n / split;
  const size_t smem = static_cast<size_t>(part_len) * 16 +
                      sizeof(float4) * 2 * (part_len / kChunk) + sizeof(int) * kCap * threads;
  cudaError_t e = cudaFuncSetAttribute(knn_scan_kernel<KMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (threads > max_threads<KMAX>()) return cudaErrorInvalidValue;
  const dim3 grid((m + threads - 1) / threads, split, b);
  knn_scan_kernel<KMAX><<<grid, threads, smem, stream>>>(query, qorder, qcells, ssorted, sorder,
                                                         scells, m, n, k, part_len, idx, dist,
                                                         part_keys, visits);
  if (split > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long rows = static_cast<long long>(b) * m;
    knn_merge_kernel<KMAX><<<static_cast<unsigned>((rows + 127) / 128), 128, 0, stream>>>(
        part_keys, rows, split, k, idx, dist);
  }
  return cudaGetLastError();
}

}  // namespace

// support (b, n, 3), query (b, m, 3) f32 -> each cloud's support points and
// queries in cell order over the support's bounding box (16 cells an axis,
// numbered along a Morton curve): ssorted (b, n, 3) the points, sorder
// (b, n) and qorder (b, m) int32 the original indices, scells (b, n) and
// qcells (b, m) int32 the cells, ascending.
extern "C" int amt_knn_order(const float* support, const float* query, int b, int n, int m,
                             float* ssorted, int* sorder, int* scells, int* qorder, int* qcells,
                             void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  order_kernel<<<b, 1024, 0, static_cast<cudaStream_t>(stream)>>>(support, query, n, m, ssorted,
                                                                  sorder, scells, qorder, qcells);
  return static_cast<int>(cudaGetLastError());
}

// query (b, m, 3) f32; qorder (b, m) int32, each cloud's queries in cell
// order, and qcells (b, m) int32 their cells in that order; ssorted (b, n, 3)
// f32 the support in cell order, sorder (b, n) int32 its original indices,
// scells (b, n) int32 its cells, ascending (all from `amt_knn_order`);
// ssorted and sorder 16-byte aligned. idx, dist (b, m, k). `threads` a
// block (a multiple of 32, at most 1024, 512 for k > 16); split parts of the
// support (n / split a multiple of 32), each a block's; part_keys
// (b, m, split, k) int32 scratch when split > 1; visits (optional, one
// uint64 on the device): += the 32x32-pair chunks the warps scanned.
extern "C" int amt_knn_packed(const float* query, const int* qorder, const int* qcells,
                              const float* ssorted, const int* sorder, const int* scells, int b,
                              int m, int n, int k, int threads, int split, int* part_keys,
                              int* idx, float* dist, unsigned long long* visits, void* stream) {
  if (b <= 0 || b > 65535 || m <= 0 || n <= 0 || n > (1 << kIdxBits) || k <= 0 || k >= n ||
      k > 64 || threads <= 0 || threads > kMaxThreads || threads % 32 != 0 || split <= 0 ||
      n % split != 0 || (n / split) % kChunk != 0 || (split > 1 && part_keys == nullptr) ||
      reinterpret_cast<uintptr_t>(ssorted) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sorder) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 8) {
    e = launch<8>(query, qorder, qcells, ssorted, sorder, scells, b, m, n, k, threads, split, idx,
                  dist, part_keys, visits, st);
  } else if (k <= 16) {
    e = launch<16>(query, qorder, qcells, ssorted, sorder, scells, b, m, n, k, threads, split,
                   idx, dist, part_keys, visits, st);
  } else if (k <= 32) {
    e = launch<32>(query, qorder, qcells, ssorted, sorder, scells, b, m, n, k, threads, split,
                   idx, dist, part_keys, visits, st);
  } else {
    e = launch<64>(query, qorder, qcells, ssorted, sorder, scells, b, m, n, k, threads, split,
                   idx, dist, part_keys, visits, st);
  }
  return static_cast<int>(e);
}
