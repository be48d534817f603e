// Fused exact 1-NN of every scene point against each frame's body vertices.
//
// Replaces afford_motion_tpu/ops/pallas/sdf.py (`nn1_pallas` -> `_nn1_kernel`):
// per frame f and query point o, d2[f, o] = min over vertices h of
// ((dx*dx + dy*dy) + dz*dz) in f32 with every step rounded, and idx[f, o] the
// smallest vertex index that attains that minimum. The TPU kernel scans
// every vertex of every frame in index order; here the result is the same
// whatever order the vertices are visited in and whichever are skipped
// because they cannot win, so the kernel visits few of them.
//
// What bounds it on the H100: a dense scan of the L*O*H pairs (1.7e10 a
// 196-frame sequence at O=8192, H=10475) at 8 f32 operations a pair takes
// 2.0 ms at the card's 67 TFLOP/s. The skip of pairs below is exact, so no
// count of pairs bounds every exact algorithm: the bound is the bytes (the
// points, the vertices, d2 and idx: 37.5 MB there, 0.011 ms at 3.35 TB/s).
// Design:
//   - `nn1_sort_kernel`, one block a cloud (every frame's vertices, and the
//     scene points once, since they are the same for every frame): a
//     counting sort by cell of a 16^3 grid over the cloud's bounding box,
//     the cells numbered along a Morton curve, out as float4 (x, y, z, the
//     original index's bits). For a frame also a box per group of 32
//     consecutive sorted vertices. Grouping is spatial, not by index: a
//     group's vertices lie in one or a few neighbouring cells whatever the
//     mesh's vertex order.
//   - `nn1_scan_kernel`, a block (1024 threads, one query a thread) per
//     1024 consecutive sorted scene points and frame: the warp's 32 queries
//     are neighbours. The frame's sorted vertices and boxes come into shared
//     memory by bulk copies (`cp.async.bulk` completing on an mbarrier), in
//     parts of at most kPartCap vertices; boxes of 8 groups are formed there.
//     Each warp first visits the group whose box is nearest its lane 16's
//     query, then walks the boxes of 8 groups outward from the one holding
//     it, and in each the groups in order. A box is skipped when, for every
//     lane, its lower bound is strictly above the lane's best d2. The bound
//     is d2's own formula on the gaps between the query and the box, in the
//     same rounding: rounding to nearest is monotone, so the bound is at
//     most the rounded d2 of every vertex in the box. A box whose bound
//     equals the best may hold a tie with a smaller index, so it is visited.
//   - in a visited group the inner loop takes a vertex when d < best, or
//     d == best and its index is smaller than the best's, so a tie goes to
//     the smallest index in any visiting order. (Keeping only the minimum
//     in the loop and scanning a group again for its index where it
//     improved the best evaluated 51-59% of the visited pairs twice and was
//     9-14% slower on an H100 at 700 W.)
// `visits`, when given, receives the vertex-query pairs the warps evaluated,
// for the record; the path passes none.
//
// d2 and the bound are formed with __fsub_rn / __fmul_rn / __fadd_rn so nvcc
// cannot contract them into an FMA: d2 and idx must be bit-equal to the
// plain PyTorch version. Inputs must be NaN-free.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kCells = 16;         // cells an axis of the curve order
constexpr int kGroup = 32;         // vertices a box
constexpr int kSuper = 8;          // groups a box of boxes
constexpr int kThreads = 1024;     // threads of both kernels; one query a thread in the scan
constexpr int kPartCap = 12288;    // vertices a block holds in shared memory at once
constexpr int kMaxSupers = kPartCap / (kGroup * kSuper);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float sq_sum(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, const float4& v) {
  return sq_sum(__fsub_rn(qx, v.x), __fsub_rn(qy, v.y), __fsub_rn(qz, v.z));
}

// the lower bound on d2 of the vertices in the box (lo, hi) for a query
__device__ __forceinline__ float box_bound(const float4& lo, const float4& hi, float qx,
                                           float qy, float qz) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.f);
  return sq_sum(gx, gy, gz);
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
  constexpr int kPer = kCells * kCells * kCells / kThreads;
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

// block f < l: frame f's h vertices into vsorted (l, h) and its group boxes
// into boxes (l, groups, 2); block l: the o points into psorted (o). Each
// cloud by cell of its own bounding box; within a cell the order is
// whatever the atomics give (the result does not depend on it).
__global__ void __launch_bounds__(kThreads)
nn1_sort_kernel(const float* __restrict__ points, const float* __restrict__ verts, int l, int o,
                int h, float4* __restrict__ psorted, float4* __restrict__ vsorted,
                float4* __restrict__ boxes) {
  __shared__ float s_box[32][6];
  __shared__ float s_lo[3], s_scale[3];
  __shared__ int s_count[kCells * kCells * kCells];
  __shared__ int s_warp_sums[32];
  const int f = blockIdx.x;
  const bool frame = f < l;
  const int n = frame ? h : o;
  const float* p = frame ? verts + static_cast<size_t>(f) * h * 3 : points;
  float4* sorted = frame ? vsorted + static_cast<size_t>(f) * h : psorted;

  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n; i += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], p[3 * i + a]);
      box[3 + a] = fmaxf(box[3 + a], p[3 * i + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int s = 16; s > 0; s >>= 1) {
      box[a] = fminf(box[a], __shfl_xor_sync(0xFFFFFFFFu, box[a], s));
      box[3 + a] = fmaxf(box[3 + a], __shfl_xor_sync(0xFFFFFFFFu, box[3 + a], s));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) s_box[threadIdx.x >> 5][a] = box[a];
  }
  for (int c = threadIdx.x; c < kCells * kCells * kCells; c += kThreads) s_count[c] = 0;
  __syncthreads();
  if (threadIdx.x < 3) {
    float lo = INFINITY, hi = -INFINITY;
    for (int w = 0; w < kThreads / 32; ++w) {
      lo = fminf(lo, s_box[w][threadIdx.x]);
      hi = fmaxf(hi, s_box[w][3 + threadIdx.x]);
    }
    s_lo[threadIdx.x] = lo;
    s_scale[threadIdx.x] = hi > lo ? kCells / (hi - lo) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    atomicAdd(&s_count[cell_of(p + 3 * i, s_lo, s_scale)], 1);
  }
  __syncthreads();
  exclusive_scan(s_count, s_warp_sums);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int at = atomicAdd(&s_count[cell_of(p + 3 * i, s_lo, s_scale)], 1);
    sorted[at] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], __int_as_float(i));
  }
  if (!frame) return;
  __syncthreads();  // the frame's sorted vertices are written
  const int groups = (h + kGroup - 1) / kGroup;
  float4* fb = boxes + static_cast<size_t>(f) * groups * 2;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
    for (int j = g * kGroup; j < min(h, (g + 1) * kGroup); ++j) {
      const float4 v = sorted[j];
      lo.x = fminf(lo.x, v.x), lo.y = fminf(lo.y, v.y), lo.z = fminf(lo.z, v.z);
      hi.x = fmaxf(hi.x, v.x), hi.y = fmaxf(hi.y, v.y), hi.z = fmaxf(hi.z, v.z);
    }
    fb[2 * g] = lo;
    fb[2 * g + 1] = hi;
  }
}

// the query's (best, index) after the cnt vertices at gv: d < best, or
// d == best and index < best index, takes the vertex
__device__ __forceinline__ void scan_group(const float4* gv, int cnt, float qx, float qy,
                                           float qz, float& best, int& besti) {
#pragma unroll 8
  for (int t = 0; t < cnt; ++t) {
    const float4 v = gv[t];
    const float d = dist2(qx, qy, qz, v);
    const int i = __float_as_int(v.w);
    if (d < best || (d == best && i < besti)) {
      best = d;
      besti = i;
    }
  }
}

// grid (query blocks, frames): thread t of block x takes the sorted point at
// position x * kThreads + t
__global__ void __launch_bounds__(kThreads, 1)
nn1_scan_kernel(const float4* __restrict__ psorted, const float4* __restrict__ vsorted,
                const float4* __restrict__ boxes, int o, int h, float* __restrict__ d2_out,
                int* __restrict__ idx_out, unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float4 s_super[2 * kMaxSupers];
  __shared__ unsigned long long bar;
  const int f = blockIdx.y, lane = threadIdx.x & 31;
  const int groups = (h + kGroup - 1) / kGroup;
  const int cap = min(h, kPartCap);
  float4* sv = reinterpret_cast<float4*>(smem);                                   // vertices
  float4* sb = sv + (cap + kGroup - 1) / kGroup * kGroup;                         // group boxes
  const float4* fv = vsorted + static_cast<size_t>(f) * h;
  const float4* fb = boxes + static_cast<size_t>(f) * groups * 2;

  const int pos = blockIdx.x * kThreads + threadIdx.x;
  const bool live = pos < o;
  const float4 q = psorted[min(pos, o - 1)];
  const float qx = q.x, qy = q.y, qz = q.z;
  const float px = __shfl_sync(0xFFFFFFFFu, qx, 16), py = __shfl_sync(0xFFFFFFFFu, qy, 16),
              pz = __shfl_sync(0xFFFFFFFFu, qz, 16);
  const int live_lanes = __popc(__ballot_sync(0xFFFFFFFFu, live));
  float best = INFINITY;
  int besti = INT_MAX;
  unsigned long long seen = 0;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int base = 0, part = 0; base < h; base += kPartCap, ++part) {
    const int len = min(kPartCap, h - base), pg = (len + kGroup - 1) / kGroup;
    const int supers = (pg + kSuper - 1) / kSuper;
    __syncthreads();  // the mbarrier is initialised; the last part's readers are done
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const unsigned vbytes = static_cast<unsigned>(len) * 16u;
      const unsigned bbytes = static_cast<unsigned>(pg) * 32u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(&bar)),
                   "r"(vbytes + bbytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(sv)),
          "l"(fv + base), "r"(vbytes), "r"(smem_addr(&bar))
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(sb)),
          "l"(fb + 2 * (base / kGroup)), "r"(bbytes), "r"(smem_addr(&bar))
          : "memory");
    }
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&bar)), "r"(static_cast<unsigned>(part & 1))
          : "memory");
    }
    for (int s = threadIdx.x; s < supers; s += kThreads) {
      float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
      for (int g = s * kSuper; g < min(pg, (s + 1) * kSuper); ++g) {
        const float4 a = sb[2 * g], b = sb[2 * g + 1];
        lo.x = fminf(lo.x, a.x), lo.y = fminf(lo.y, a.y), lo.z = fminf(lo.z, a.z);
        hi.x = fmaxf(hi.x, b.x), hi.y = fmaxf(hi.y, b.y), hi.z = fmaxf(hi.z, b.z);
      }
      s_super[2 * s] = lo;
      s_super[2 * s + 1] = hi;
    }
    __syncthreads();

    // the start: the group whose box is nearest the warp's lane 16 query
    float near = INFINITY;
    int start = 0;
    for (int g = lane; g < pg; g += 32) {
      const float b = box_bound(sb[2 * g], sb[2 * g + 1], px, py, pz);
      if (b < near) near = b, start = g;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float nb = __shfl_xor_sync(0xFFFFFFFFu, near, s);
      const int ns = __shfl_xor_sync(0xFFFFFFFFu, start, s);
      if (nb < near || (nb == near && ns < start)) near = nb, start = ns;
    }
    // the start first, then boxes of 8 groups outward from the start's, each
    // tested for every lane before its groups are
    if (__any_sync(0xFFFFFFFFu,
                   box_bound(sb[2 * start], sb[2 * start + 1], qx, qy, qz) <= best)) {
      const int cnt = min(kGroup, len - start * kGroup);
      seen += cnt;
      scan_group(sv + start * kGroup, cnt, qx, qy, qz, best, besti);
    }
    const int first = start / kSuper;
    const int steps = max(supers - first, first + 1);
    for (int off = 0; off < steps; ++off) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int s = side ? first - off : first + off;
        if ((side && off == 0) || s < 0 || s >= supers) continue;
        if (!__any_sync(0xFFFFFFFFu,
                        box_bound(s_super[2 * s], s_super[2 * s + 1], qx, qy, qz) <= best)) {
          continue;
        }
        for (int g = s * kSuper; g < min(pg, (s + 1) * kSuper); ++g) {
          if (g == start || !__any_sync(0xFFFFFFFFu, box_bound(sb[2 * g], sb[2 * g + 1], qx, qy,
                                                                qz) <= best)) {
            continue;
          }
          const int cnt = min(kGroup, len - g * kGroup);
          seen += cnt;
          scan_group(sv + g * kGroup, cnt, qx, qy, qz, best, besti);
        }
      }
    }
  }
  if (visits != nullptr && lane == 0) atomicAdd(visits, seen * live_lanes);
  if (!live) return;
  const int qi = __float_as_int(q.w);
  d2_out[static_cast<size_t>(f) * o + qi] = best;
  idx_out[static_cast<size_t>(f) * o + qi] = besti;
}

struct Scratch {
  size_t vsorted, boxes, bytes;
};

// the scratch of one call: the sorted points (o float4), the sorted vertices
// (l, h float4), the group boxes (l, groups, 2 float4)
Scratch scratch_of(int l, int o, int h) {
  const auto up = [](size_t x) { return (x + 127) / 128 * 128; };
  Scratch s{};
  s.vsorted = up(static_cast<size_t>(o) * 16);
  s.boxes = up(s.vsorted + static_cast<size_t>(l) * h * 16);
  s.bytes = s.boxes + static_cast<size_t>(l) * ((h + kGroup - 1) / kGroup) * 32;
  return s;
}

}  // namespace

// bytes of scratch amt_nn1 needs
extern "C" long long amt_nn1_scratch(int l, int o, int h) {
  return static_cast<long long>(scratch_of(l, o, h).bytes);
}

// points (O, 3) f32, verts (L, H, 3) f32 -> d2 (L, O) f32, idx (L, O) i32;
// scratch of amt_nn1_scratch bytes (16-byte aligned); visits (optional, one
// uint64 on the device): += the vertex-query pairs evaluated.
extern "C" int amt_nn1(const float* points, const float* verts, int l, int o, int h,
                       void* scratch, float* d2, int* idx, unsigned long long* visits,
                       void* stream) {
  if (l <= 0 || o <= 0 || h <= 0 || l > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const Scratch at = scratch_of(l, o, h);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float4* ps = reinterpret_cast<float4*>(base);
  float4* vs = reinterpret_cast<float4*>(base + at.vsorted);
  float4* bx = reinterpret_cast<float4*>(base + at.boxes);
  nn1_sort_kernel<<<l + 1, kThreads, 0, st>>>(points, verts, l, o, h, ps, vs, bx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cap = min(h, kPartCap);
  const int vcap = (cap + kGroup - 1) / kGroup * kGroup;
  const size_t smem = static_cast<size_t>(vcap) * 16 + static_cast<size_t>(vcap / kGroup) * 32;
  e = cudaFuncSetAttribute(nn1_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((o + kThreads - 1) / kThreads, l);
  nn1_scan_kernel<<<grid, kThreads, smem, st>>>(ps, vs, bx, o, h, d2, idx, visits);
  return static_cast<int>(cudaGetLastError());
}
