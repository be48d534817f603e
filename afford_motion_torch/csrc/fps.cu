// Greedy farthest point sampling for a batch of clouds.
//
// Replaces the TPU kernel afford_motion_tpu/ops/pallas/fps.py
// (`fps_pallas` -> `_fps_batched_kernel`; at B = 1 also `_fps_kernel`). Same
// selection rule: index 0 is picked first, the running min-distance field
// starts at +inf, each step folds d = (dx*dx + dy*dy) + dz*dz into the field
// and picks the FIRST index of its maximum.
//
// What bounds it on the H100: the M-1 picks are strictly sequential, so the
// cost is M times the latency of one pick (a min-fold and an argmax over N
// points), not bytes or FLOPs. One SM issues the ~12 instructions a point of
// a whole 8192-point cloud in ~770 cycles, so the cloud is spread over a
// thread block cluster of several blocks, and what is left is the latency
// of the exchange between them.
//
// Design, per pick:
//   - every block holds the whole cloud in shared memory (x, y and z planes,
//     96 KB at N = 8192), so the winner's coordinates are a shared-memory
//     broadcast, not a global load; each thread keeps its own points and
//     their field values in registers for the whole loop;
//   - (value, index) is one ordered 64-bit key: the field value's bits on top
//     (a non-negative float, +inf included, orders as its unsigned bits) and
//     0xFFFFFFFF - index below, so the largest key is the largest value and,
//     among equal values, the smallest index. A slot past N has key 0, below
//     every real point (whose low word is never 0);
//   - a warp reduces the key with two `redux.sync` maxima (the high words,
//     then the low words of the lanes that hold that high word);
//   - the warps' partial keys of the cluster meet in every block: lane r < 4
//     of each warp sends its key into block r with `st.async`, which counts
//     its bytes on that block's mbarrier, and every thread waits on its own
//     block's mbarrier, with no barrier across the cluster. The keys land in
//     the half of a double buffer chosen by the pick's parity, so a pick needs
//     one wait: after it every warp reduces the 32 partials itself, and no
//     second barrier and no broadcast slot are needed. Thread 0 arms the
//     half's mbarrier for its next phase as soon as it has seen this one
//     complete; a block may send pick s + 2's keys into a half only after it
//     has every key of pick s + 1, which each warp of each block sends after
//     reading pick s's half (and after that arming).
// 256 threads a block and 4 blocks a cloud, 8 points a thread: the fastest of
// the sizes and exchanges measured (PERF.md). The blocks of a cluster may
// share an SM.
//
// d is formed with __fsub_rn / __fmul_rn / __fadd_rn so nvcc cannot contract
// it into an FMA: the picks must be bit-equal to the plain PyTorch version.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPoints = 8192;

constexpr int kThreads = 256;                                  // a block
constexpr int kCluster = 4;                                    // blocks a cloud
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kMaxPoints / (kThreads * kCluster);    // point slots a thread
constexpr unsigned kKeyBytes = kWarps * kCluster * 8;         // the keys of one pick
static_assert(kWarps * kCluster == 32, "one partial key a lane");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// arrive on an mbarrier's current phase and add the bytes that must land
// before it completes
__device__ __forceinline__ void expect_keys(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m, int* __restrict__ out) {
  extern __shared__ float s_xyz[];  // x[n], y[n], z[n]
  __shared__ unsigned long long s_part[2][32];
  __shared__ unsigned long long s_bar[2];

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cloud = blockIdx.x / kCluster;
  const float* p = xyz + static_cast<size_t>(cloud) * n * 3;
  int* o = out + static_cast<size_t>(cloud) * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 3 * n; i += kThreads) s_xyz[(i % 3) * n + i / 3] = p[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&s_bar[i]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2; ++i) expect_keys(&s_bar[i], kKeyBytes);
  }
  __syncthreads();
  const float* sx = s_xyz;
  const float* sy = s_xyz + n;
  const float* sz = s_xyz + 2 * n;

  // slot j of this thread holds point j * 1024 + rank * 256 + thread: j
  // ascends with the index, so a strict > keeps the first maximal one
  constexpr int kSpan = kThreads * kCluster;
  const int first = rank * kThreads + threadIdx.x;
  const int used = (n + kSpan - 1) / kSpan;  // slots in use, the same in every block
  float px[kSlots], py[kSlots], pz[kSlots], md[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = first + j * kSpan;
    const bool valid = i < n;
    px[j] = valid ? sx[i] : 0.f;
    py[j] = valid ? sy[i] : 0.f;
    pz[j] = valid ? sz[i] : 0.f;
    // below every real distance, and min(-1, d) stays -1: never picked
    md[j] = valid ? CUDART_INF_F : -1.f;
  }
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  // every block of the cluster has started (and set up its mbarriers) before
  // any writes into another's shared memory
  cg::this_cluster().sync();

  int last = 0;
  for (int step = 1; step < m; ++step) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float best = -1.f;
    int best_j = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j < used) {
        const float dx = __fsub_rn(px[j], lx);
        const float dy = __fsub_rn(py[j], ly);
        const float dz = __fsub_rn(pz[j], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        md[j] = fminf(md[j], d);
        if (md[j] > best) {
          best = md[j];
          best_j = j;
        }
      }
    }
    // the thread's key; a thread with no real point gives 0
    const bool real = best >= 0.f;
    unsigned hi = real ? __float_as_uint(best) : 0u;
    unsigned lo = real ? 0xFFFFFFFFu - static_cast<unsigned>(first + best_j * kSpan) : 0u;
    unsigned top = __reduce_max_sync(0xFFFFFFFFu, hi);
    lo = __reduce_max_sync(0xFFFFFFFFu, hi == top ? lo : 0u);
    const unsigned long long key = (static_cast<unsigned long long>(top) << 32) | lo;
    const int slot = rank * kWarps + warp;
    const int par = step & 1;
    if (lane < kCluster) {
      unsigned dst, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(dst)
                   : "r"(smem_addr(&s_part[par][slot])), "r"(lane));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(bar)
                   : "r"(smem_addr(&s_bar[par])), "r"(lane));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(dst),
          "l"(key), "r"(bar)
          : "memory");
    }
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&s_bar[par])), "r"(((step - 1) >> 1) & 1)
          : "memory");
    }
    // the half's next phase, two picks on
    if (threadIdx.x == 0) expect_keys(&s_bar[par], kKeyBytes);
    // every warp reduces the cluster's 32 partials
    const unsigned long long mine = s_part[par][lane];
    hi = static_cast<unsigned>(mine >> 32);
    top = __reduce_max_sync(0xFFFFFFFFu, hi);
    lo = __reduce_max_sync(0xFFFFFFFFu, hi == top ? static_cast<unsigned>(mine) : 0u);
    last = static_cast<int>(0xFFFFFFFFu - lo);
    if (rank == 0 && threadIdx.x == 0) o[step] = last;
  }
  // no block leaves while another may still write into it
  cg::this_cluster().sync();
}

}  // namespace

extern "C" int amt_fps(const float* xyz, int b, int n, int m, int* out, void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxPoints || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(n);
  cudaError_t e = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fps_kernel, xyz, n, m, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
