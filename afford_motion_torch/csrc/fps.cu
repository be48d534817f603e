// Greedy farthest point sampling for a batch of clouds.
//
// Replaces the TPU kernel afford_motion_tpu/ops/pallas/fps.py
// (`fps_pallas` -> `_fps_batched_kernel`). Same selection rule: index 0 is
// picked first, the running min-distance field starts at +inf, each step
// folds d = (dx*dx + dy*dy) + dz*dz into the field and picks the FIRST index
// of its maximum.
//
// What bounds it on the H100: the M-1 steps are strictly sequential, so the
// cost is the latency of one step (a block-wide argmax over N points) times
// M, not bytes or FLOPs; at B=32 only 32 of the 132 SMs have work.
// Design: one block per cloud, 1024 threads, each thread keeps its (up to 8)
// points and their min-field values in registers for the whole loop, so a
// step touches no memory except the last pick's 12 bytes (an L1 broadcast)
// and two barriers of the warp-shuffle + shared-memory argmax.
//
// d is formed with __fmul_rn / __fadd_rn so nvcc cannot contract it into an
// FMA: the picks must be bit-equal to the plain PyTorch version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPointsPerThread = 8;  // N <= 8192

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m, int* __restrict__ out) {
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * m;

  float px[kPointsPerThread], py[kPointsPerThread], pz[kPointsPerThread];
  float md[kPointsPerThread];
#pragma unroll
  for (int j = 0; j < kPointsPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const bool valid = i < n;
    px[j] = valid ? p[3 * i + 0] : 0.f;
    py[j] = valid ? p[3 * i + 1] : 0.f;
    pz[j] = valid ? p[3 * i + 2] : 0.f;
    // padding slots sit below every real distance and are never picked
    md[j] = valid ? CUDART_INF_F : -1.f;
  }

  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) o[0] = 0;
  int last = 0;
  for (int step = 1; step < m; ++step) {
    const float lx = p[3 * last + 0];
    const float ly = p[3 * last + 1];
    const float lz = p[3 * last + 2];
    float best = -2.f;
    int best_i = n;
#pragma unroll
    for (int j = 0; j < kPointsPerThread; ++j) {
      const float dx = __fsub_rn(px[j], lx);
      const float dy = __fsub_rn(py[j], ly);
      const float dz = __fsub_rn(pz[j], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (md[j] >= 0.f) md[j] = fminf(md[j], d);
      // j ascends with the point index, so a strict > keeps the first one
      if (md[j] > best) {
        best = md[j];
        best_i = threadIdx.x + j * kThreads;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_merge(best, best_i, __shfl_xor_sync(0xffffffffu, best, off),
                   __shfl_xor_sync(0xffffffffu, best_i, off));
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      best_i = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_merge(best, best_i, __shfl_xor_sync(0xffffffffu, best, off),
                     __shfl_xor_sync(0xffffffffu, best_i, off));
      }
      if (lane == 0) {
        s_last = best_i;
        o[step] = best_i;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

extern "C" int amt_fps(const float* xyz, int b, int n, int m, int* out, void* stream) {
  if (b <= 0 || n <= 0 || n > kThreads * kPointsPerThread || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fps_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xyz, n, m, out);
  return static_cast<int>(cudaGetLastError());
}
