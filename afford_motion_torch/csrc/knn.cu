// Fused distance + top-k with the packed-index key of the TPU kernel.
//
// Replaces afford_motion_tpu/ops/pallas/knn.py (`knn_pallas` ->
// `_knn_kernel`) and keeps its semantics exactly, which are NOT exact top-k:
// d = ((qx-sx)^2 + (qy-sy)^2) + (qz-sz)^2 in f32, the low 13 mantissa bits of
// d's bit pattern are replaced by the support index, and the k smallest of
// those unique int32 keys are returned in ascending order. idx is the key's
// low 13 bits, dist = sqrt of the key with those bits cleared. The TPU kernel
// finds them with k passes of int-min + mask; since the keys are unique, any
// exact selection of the k smallest keys gives the same output.
//
// What bounds it on the H100: the M*N distance evaluations (2^31 at the
// 8192x8192 level at batch 32), i.e. ALU issue, not memory: the inputs are
// 12 bytes a point and the (M, N) distance matrix never exists.
// Design: one query per thread, 128 queries per block. The block streams
// its cloud's support points through shared memory in tiles (every thread
// reads the same point: a broadcast, no bank conflicts), and each thread
// keeps its k smallest keys in registers as a sorted array, updated by a
// branch-free insertion only when a key beats the current k-th (rare after
// the first few hundred points).
//
// d is formed with __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot contract
// it into an FMA: idx and dist must be bit-equal to the plain PyTorch version.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_packed_kernel(const float* __restrict__ query, const float* __restrict__ support,
                  int m, int n, int k, int* __restrict__ idx_out,
                  float* __restrict__ dist_out) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < m;
  const float* q = query + (static_cast<size_t>(b) * m + (active ? qi : 0)) * 3;
  const float* s = support + static_cast<size_t>(b) * n * 3;
  const float qx = q[0], qy = q[1], qz = q[2];

  int best[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) best[j] = INT_MAX;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      sx[t] = s[3 * (base + t) + 0];
      sy[t] = s[3 * (base + t) + 1];
      sz[t] = s[3 * (base + t) + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < cnt; ++t) {
      const float dx = __fsub_rn(qx, sx[t]);
      const float dy = __fsub_rn(qy, sy[t]);
      const float dz = __fsub_rn(qz, sz[t]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const int key = (__float_as_int(d) & ~kIdxMask) | (base + t);
      if (key < best[KMAX - 1]) {
        // sorted insert; keys are unique, so no equal elements exist
#pragma unroll
        for (int j = KMAX - 1; j > 0; --j) {
          best[j] = best[j - 1] > key ? best[j - 1] : min(best[j], key);
        }
        best[0] = min(best[0], key);
      }
    }
  }
  if (!active) return;
  const size_t o = (static_cast<size_t>(b) * m + qi) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      idx_out[o + j] = best[j] & kIdxMask;
      const float dq = __int_as_float(best[j] & ~kIdxMask);
      dist_out[o + j] = sqrtf(fmaxf(dq, 0.f));
    }
  }
}

template <int KMAX>
void launch(const float* q, const float* s, int b, int m, int n, int k, int* idx,
            float* dist, cudaStream_t stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  knn_packed_kernel<KMAX><<<grid, kThreads, 0, stream>>>(q, s, m, n, k, idx, dist);
}

}  // namespace

extern "C" int amt_knn_packed(const float* query, const float* support, int b, int m,
                              int n, int k, int* idx, float* dist, void* stream) {
  if (b <= 0 || m <= 0 || n <= 0 || n > (1 << kIdxBits) || k <= 0 || k >= n || k > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    launch<8>(query, support, b, m, n, k, idx, dist, st);
  } else if (k <= 16) {
    launch<16>(query, support, b, m, n, k, idx, dist, st);
  } else if (k <= 32) {
    launch<32>(query, support, b, m, n, k, idx, dist, st);
  } else {
    launch<64>(query, support, b, m, n, k, idx, dist, st);
  }
  return static_cast<int>(cudaGetLastError());
}
