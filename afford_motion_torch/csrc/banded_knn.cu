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
// tile from starts (B, G) (stride G).
//
// What bounds it on the H100: the M*S distance evaluations (S is 384..768
// rows on the SceneMap path against N up to 8192 for the full kNN), i.e. ALU
// throughput; the inputs are 12 bytes a point. Design, as csrc/knn.cu: one block
// per (tile, cloud), one query per thread, the window streamed through
// shared memory in chunks (a broadcast read), each thread's k smallest keys
// in registers as a sorted array with a branch-free insertion.
//
// d is formed with __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot contract
// it into an FMA: idx and dist must be bit-equal to the plain PyTorch
// version. starts are not range-checked (nor on the TPU): they must lie in
// [0, n - s].
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kTileQueries = 128;  // TQ of the window policy
constexpr int kChunk = 2048;
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;

template <int KMAX>
__global__ void __launch_bounds__(kTileQueries)
knn_banded_kernel(const float* __restrict__ query, const float* __restrict__ support,
                  const int* __restrict__ starts, int starts_stride, int m, int n, int s,
                  int k, int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int qi = tile * kTileQueries + threadIdx.x;
  const int start = starts[static_cast<size_t>(b) * starts_stride + tile];
  const float* q = query + (static_cast<size_t>(b) * m + qi) * 3;
  const float* win = support + (static_cast<size_t>(b) * n + start) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];

  int best[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) best[j] = INT_MAX;

  for (int base = 0; base < s; base += kChunk) {
    const int cnt = min(kChunk, s - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kTileQueries) {
      sx[t] = win[3 * (base + t) + 0];
      sy[t] = win[3 * (base + t) + 1];
      sz[t] = win[3 * (base + t) + 2];
    }
    __syncthreads();
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
  const size_t o = (static_cast<size_t>(b) * m + qi) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      idx_out[o + j] = (best[j] & kIdxMask) + start;
      const float dq = __int_as_float(best[j] & ~kIdxMask);
      dist_out[o + j] = sqrtf(fmaxf(dq, 0.f));
    }
  }
}

template <int KMAX>
void launch(const float* q, const float* sup, const int* starts, int stride, int b, int m,
            int n, int s, int k, int* idx, float* dist, cudaStream_t stream) {
  const dim3 grid(m / kTileQueries, b);
  knn_banded_kernel<KMAX><<<grid, kTileQueries, 0, stream>>>(q, sup, starts, stride, m, n, s, k,
                                                          idx, dist);
}

}  // namespace

// query (b, m, 3), support (b, n, 3) f32; starts int32, (m / 128,) with
// starts_stride 0 or (b, m / 128) with starts_stride m / 128; s the window
// size; idx, dist (b, m, k).
extern "C" int amt_knn_banded(const float* query, const float* support, const int* starts,
                              int starts_stride, int b, int m, int n, int s, int k, int* idx,
                              float* dist, void* stream) {
  if (b <= 0 || m <= 0 || m % kTileQueries != 0 || n <= 0 || s <= 0 || s > n ||
      s > (1 << kIdxBits) || k <= 0 || k > s || k > 64 ||
      (starts_stride != 0 && starts_stride != m / kTileQueries)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    launch<8>(query, support, starts, starts_stride, b, m, n, s, k, idx, dist, st);
  } else if (k <= 16) {
    launch<16>(query, support, starts, starts_stride, b, m, n, s, k, idx, dist, st);
  } else if (k <= 32) {
    launch<32>(query, support, starts, starts_stride, b, m, n, s, k, idx, dist, st);
  } else {
    launch<64>(query, support, starts, starts_stride, b, m, n, s, k, idx, dist, st);
  }
  return static_cast<int>(cudaGetLastError());
}
