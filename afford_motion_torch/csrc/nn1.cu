// Fused exact 1-NN of every scene point against each frame's body vertices.
//
// Replaces afford_motion_tpu/ops/pallas/sdf.py (`nn1_pallas` -> `_nn1_kernel`):
// per frame f and query point o, d2[f, o] = min over vertices h of
// ((dx*dx + dy*dy) + dz*dz) in f32 with every step rounded, and idx[f, o] the
// FIRST vertex index that attains that minimum. The TPU kernel pads the
// vertices to its chunk width with a 1e6 sentinel and carries (min, argmin)
// across chunks in an (8, 128) output tile; neither exists here: the ragged
// last tile is masked by its count, and the running pair lives in registers.
//
// What bounds it on the H100: the L*O*H distance evaluations (1.7e10 a
// 196-frame sequence at O=8192, H=10475), i.e. the f32 ALUs' rate. The inputs are
// 12 bytes a point and the (O, H) matrix never exists, so bytes are nothing.
// Design: a block per (frame, tile of 256 * kQ queries); the frame's vertices
// stream through shared memory in tiles of 2048 as float4 (one 16-byte
// broadcast load per vertex serves the whole warp); each thread keeps kQ
// queries and their running (min d2, index) in registers, so one vertex load
// feeds kQ distance evaluations. Vertices are visited in ascending index and
// the update is a strict <, so the smallest index wins ties within and across
// tiles, as the TPU kernel's does.
//
// d2 is formed with __fsub_rn / __fmul_rn / __fadd_rn so nvcc cannot contract
// it into an FMA: d2 and idx must be bit-equal to the plain PyTorch version.
// Inputs must be NaN-free (a NaN distance never wins a strict <).
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 2;        // queries per thread
constexpr int kTile = 2048;  // vertices per shared-memory tile (32 KB)

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ points, const float* __restrict__ verts, int o, int h,
           float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float4 sv[kTile];
  const int f = blockIdx.y;
  const float* v = verts + static_cast<size_t>(f) * h * 3;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int besti[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int qi = (blockIdx.x * kQ + j) * kThreads + threadIdx.x;
    const float* p = points + static_cast<size_t>(qi < o ? qi : 0) * 3;
    qx[j] = p[0];
    qy[j] = p[1];
    qz[j] = p[2];
    best[j] = INFINITY;  // a strict < keeps index 0 when every distance is +inf
    besti[j] = 0;
  }
  for (int base = 0; base < h; base += kTile) {
    const int cnt = min(kTile, h - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const float* s = v + 3 * static_cast<size_t>(base + t);
      sv[t] = make_float4(s[0], s[1], s[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float4 s = sv[t];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float dx = __fsub_rn(qx[j], s.x);
        const float dy = __fsub_rn(qy[j], s.y);
        const float dz = __fsub_rn(qz[j], s.z);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (d < best[j]) {
          best[j] = d;
          besti[j] = base + t;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int qi = (blockIdx.x * kQ + j) * kThreads + threadIdx.x;
    if (qi < o) {
      d2_out[static_cast<size_t>(f) * o + qi] = best[j];
      idx_out[static_cast<size_t>(f) * o + qi] = besti[j];
    }
  }
}

}  // namespace

// points (O, 3) f32, verts (L, H, 3) f32 -> d2 (L, O) f32, idx (L, O) i32
extern "C" int amt_nn1(const float* points, const float* verts, int l, int o, int h, float* d2,
                       int* idx, void* stream) {
  if (l <= 0 || o <= 0 || h <= 0 || l > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kThreads * kQ;
  const dim3 grid((o + per_block - 1) / per_block, l);
  nn1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(points, verts, o, h, d2,
                                                                       idx);
  return static_cast<int>(cudaGetLastError());
}
