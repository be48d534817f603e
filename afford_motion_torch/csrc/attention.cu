// Fused multi-head attention forward with key padding, for inference.
//
// Replaces the flash-attention path of afford_motion_tpu/models/layers.py
// (`_flash_attention`, which pads the sequences to 128, turns the key padding
// mask into segment ids and calls the library's Pallas TPU kernel): per batch
// item b, head h and query i,
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale) . v[b, j, h]
// over the keys j whose mask[b, j] is 0. q, k, v and out keep the projections'
// layout (B, L, heads * hd), f32 or bf16; logits, the softmax and the
// accumulators are f32 whatever the input type, and the result is rounded to
// the input type once. No padding of L is needed: ragged tiles are masked by
// their counts. A query all of whose keys are masked gets a zero row (the
// JAX package leaves that case undefined). Forward only: the JAX package takes
// this path only where nothing is differentiated.
//
// What bounds it on the H100: 4 * B * heads * Lq * Lk * hd operations (7.0e9
// unmasked for the denoiser's B=32, 8 heads, L=326 = time + text + 128 contact
// + 196 motion tokens, hd=64) and the q, k, v, o bytes (43 MB there). The card
// could do bf16 products on its tensor cores, where those operations take less
// time than the bytes; this kernel does them at the f32 rate outside the tensor
// cores, so it is far from that bound. The (Lq, Lk) logits never exist.
// Design: a block per (query tile, head, batch item), one query per thread
// with its q row and its f32 accumulator row in registers; keys and values
// stream through shared memory in tiles of 32 as f32 (every thread reads the
// same key: 16-byte broadcast loads); online softmax, with the accumulator
// rescaled only when a key raises the running maximum. A masked key is skipped
// by the whole block. Products use fmaf explicitly: the library is built with
// -fmad=false for the distance kernels. One instance, for head dimensions up
// to 64 (every attention in the repo has 64): a smaller one runs it with the
// rest of the rows zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 64;  // queries per block
constexpr int kTK = 32;       // keys per shared-memory tile
constexpr int kHD = 64;       // the largest head dimension

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const unsigned char* __restrict__ mask, int lq, int lk, int heads, int hd,
                 float scale, T* __restrict__ out) {
  __shared__ __align__(16) float sk[kTK][kHD];
  __shared__ __align__(16) float sv[kTK][kHD];
  __shared__ unsigned char smask[kTK];
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < lq;
  const size_t width = static_cast<size_t>(heads) * hd;
  const T* qrow = q + (static_cast<size_t>(b) * lq + (active ? qi : 0)) * width + h * hd;

  float qr[kHD], acc[kHD];
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    qr[d] = d < hd ? to_float(qrow[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int base = 0; base < lk; base += kTK) {
    const int cnt = min(kTK, lk - base);
    __syncthreads();
    for (int i = threadIdx.x; i < kTK * kHD; i += kThreads) {
      const int j = i / kHD, d = i % kHD;
      float kk = 0.f, vv = 0.f;
      if (j < cnt && d < hd) {
        const size_t at = (static_cast<size_t>(b) * lk + base + j) * width + h * hd + d;
        kk = to_float(k[at]);
        vv = to_float(v[at]);
      }
      sk[j][d] = kk;
      sv[j][d] = vv;
    }
    if (threadIdx.x < kTK) {
      const int j = threadIdx.x;
      smask[j] = j < cnt && mask != nullptr
                     ? mask[static_cast<size_t>(b) * lk + base + j] : 0;
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      if (smask[j]) continue;  // the same for every thread of the block
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d = 0; d < kHD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&sk[j][d]);
        s0 = fmaf(qr[d + 0], kk.x, s0);
        s1 = fmaf(qr[d + 1], kk.y, s1);
        s2 = fmaf(qr[d + 2], kk.z, s2);
        s3 = fmaf(qr[d + 3], kk.w, s3);
      }
      const float s = ((s0 + s1) + (s2 + s3)) * scale;
      if (s > m) {
        const float c = expf(m - s);  // 0 on the first key, where m is -inf
        l *= c;
#pragma unroll
        for (int d = 0; d < kHD; ++d) acc[d] *= c;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < kHD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&sv[j][d]);
        acc[d + 0] = fmaf(p, vv.x, acc[d + 0]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }
  if (!active) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = out + (static_cast<size_t>(b) * lq + qi) * width + h * hd;
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    if (d < hd) from_float(acc[d] * inv, orow + d);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask, int b, int lq,
           int lk, int heads, int hd, float scale, void* out, cudaStream_t stream) {
  const dim3 grid((lq + kThreads - 1) / kThreads, heads, b);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  attention_kernel<T><<<grid, kThreads, 0, stream>>>(qq, kk, vv, mask, lq, lk, heads, hd, scale,
                                                     oo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, heads*hd), k, v (B, Lk, heads*hd), mask (B, Lk) bytes or null,
// out (B, Lq, heads*hd); elem_bytes 4 = f32, 2 = bf16
extern "C" int amt_attention(const void* q, const void* k, const void* v,
                             const unsigned char* mask, int b, int lq, int lk, int heads, int hd,
                             float scale, int elem_bytes, void* out, void* stream) {
  if (b <= 0 || b > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0 || hd <= 0 ||
      hd > kHD || (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return launch<float>(q, k, v, mask, b, lq, lk, heads, hd, scale, out, st);
  }
  return launch<__nv_bfloat16>(q, k, v, mask, b, lq, lk, heads, hd, scale, out, st);
}
