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
// the input type once. A query all of whose keys are masked gets a zero row
// (the JAX package leaves that case undefined). Forward only: the JAX package
// takes this path only where nothing is differentiated.
//
// What bounds it on the H100: 4 * B * heads * Lq * Lk * hd operations (7.0e9
// unmasked for the denoiser's B=32, 8 heads, L=326 = time + text + 128 contact
// + 196 motion tokens, hd=64) and the q, k, v, o bytes (43 MB there). On the
// bf16 tensor cores the operations take less time than the bytes. The (Lq, Lk)
// logits never exist.
//
// bf16: tensor cores (`mma.sync.m16n8k16`, bf16 in, f32 accumulate). A block
// per (64 queries, head, batch item); 4 warps of 16 query rows each, Q in
// registers as A fragments. Keys and values stream through shared memory as
// bf16 in tiles of 64 keys, double-buffered: `cp.async` brings tile t+1 while
// tile t is computed, with one barrier a tile. Rows are 64 bf16 (128 bytes);
// the 16-byte chunk c of row r lies at chunk c ^ (r & 7), so the eight rows
// an `ldmatrix` reads sit in eight bank groups. S = Q K^T takes K as the B
// operand by `ldmatrix`; the mask is applied per key column as -inf (a tile
// whose keys are all masked is skipped, keys after the last valid one are not
// loaded, columns past Lk are zero-filled and masked); the online softmax
// runs in f32 on the accumulator fragments with `exp2f` of logits pre-scaled
// by log2(e), row maxima and sums reduced across each quad by shuffles.
// P is rounded to bf16 and fed as the A operand of P V straight from the S
// fragments, with V as the B operand by `ldmatrix.trans`, as the TPU kernel
// rounds `p.astype(v.dtype)`. The epilogue scales by 1/l, rounds once, stages
// the tile in shared memory and writes 16-byte rows. Head dimensions below 64
// are zero-padded to 64 in shared memory; they must be multiples of 8, and
// the tensors 16-byte aligned, for the 16-byte copies. Why `mma.sync` and not
// `wgmma`: at this size the kernel is bound by bytes and latency, not by the
// tensor cores' rate, and the register
// fragments of `mma.sync` let P go from the softmax to P V without a trip
// through shared memory.
//
// f32: the regressor's parity surface, where no product may lose bits to TF32.
// One query a thread with its q row and f32 accumulator in registers; keys and
// values stream through shared memory in tiles of 32 (16-byte broadcast
// loads); online softmax, rescaled only when a key raises the running
// maximum; a masked key is skipped by the whole block. Products use fmaf
// explicitly: the library is built with -fmad=false for the distance kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kHD = 64;  // the largest head dimension; every attention in the repo has 64

// ----------------------------------------------------------------- float32

constexpr int kThreads = 64;  // queries per block
constexpr int kTK = 32;       // keys per shared-memory tile

__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const unsigned char* __restrict__ mask, int lq,
                     int lk, int heads, int hd, float scale, float* __restrict__ out) {
  __shared__ __align__(16) float sk[kTK][kHD];
  __shared__ __align__(16) float sv[kTK][kHD];
  __shared__ unsigned char smask[kTK];
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < lq;
  const size_t width = static_cast<size_t>(heads) * hd;
  const float* qrow = q + (static_cast<size_t>(b) * lq + (active ? qi : 0)) * width + h * hd;

  float qr[kHD], acc[kHD];
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    qr[d] = d < hd ? qrow[d] : 0.f;
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
        kk = k[at];
        vv = v[at];
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
  float* orow = out + (static_cast<size_t>(b) * lq + qi) * width + h * hd;
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    if (d < hd) orow[d] = acc[d] * inv;
  }
}

// -------------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;             // queries a block
constexpr int kBK = 64;             // keys a tile
constexpr int kWarps = kBQ / 16;    // 16 query rows a warp
constexpr int kTC = 32 * kWarps;    // threads a block
constexpr int kChunks = kHD / 8;    // 16-byte chunks a row

// element offset of (row, d) in a swizzled 64 x 64 bf16 tile
__device__ __forceinline__ int swz(int row, int d) {
  return row * kHD + ((((d >> 3) ^ row) & 7) << 3) + (d & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b, a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const unsigned*>(&p);
}

// rows x hd of a (.., stride) bf16 matrix into a swizzled 64 x 64 tile by
// 16-byte cp.async (rows 16-byte aligned, hd a multiple of 8), zeros past
// `rows` and `hd`; completes at the next cp.async.wait_all
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t stride, int rows,
                                          int hd) {
  for (int i = threadIdx.x; i < 64 * kChunks; i += kTC) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows && c * 8 < hd;
    const bf16* g = ok ? src + r * stride + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(tile + swz(r, c * 8))),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// three blocks an SM: left alone, ptxas takes registers enough for two
// blocks only; a bound of four spills
__global__ void __launch_bounds__(kTC, 3)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const unsigned char* __restrict__ mask, int lq,
                      int lk, int heads, int hd, float scale_log2, bf16* __restrict__ out) {
  __shared__ __align__(128) bf16 sq[kBQ * kHD];
  __shared__ __align__(128) bf16 sk[2][kBK * kHD];
  __shared__ __align__(128) bf16 sv[2][kBK * kHD];
  __shared__ unsigned s_keep[2][2];  // a bit a key of the tile: 1 = attend
  __shared__ int s_end[kWarps];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row and column pair
  const size_t width = static_cast<size_t>(heads) * hd;
  const bf16* qb = q + (static_cast<size_t>(b) * lq + q0) * width + h * hd;
  const bf16* kb = k + static_cast<size_t>(b) * lk * width + h * hd;
  const bf16* vb = v + static_cast<size_t>(b) * lk * width + h * hd;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * lk;
  bf16* ob = out + (static_cast<size_t>(b) * lq + q0) * width + h * hd;
  const int q_rows = min(kBQ, lq - q0);

  // one past the last key that is attended: later keys are never loaded
  int end = 0;
  for (int j = threadIdx.x; j < lk; j += kTC) {
    if (mb == nullptr || !mb[j]) end = j + 1;
  }
  end = static_cast<int>(__reduce_max_sync(0xFFFFFFFFu, static_cast<unsigned>(end)));
  if (lane == 0) s_end[warp] = end;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) end = max(end, s_end[w]);
  const int tiles = (end + kBK - 1) / kBK;
  if (tiles == 0) {  // no key attended: zero rows
    for (int i = threadIdx.x; i < q_rows * hd; i += kTC) {
      ob[(i / hd) * width + i % hd] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  load_tile(sq, qb, width, q_rows, hd);
  load_tile(sk[0], kb, width, min(kBK, lk), hd);
  load_tile(sv[0], vb, width, min(kBK, lk), hd);

  const bool live = warp * 16 < q_rows;  // a warp whose rows all lie past Lq idles
  unsigned qf[4][4];                     // Q's A fragments, one a 16-wide slice of hd
  float acc[8][4];                       // O: 16 rows x 64, eight 16x8 C fragments
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, base = t * kBK;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (warp < 2) {
      const int j = base + threadIdx.x;
      const bool keep = j < end && (mb == nullptr || !mb[j]);
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, keep);
      if (lane == 0) s_keep[buf][warp] = bits;
    }
    // tile t (and Q) is in shared memory, and every warp is done with tile
    // t - 1, whose buffers the next loads take
    __syncthreads();
    if (t + 1 < tiles) {
      const int next = base + kBK;
      load_tile(sk[buf ^ 1], kb + next * width, width, min(kBK, lk - next), hd);
      load_tile(sv[buf ^ 1], vb + next * width, width, min(kBK, lk - next), hd);
    }
    if (t == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int mi = lane >> 3;
        const int row = warp * 16 + (lane & 7) + ((mi & 1) << 3);
        ldmatrix_x4(smem_addr(sq + swz(row, (2 * kk + (mi >> 1)) * 8)), qf[kk]);
      }
    }
    const unsigned long long keep =
        s_keep[buf][0] | (static_cast<unsigned long long>(s_keep[buf][1]) << 32);
    if (!live || keep == 0ull) continue;

    // S = Q K^T: 16 rows x 64 keys, eight 16x8 fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int mi = lane >> 3;
        const int key = 16 * jp + (lane & 7) + ((mi >> 1) << 3);
        unsigned r[4];
        ldmatrix_x4(smem_addr(sk[buf] + swz(key, (2 * kk + (mi & 1)) * 8)), r);
        mma(s[2 * jp], qf[kk], r[0], r[1]);
        mma(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    }

    // online softmax over this tile, f32, base-2 logits
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        s[j][e] = (keep >> col) & 1ull ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing attended yet
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
        l_run[e >> 1] += s[j][e];
        acc[j][e] *= alpha[e >> 1];
      }
    }

    // O += P V, P rounded to bf16: the S fragments of keys 16kk..16kk+15 are
    // the A fragment of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int mi = lane >> 3;
        const int key = 16 * kk + (lane & 7) + ((mi & 1) << 3);
        unsigned r[4];
        ldmatrix_x4_trans(smem_addr(sv[buf] + swz(key, (2 * jp + (mi >> 1)) * 8)), r);
        mma(acc[2 * jp], a, r[0], r[1]);
        mma(acc[2 * jp + 1], a, r[2], r[3]);
      }
    }
  }
  if (!live) return;

  // 1/l, one rounding to bf16, staged in this warp's own rows of sq (its Q
  // fragments are in registers), then written as rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 1);
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<unsigned*>(sq + swz(row, 8 * j + 2 * tig)) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
  const int rows = min(16, q_rows - warp * 16);
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    if (r < rows && c * 8 < hd) {
      *reinterpret_cast<uint4*>(ob + (warp * 16 + r) * width + c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz(warp * 16 + r, c * 8));
    }
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const unsigned char* mask, int b,
                int lq, int lk, int heads, int hd, float scale, void* out, cudaStream_t stream) {
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, b);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (hd % 8 != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2(e))
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(out);
  attention_bf16_kernel<<<grid, kTC, 0, stream>>>(qq, kk, vv, mask, lq, lk, heads, hd,
                                                  scale_log2, oo);
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
  if (elem_bytes == 2) return launch_bf16(q, k, v, mask, b, lq, lk, heads, hd, scale, out, st);
  const dim3 grid((lq + kThreads - 1) / kThreads, heads, b);
  attention_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, lq, lk, heads, hd, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
