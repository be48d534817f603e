// Fused multi-head attention with key padding: the forward, and the backward
// that gives dq, dk and dv for training through the fused route.
//
// Replaces the flash-attention path of afford_motion_tpu/models/layers.py
// (`_flash_attention`, which pads the sequences to 128, turns the key padding
// mask into segment ids and calls the library's Pallas TPU kernel, a
// `jax.custom_vjp` in jax/experimental/pallas/ops/tpu/flash_attention.py whose
// backward is two more Pallas kernels, `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq`): per batch item b, head h and query i,
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale) . v[b, j, h]
// over the keys j whose mask[b, j] is 0. q, k, v and out keep the projections'
// layout (B, L, heads * hd), f32 or bf16; logits, the softmax and the
// accumulators are f32 whatever the input type, and the result is rounded to
// the input type once. A query all of whose keys are masked gets a zero row
// (the JAX package leaves that case undefined). Given a pointer, the forward
// also writes each row's log-sum-exp of the scaled logits, (B, heads, Lq) f32,
// +inf for a row with no attended key; `out` is the same with or without it.
//
// What bounds the forward on the H100: 4 * B * heads * Lq * Lk * hd operations (7.0e9
// unmasked for the denoiser's B=32, 8 heads, L=326 = time + text + 128 contact
// + 196 motion tokens, hd=64) and the q, k, v, o bytes (43 MB there). On the
// bf16 tensor cores the operations take less time than the bytes. The (Lq, Lk)
// logits never exist.
//
// Forward, bf16: tensor cores (`mma.sync.m16n8k16`, bf16 in, f32 accumulate). A block
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
// Forward, f32: the regressor's parity surface, where no product may lose
// bits to TF32.
// One query a thread with its q row and f32 accumulator in registers; keys and
// values stream through shared memory in tiles of 32 (16-byte broadcast
// loads); online softmax, rescaled only when a key raises the running
// maximum; a masked key is skipped by the whole block. Products use fmaf
// explicitly: the library is built with -fmad=false for the distance kernels.
//
// Backward (`amt_attention_bwd`), as the library's VJP computes it: from the
// saved row statistics (here the log-sum-exp lse), P = exp(s - lse) is
// recomputed in f32, and with di = sum_d o * do over the rounded output,
//   dv = P^T do  (P rounded to the input type first),
//   ds = (do v^T - di) * P * scale,
//   dk = ds^T q,  dq = ds k  (ds rounded to the input type first),
// all sums in f32, each result rounded once. Masked keys get zero rows. Three
// launches: a di pass (one warp a row and head), then the library's split:
// dK/dV, where a block owns a tile of keys of one (item, head) and walks the
// query tiles in order, and dQ, where a block owns a tile of queries and walks
// the key tiles, skipping tiles with no attended key as the forward does.
// Every output element has one owner, so no float atomics: two runs give the
// same bits. The bound: 5 products of 2 * B * heads * Lq * Lk * hd (S and dP
// are recomputed, so the kernels do 7) and the q, k, v, o, do, lse bytes read
// and dq, dk, dv written (85 MB at the denoiser's shape in bf16).
//
// Backward, bf16: the forward's `mma.sync` fragments and swizzled `cp.async`
// tiles. dK/dV: 4 warps own 16 keys each, K and V as A fragments in
// registers; per 64-query tile, S^T = K Q^T and dP^T = V dO^T take Q and dO as
// B operands by `ldmatrix`, P^T goes from the S^T fragments, rounded, into
// dV += P^T dO, and dS^T into dK += dS^T Q, with dO and Q as B operands by
// `ldmatrix.trans`. dQ: 4 warps own 16 queries each, Q and dO as A fragments;
// per 64-key tile, S = Q K^T and dP = dO V^T, then dQ += dS K. K and V (dK/dV)
// or Q and dO (dQ) are staged once through the second buffer of the stream,
// which then double-buffers the tiles. A simple first kernel: one block per
// 64 rows, no split of the walk, no `wgmma`.
//
// Backward, f32: no tensor cores, as in the forward. Tiles of 32 queries and
// 32 keys in shared memory (rows padded to 65 floats), 256 threads: each
// thread computes 4 of the tile's P and dS entries from full-length dot
// products, then 8 output elements of the block's rows accumulate over the
// tile, in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kHD = 64;  // the largest head dimension; every attention in the repo has 64
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ----------------------------------------------------------------- float32

constexpr int kThreads = 64;  // queries per block
constexpr int kTK = 32;       // keys per shared-memory tile

__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const unsigned char* __restrict__ mask, int lq,
                     int lk, int heads, int hd, float scale, float* __restrict__ out,
                     float* __restrict__ lse) {
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
  if (lse != nullptr) {
    lse[(static_cast<size_t>(b) * heads + h) * lq + qi] = l > 0.f ? m + logf(l) : INFINITY;
  }
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

// the 16 x 64 A fragments (four 16-wide slices of hd) of rows row0.. of a
// swizzled tile
__device__ __forceinline__ void load_a_rows(const bf16* tile, int row0, int lane,
                                            unsigned (&f)[4][4]) {
  const int mi = lane >> 3;
  const int row = row0 + (lane & 7) + ((mi & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(smem_addr(tile + swz(row, (2 * kk + (mi >> 1)) * 8)), f[kk]);
  }
}

// acc (16 x 64, eight 16x8 fragments) += A (16 x 64 over hd) . T^T, T a
// swizzled 64-row tile read as the B operand with its rows as columns
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4], const unsigned (&a)[4][4],
                                         const bf16* tile, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int row = 16 * jp + (lane & 7) + ((mi >> 1) << 3);
      unsigned r[4];
      ldmatrix_x4(smem_addr(tile + swz(row, (2 * kk + (mi & 1)) * 8)), r);
      mma(acc[2 * jp], a[kk], r[0], r[1]);
      mma(acc[2 * jp + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc (16 x 64 over hd) += C (16 x 64, fragments rounded to bf16) . T, T a
// swizzled 64-row tile read as the B operand by `ldmatrix.trans`
__device__ __forceinline__ void mma_c_t(float (&acc)[8][4], const float (&c)[8][4],
                                        const bf16* tile, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int row = 16 * kk + (lane & 7) + ((mi & 1) << 3);
      unsigned r[4];
      ldmatrix_x4_trans(smem_addr(tile + swz(row, (2 * jp + (mi >> 1)) * 8)), r);
      mma(acc[2 * jp], a, r[0], r[1]);
      mma(acc[2 * jp + 1], a, r[2], r[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// three blocks an SM: left alone, ptxas takes registers enough for two
// blocks only; a bound of four spills
__global__ void __launch_bounds__(kTC, 3)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const unsigned char* __restrict__ mask, int lq,
                      int lk, int heads, int hd, float scale_log2, bf16* __restrict__ out,
                      float* __restrict__ lse) {
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
    if (lse != nullptr) {
      for (int i = threadIdx.x; i < q_rows; i += kTC) {
        lse[(static_cast<size_t>(b) * heads + h) * lq + q0 + i] = INFINITY;
      }
    }
    return;
  }
  load_tile(sq, qb, width, q_rows, hd);
  load_tile(sk[0], kb, width, min(kBK, lk), hd);
  load_tile(sv[0], vb, width, min(kBK, lk), hd);

  const bool live = warp * 16 < q_rows;  // a warp whose rows all lie past Lq idles
  unsigned qf[4][4];                     // Q's A fragments, one a 16-wide slice of hd
  float acc[8][4];                       // O: 16 rows x 64, eight 16x8 C fragments
  zero(acc);
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
    if (t == 0 && live) load_a_rows(sq, warp * 16, lane, qf);
    const unsigned long long keep =
        s_keep[buf][0] | (static_cast<unsigned long long>(s_keep[buf][1]) << 32);
    if (!live || keep == 0ull) continue;

    // S = Q K^T: 16 rows x 64 keys, eight 16x8 fragments
    float s[8][4];
    zero(s);
    mma_a_bt(s, qf, sk[buf], lane);

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
    mma_c_t(acc, s, sv[buf], lane);
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
    const int row = warp * 16 + g + 8 * r;
    if (lse != nullptr && tig == 0 && row < q_rows) {  // m_run is in log2 units
      lse[(static_cast<size_t>(b) * heads + h) * lq + q0 + row] =
          l > 0.f ? (m_run[r] + log2f(l)) * kLn2 : INFINITY;
    }
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
                int lq, int lk, int heads, int hd, float scale, void* out, float* lse,
                cudaStream_t stream) {
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, b);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (hd % 8 != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(out);
  attention_bf16_kernel<<<grid, kTC, 0, stream>>>(qq, kk, vv, mask, lq, lk, heads, hd,
                                                  scale_log2, oo, lse);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward: di

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

constexpr int kDiThreads = 256;  // 8 warps, one (row, head) a warp

// di[b, h, i] = sum_d o[b, i, h, d] * do[b, i, h, d] in f32, over the rounded o
template <typename T>
__global__ void __launch_bounds__(kDiThreads)
attention_di_kernel(const T* __restrict__ o, const T* __restrict__ dout, int b, int lq,
                    int heads, int hd, float* __restrict__ di) {
  const long long pair = static_cast<long long>(blockIdx.x) * (kDiThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= static_cast<long long>(b) * lq * heads) return;
  const long long row = pair / heads;  // b * lq + i
  const int h = static_cast<int>(pair % heads);
  const size_t at = static_cast<size_t>(row) * heads * hd + static_cast<size_t>(h) * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) {
    s = fmaf(to_float(o[at + d]), to_float(dout[at + d]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
  if (lane == 0) {
    const long long bi = row / lq, i = row % lq;
    di[(static_cast<size_t>(bi) * heads + h) * lq + i] = s;
  }
}

// --------------------------------------------------------- backward: float32

constexpr int kBT = 32;         // queries and keys a tile
constexpr int kBThreads = 256;  // threads a block
constexpr int kRow = kHD + 1;   // padded row: the dot products' rows sit in distinct banks

// rows x hd of a (.., stride) f32 matrix into a kBT x kRow tile, zeros past
// `rows` and `hd`
__device__ __forceinline__ void load_rows_f32(float (*tile)[kRow], const float* src,
                                              size_t stride, int rows, int hd) {
  for (int i = threadIdx.x; i < kBT * kHD; i += kBThreads) {
    const int r = i / kHD, d = i % kHD;
    tile[r][d] = r < rows && d < hd ? src[r * stride + d] : 0.f;
  }
}

// P and dS of a 32 x 32 tile (rows queries, columns keys): thread t takes
// query t % 32 and keys t / 32 + 8p; full-length dot products in order
__device__ __forceinline__ void scores_f32(const float (*sq)[kRow], const float (*sdo)[kRow],
                                           const float (*sk)[kRow], const float (*sv)[kRow],
                                           const float* s_lse, const float* s_di,
                                           const unsigned char* s_keep, float scale,
                                           float (*sp)[kBT + 1], float (*sds)[kBT + 1]) {
  const int i = threadIdx.x % kBT, j0 = threadIdx.x / kBT;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < kHD; ++d) {
    const float qd = sq[i][d], dod = sdo[i][d];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      s[p] = fmaf(qd, sk[j0 + 8 * p][d], s[p]);
      dp[p] = fmaf(dod, sv[j0 + 8 * p][d], dp[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int j = j0 + 8 * p;
    const float pr = s_keep[j] ? expf(s[p] * scale - s_lse[i]) : 0.f;
    sp[i][j] = pr;
    sds[i][j] = (dp[p] - s_di[i]) * pr * scale;
  }
}

// a block a tile of 32 keys of one (item, head); the query tiles in order
__global__ void __launch_bounds__(kBThreads)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             const unsigned char* __restrict__ mask, int lq, int lk, int heads,
                             int hd, float scale, float* __restrict__ dk, float* __restrict__ dv) {
  __shared__ float sq[kBT][kRow], sdo[kBT][kRow], sk[kBT][kRow], sv[kBT][kRow];
  __shared__ float sp[kBT][kBT + 1], sds[kBT][kBT + 1];
  __shared__ float s_lse[kBT], s_di[kBT];
  __shared__ unsigned char s_keep[kBT];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBT;
  const size_t width = static_cast<size_t>(heads) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int k_rows = min(kBT, lk - k0);
  const size_t krow0 = (static_cast<size_t>(b) * lk + k0) * width + head_off;
  const int tid = threadIdx.x;
  int keep = 0;
  if (tid < kBT) {
    keep = tid < k_rows && (mask == nullptr || !mask[static_cast<size_t>(b) * lk + k0 + tid]);
    s_keep[tid] = static_cast<unsigned char>(keep);
  }
  const int d = threadIdx.x % kHD, jr = threadIdx.x / kHD;  // keys jr + 4r
  if (!__syncthreads_or(keep)) {  // no key of the tile attended: zero rows
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = jr + 4 * r;
      if (j < k_rows && d < hd) {
        dk[krow0 + j * width + d] = 0.f;
        dv[krow0 + j * width + d] = 0.f;
      }
    }
    return;
  }
  load_rows_f32(sk, k + krow0, width, k_rows, hd);
  load_rows_f32(sv, v + krow0, width, k_rows, hd);
  float adk[8], adv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) adk[r] = adv[r] = 0.f;
  const float* lse_b = lse + (static_cast<size_t>(b) * heads + h) * lq;
  const float* di_b = di + (static_cast<size_t>(b) * heads + h) * lq;
  for (int i0 = 0; i0 < lq; i0 += kBT) {
    const int q_rows = min(kBT, lq - i0);
    const size_t qrow0 = (static_cast<size_t>(b) * lq + i0) * width + head_off;
    __syncthreads();  // the last tile's readers are done
    load_rows_f32(sq, q + qrow0, width, q_rows, hd);
    load_rows_f32(sdo, dout + qrow0, width, q_rows, hd);
    if (threadIdx.x < kBT) {
      const int i = threadIdx.x;
      s_lse[i] = i < q_rows ? lse_b[i0 + i] : INFINITY;
      s_di[i] = i < q_rows ? di_b[i0 + i] : 0.f;
    }
    __syncthreads();
    scores_f32(sq, sdo, sk, sv, s_lse, s_di, s_keep, scale, sp, sds);
    __syncthreads();
    for (int i = 0; i < kBT; ++i) {
      const float qd = sq[i][d], dod = sdo[i][d];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        adv[r] = fmaf(sp[i][jr + 4 * r], dod, adv[r]);
        adk[r] = fmaf(sds[i][jr + 4 * r], qd, adk[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = jr + 4 * r;
    if (j < k_rows && d < hd) {
      dk[krow0 + j * width + d] = adk[r];
      dv[krow0 + j * width + d] = adv[r];
    }
  }
}

// a block a tile of 32 queries of one (item, head); the key tiles in order,
// tiles with no attended key skipped
__global__ void __launch_bounds__(kBThreads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ di,
                            const unsigned char* __restrict__ mask, int lq, int lk, int heads,
                            int hd, float scale, float* __restrict__ dq) {
  __shared__ float sq[kBT][kRow], sdo[kBT][kRow], sk[kBT][kRow], sv[kBT][kRow];
  __shared__ float sp[kBT][kBT + 1], sds[kBT][kBT + 1];
  __shared__ float s_lse[kBT], s_di[kBT];
  __shared__ unsigned char s_keep[kBT];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kBT;
  const size_t width = static_cast<size_t>(heads) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int q_rows = min(kBT, lq - i0);
  const size_t qrow0 = (static_cast<size_t>(b) * lq + i0) * width + head_off;
  load_rows_f32(sq, q + qrow0, width, q_rows, hd);
  load_rows_f32(sdo, dout + qrow0, width, q_rows, hd);
  if (threadIdx.x < kBT) {
    const int i = threadIdx.x;
    const size_t at = (static_cast<size_t>(b) * heads + h) * lq + i0 + i;
    s_lse[i] = i < q_rows ? lse[at] : INFINITY;
    s_di[i] = i < q_rows ? di[at] : 0.f;
  }
  const int d = threadIdx.x % kHD, ir = threadIdx.x / kHD;  // queries ir + 4r
  float adq[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) adq[r] = 0.f;
  for (int k0 = 0; k0 < lk; k0 += kBT) {
    const int k_rows = min(kBT, lk - k0);
    __syncthreads();  // the last tile's readers are done
    const int tid = threadIdx.x;
    int keep = 0;
    if (tid < kBT) {
      keep = tid < k_rows && (mask == nullptr || !mask[static_cast<size_t>(b) * lk + k0 + tid]);
      s_keep[tid] = static_cast<unsigned char>(keep);
    }
    if (!__syncthreads_or(keep)) continue;  // the same for the whole block
    const size_t krow0 = (static_cast<size_t>(b) * lk + k0) * width + head_off;
    load_rows_f32(sk, k + krow0, width, k_rows, hd);
    load_rows_f32(sv, v + krow0, width, k_rows, hd);
    __syncthreads();
    scores_f32(sq, sdo, sk, sv, s_lse, s_di, s_keep, scale, sp, sds);
    __syncthreads();
    for (int j = 0; j < kBT; ++j) {
      const float kd = sk[j][d];
#pragma unroll
      for (int r = 0; r < 8; ++r) adq[r] = fmaf(sds[ir + 4 * r][j], kd, adq[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ir + 4 * r;
    if (i < q_rows && d < hd) dq[qrow0 + i * width + d] = adq[r];
  }
}

// ------------------------------------------------ backward: bf16, tensor cores

// a warp's 16 rows x hd of fragments, rounded to bf16, to rows row0.. of a
// (.., width) matrix: rows at or past `rows` are left alone
__device__ __forceinline__ void store_rows(bf16* dst, size_t width, int row0, int rows, int hd,
                                           const float (&acc)[8][4], int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j < hd) {
        *reinterpret_cast<unsigned*>(dst + row * width + 8 * j + 2 * tig) =
            pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// a block 64 keys of one (item, head), 16 a warp; the query tiles in order
__global__ void __launch_bounds__(kTC, 2)
attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ di,
                              const unsigned char* __restrict__ mask, int lq, int lk, int heads,
                              int hd, float scale_log2, float scale, bf16* __restrict__ dk,
                              bf16* __restrict__ dv) {
  // buffer 1 holds K and V until their fragments are in registers
  __shared__ __align__(128) bf16 sq[2][kBQ * kHD];
  __shared__ __align__(128) bf16 sdo[2][kBQ * kHD];
  __shared__ float s_lse[2][kBQ];  // log2 units
  __shared__ float s_di[2][kBQ];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t width = static_cast<size_t>(heads) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int k_rows = min(kBK, lk - k0);
  const unsigned char* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * lk;
  bf16* dkb = dk + (static_cast<size_t>(b) * lk + k0) * width + head_off;
  bf16* dvb = dv + (static_cast<size_t>(b) * lk + k0) * width + head_off;
  const bf16* qb = q + static_cast<size_t>(b) * lq * width + head_off;
  const bf16* dob = dout + static_cast<size_t>(b) * lq * width + head_off;
  const float* lse_b = lse + (static_cast<size_t>(b) * heads + h) * lq;
  const float* di_b = di + (static_cast<size_t>(b) * heads + h) * lq;

  const int tid = threadIdx.x;
  int attended = 0;
  if (tid < kBK) attended = tid < k_rows && (mb == nullptr || !mb[k0 + tid]);
  if (!__syncthreads_or(attended)) {  // no key of the tile attended: zero rows
    for (int i = threadIdx.x; i < k_rows * hd; i += kTC) {
      dkb[(i / hd) * width + i % hd] = __float2bfloat16_rn(0.f);
      dvb[(i / hd) * width + i % hd] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  bool keep[2];  // this thread's key rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    keep[r] = key < lk && (mb == nullptr || !mb[key]);
  }
  load_tile(sq[1], k + (static_cast<size_t>(b) * lk + k0) * width + head_off, width, k_rows, hd);
  load_tile(sdo[1], v + (static_cast<size_t>(b) * lk + k0) * width + head_off, width, k_rows, hd);
  load_tile(sq[0], qb, width, min(kBQ, lq), hd);
  load_tile(sdo[0], dob, width, min(kBQ, lq), hd);
  if (threadIdx.x < kBQ) {
    const int i = threadIdx.x;
    s_lse[0][i] = i < lq ? lse_b[i] * kLog2e : INFINITY;
  } else {
    const int i = threadIdx.x - kBQ;
    s_di[0][i] = i < lq ? di_b[i] : 0.f;
  }

  unsigned kf[4][4], vf[4][4];
  float adk[8][4], adv[8][4];
  zero(adk);
  zero(adv);
  const int tiles = (lq + kBQ - 1) / kBQ;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile t is in shared memory; every warp is done with tile t - 1
    if (t == 0) {
      load_a_rows(sq[1], warp * 16, lane, kf);
      load_a_rows(sdo[1], warp * 16, lane, vf);
      __syncthreads();  // buffer 1 is free
    }
    if (t + 1 < tiles) {
      const int next = (t + 1) * kBQ, rows = min(kBQ, lq - next);
      load_tile(sq[buf ^ 1], qb + next * width, width, rows, hd);
      load_tile(sdo[buf ^ 1], dob + next * width, width, rows, hd);
      if (threadIdx.x < kBQ) {
        const int i = threadIdx.x;
        s_lse[buf ^ 1][i] = i < rows ? lse_b[next + i] * kLog2e : INFINITY;
      } else {
        const int i = threadIdx.x - kBQ;
        s_di[buf ^ 1][i] = i < rows ? di_b[next + i] : 0.f;
      }
    }
    // S^T = K Q^T: this warp's 16 keys x 64 queries; P^T in f32
    float st[8][4];
    zero(st);
    mma_a_bt(st, kf, sq[buf], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        st[j][e] = keep[e >> 1] ? exp2f(st[j][e] * scale_log2 - s_lse[buf][col]) : 0.f;
      }
    }
    mma_c_t(adv, st, sdo[buf], lane);  // dV += P^T dO, P rounded to bf16
    // dP^T = V dO^T; dS^T = (dP^T - di) P^T scale
    float dpt[8][4];
    zero(dpt);
    mma_a_bt(dpt, vf, sdo[buf], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        dpt[j][e] = (dpt[j][e] - s_di[buf][col]) * st[j][e] * scale;
      }
    }
    mma_c_t(adk, dpt, sq[buf], lane);  // dK += dS^T Q, dS rounded to bf16
  }
  store_rows(dkb, width, warp * 16, k_rows, hd, adk, g, tig);
  store_rows(dvb, width, warp * 16, k_rows, hd, adv, g, tig);
}

// a block 64 queries of one (item, head), 16 a warp; the key tiles up to
// the last attended key, tiles with no attended key skipped
__global__ void __launch_bounds__(kTC, 2)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             const unsigned char* __restrict__ mask, int lq, int lk, int heads,
                             int hd, float scale_log2, float scale, bf16* __restrict__ dq) {
  // buffer 1 holds Q and dO until their fragments are in registers
  __shared__ __align__(128) bf16 sk[2][kBK * kHD];
  __shared__ __align__(128) bf16 sv[2][kBK * kHD];
  __shared__ unsigned s_keep[2][2];
  __shared__ int s_end[kWarps];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t width = static_cast<size_t>(heads) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int q_rows = min(kBQ, lq - q0);
  const bf16* kb = k + static_cast<size_t>(b) * lk * width + head_off;
  const bf16* vb = v + static_cast<size_t>(b) * lk * width + head_off;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * lk;
  bf16* dqb = dq + (static_cast<size_t>(b) * lq + q0) * width + head_off;

  int end = 0;  // one past the last attended key
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
      dqb[(i / hd) * width + i % hd] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const size_t qrow0 = (static_cast<size_t>(b) * lq + q0) * width + head_off;
  load_tile(sk[1], q + qrow0, width, q_rows, hd);
  load_tile(sv[1], dout + qrow0, width, q_rows, hd);
  load_tile(sk[0], kb, width, min(kBK, lk), hd);
  load_tile(sv[0], vb, width, min(kBK, lk), hd);
  float lse2[2], di_r[2];  // this thread's query rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const size_t at = (static_cast<size_t>(b) * heads + h) * lq + row;
    lse2[r] = row < lq ? lse[at] * kLog2e : INFINITY;
    di_r[r] = row < lq ? di[at] : 0.f;
  }

  unsigned qf[4][4], dof[4][4];
  float adq[8][4];
  zero(adq);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, base = t * kBK;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (warp < 2) {
      const int j = base + threadIdx.x;
      const bool keep = j < end && (mb == nullptr || !mb[j]);
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, keep);
      if (lane == 0) s_keep[buf][warp] = bits;
    }
    __syncthreads();  // tile t is in shared memory; every warp is done with tile t - 1
    if (t == 0) {
      load_a_rows(sk[1], warp * 16, lane, qf);
      load_a_rows(sv[1], warp * 16, lane, dof);
      __syncthreads();  // buffer 1 is free
    }
    if (t + 1 < tiles) {
      const int next = base + kBK;
      load_tile(sk[buf ^ 1], kb + next * width, width, min(kBK, lk - next), hd);
      load_tile(sv[buf ^ 1], vb + next * width, width, min(kBK, lk - next), hd);
    }
    const unsigned long long keep =
        s_keep[buf][0] | (static_cast<unsigned long long>(s_keep[buf][1]) << 32);
    if (keep == 0ull) continue;
    // S = Q K^T, P in f32
    float s[8][4];
    zero(s);
    mma_a_bt(s, qf, sk[buf], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        s[j][e] = (keep >> col) & 1ull ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T; dS = (dP - di) P scale
    float dp[8][4];
    zero(dp);
    mma_a_bt(dp, dof, sv[buf], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = (dp[j][e] - di_r[e >> 1]) * s[j][e] * scale;
    }
    mma_c_t(adq, dp, sk[buf], lane);  // dQ += dS K, dS rounded to bf16
  }
  store_rows(dqb, width, warp * 16, q_rows, hd, adq, g, tig);
}

template <typename T>
int launch_di(const void* o, const void* dout, int b, int lq, int heads, int hd, float* di,
              cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(b) * lq * heads + kDiThreads / 32 - 1) / (kDiThreads / 32);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  attention_di_kernel<T><<<static_cast<unsigned>(blocks), kDiThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), b, lq, heads, hd, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq, heads*hd), k, v (B, Lk, heads*hd), mask (B, Lk) bytes or null,
// out (B, Lq, heads*hd); elem_bytes 4 = f32, 2 = bf16; lse (B, heads, Lq) f32
// or null
extern "C" int amt_attention(const void* q, const void* k, const void* v,
                             const unsigned char* mask, int b, int lq, int lk, int heads, int hd,
                             float scale, int elem_bytes, void* out, float* lse, void* stream) {
  if (b <= 0 || b > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0 || hd <= 0 ||
      hd > kHD || (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return launch_bf16(q, k, v, mask, b, lq, lk, heads, hd, scale, out, lse, st);
  }
  const dim3 grid((lq + kThreads - 1) / kThreads, heads, b);
  attention_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, lq, lk, heads, hd, scale, static_cast<float*>(out), lse);
  return static_cast<int>(cudaGetLastError());
}

// The backward of amt_attention: q, o, dout, dq (B, Lq, heads*hd), k, v, dk,
// dv (B, Lk, heads*hd), lse (B, heads, Lq) f32 from the forward, mask (B, Lk)
// bytes or null, di (B, heads, Lq) f32 scratch. Three launches in order: the
// di pass, dK/dV and dQ (both read the di the first wrote).
extern "C" int amt_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, const unsigned char* mask,
                                 int b, int lq, int lk, int heads, int hd, float scale,
                                 int elem_bytes, float* di, void* dq, void* dk, void* dv,
                                 void* stream) {
  if (b <= 0 || b > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0 || hd <= 0 ||
      hd > kHD || (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const bool bf = elem_bytes == 2;
  if (bf) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (hd % 8 != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(dout) ||
        !aligned(dq) || !aligned(dk) || !aligned(dv)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int code = bf ? launch_di<bf16>(o, dout, b, lq, heads, hd, di, st)
                : launch_di<float>(o, dout, b, lq, heads, hd, di, st);
  if (code != 0) return code;
  if (bf) {
    const float scale_log2 = scale * kLog2e;
    const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
               *vv = static_cast<const bf16*>(v), *dd = static_cast<const bf16*>(dout);
    attention_bwd_dkv_bf16_kernel<<<dim3((lk + kBK - 1) / kBK, heads, b), kTC, 0, st>>>(
        qq, kk, vv, dd, lse, di, mask, lq, lk, heads, hd, scale_log2, scale,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv));
    code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    attention_bwd_dq_bf16_kernel<<<dim3((lq + kBQ - 1) / kBQ, heads, b), kTC, 0, st>>>(
        qq, kk, vv, dd, lse, di, mask, lq, lk, heads, hd, scale_log2, scale,
        static_cast<bf16*>(dq));
    return static_cast<int>(cudaGetLastError());
  }
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v), *dd = static_cast<const float*>(dout);
  attention_bwd_dkv_f32_kernel<<<dim3((lk + kBT - 1) / kBT, heads, b), kBThreads, 0, st>>>(
      qq, kk, vv, dd, lse, di, mask, lq, lk, heads, hd, scale, static_cast<float*>(dk),
      static_cast<float*>(dv));
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  attention_bwd_dq_f32_kernel<<<dim3((lq + kBT - 1) / kBT, heads, b), kBThreads, 0, st>>>(
      qq, kk, vv, dd, lse, di, mask, lq, lk, heads, hd, scale, static_cast<float*>(dq));
  return static_cast<int>(cudaGetLastError());
}
