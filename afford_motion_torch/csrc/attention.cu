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
// layout (B, L, heads * hd), f32 or bf16, where q, k and v (and the
// backward's dq, dk and dv) may be views of one packed projection whose rows
// lie further apart (`Pitch`: the fused q/k/v projection of a self-attention,
// the fused k/v of a cross-attention); logits, the softmax and the
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
// bits to TF32, so it stays on the FP32 units with explicit `fmaf` (the
// library is built with -fmad=false for the distance kernels, so a plain
// a*b+c would cost two instructions). A block per (32 queries by default, or
// 8 or 16, head, batch item), a warp per 8 queries: at the regressor's
// (16, 196, 4x64) that is 448 blocks, and the ragged last tile holds 4 of its
// 32 rows live. Q sits in shared memory; K and V stream through it in tiles
// of 32 keys, double-buffered by `cp.async` (16-byte copies where hd is a
// multiple of 4 and the tensors are 16-byte aligned, else 4-byte ones). S is a
// register-tiled micro-GEMM: lane (r, c) of a warp, r = lane / 16, computes
// its 4 query rows against keys c and c + 16 from float4 reads (Q rows are
// broadcast; K rows are 68 floats apart, so the eight rows a quarter-warp
// reads sit in distinct banks). The online softmax runs per row across the 16
// lanes that share it (maxima by shuffles; each lane keeps its share of the
// row sum, rescaled with the row, and the shares are summed once at the end).
// P goes through the warp's own rows of shared memory (no barrier), and each
// lane owns 4 rows x 4 columns of O, summing P V over the tile's keys in
// order. A tile whose keys are all masked is skipped and keys after the last
// valid one are not loaded, as in bf16.
//
// Backward (`amt_attention_bwd`), as the library's VJP computes it: from the
// saved row statistics (here the log-sum-exp lse), P = exp(s - lse) is
// recomputed in f32, and with di = sum_d o * do over the rounded output,
//   dv = P^T do  (P rounded to the input type first),
//   ds = (do v^T - di) * P * scale,
//   dk = ds^T q,  dq = ds k  (ds rounded to the input type first),
// all sums in f32, each result rounded once. Masked keys get zero rows. The
// bound: 5 products of 2 * B * heads * Lq * Lk * hd and the q, k, v, o, do,
// lse bytes read and dq, dk, dv written (85 MB at the denoiser's shape in
// bf16). No float atomics: two runs give the same bits.
//
// Backward, bf16: one launch (after a memset of its counters), on the
// forward's `mma.sync` fragments and swizzled `cp.async` tiles. Its blocks
// do three kinds of work, which each block takes by a ticket it draws when it
// starts (an integer atomic): first every di tile (64 rows of one item and
// head, from o and dO), then every key tile's dK/dV, then every query tile's
// dQ.
//   dK/dV: a block owns 64 keys of one (item, head), 16 a warp, and walks the
// 64-query tiles in order, Q and dO double-buffered. Per tile: S^T = K Q^T
// and P^T from lse; dV += P^T dO with P^T rounded from the S^T fragments;
// dP^T = V dO^T, dS^T = (dP^T - di) P^T scale; dK += dS^T Q with dS rounded.
// K and V stay in shared memory and their A fragments are read at each use:
// 168 registers, three blocks an SM. Fragments wholly past Lq (16 queries)
// are skipped. The rounded dS^T goes out, through the warp's own rows of
// shared memory (no barrier), to a bf16 scratch of 64 x 64 tiles, swizzled
// as in shared memory, one per (item, head, query tile, key tile): 4
// products, and dS^T rather than S and dP recomputed for dQ.
//   dQ: a block owns 64 queries of one (item, head), 16 a warp, and sums dq
// = dS K over the key tiles in order up to the last attended key, in f32
// (A by `ldmatrix.trans` of the dS^T tile, B by `ldmatrix.trans` of K), the
// tiles streamed through three stages of shared memory; the same order as
// a dQ kernel that recomputes dS per key tile. Tiles with no attended key
// (which have no dS^T) are skipped.
//   The order is kept by counts in the scratch: di tiles count per (item,
// head), and a dK/dV block waits (one thread spins on an acquire load)
// until its (item, head) has all of them; every key tile counts each query
// tile's dS^T out (one thread fences and adds after a barrier), and a dQ
// block waits until its query tile has all of them. Why the waits make
// progress: a block waits only on work whose ticket is lower (di before
// dK/dV, dK/dV before dQ), drawn by a block that had already started and so
// runs, and that block waits only on lower tickets still, down to the di
// work, which waits on none. So a running block never waits on one that has
// not started, whatever order the hardware dispatches blocks in and however
// few fit on the card. Every gradient element has one writer and every sum a
// fixed order: no float atomics, and two calls give the same bits.
//
// Backward, f32 (the f32 flash train step's; a parity surface, so no TF32:
// FP32 units and explicit `fmaf`): 5 products over the attended pairs
// (1.2e10 operations at the train step's (32, 326, 8x64) with its masks, 0.18
// ms at the H100's 67 TFLOP/s) against 0.03 ms of bytes, so the design keeps
// the FP32 units fed. A block per key tile of 64 keys (256 threads) walks its
// query tiles of 32 in order, Q and dO double-buffered
// by `cp.async` (16-byte copies where hd is a multiple of 4 and the tensors
// 16-byte aligned, else 4-byte ones), K and V transposed once into shared
// memory. Per query tile, S = Q K^T and dP = dO V^T are register-tiled
// micro-GEMMs (a thread 4 keys x 2 queries; a 16-byte load of K^T or
// V^T feeds 8 FMAs, one of a Q or dO row 4), P = exp2(s scale log2 e -
// lse log2 e) and dS = (dP - di) P scale come from them once, go to shared
// memory, and dV += P^T dO, dK += dS^T Q sum over the tile's queries in
// order (a thread 4 keys x 4 dimensions, 8 FMAs a 16-byte load); a warp
// whose 32 keys are none attended leaves them out. di = sum o dO of the
// next tile is loaded during the products and summed after (4 threads a
// row). dS also goes out to a scratch, (item, head, key tile, Lq, 64) f32,
// which the dQ work reads: a block per 64 queries (4 x 4 a thread) sums dS
// K over the key tiles in order up to the last attended key (tiles with no
// attended key skipped), the dS and K tiles streamed through three stages,
// so S and dS are computed once per (query tile, key tile). The dQ work
// comes in the same launch (a memset of its counters first): each block
// draws a ticket, every dK/dV tile's before every dQ block's, and a dQ block
// waits until every key tile counted its dS out, as in bf16. No float
// atomics: every element has one writer and every sum a fixed order, and
// two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kHD = 64;  // the largest head dimension; every attention in the repo has 64
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the row pitch, in elements, of q, k and v and of the backward's dq, dk and
// dv: row r of item b of a (B, L, heads * hd) tensor starts (b L + r) pitch
// elements from its base, and head h hd elements into that row. A contiguous
// tensor's pitch is heads * hd; a view of a packed projection (q, k, v of one
// (B, L, 3 D) qkv, or k, v of one (B, Lk, 2 D) kv) has 3 D or 2 D, so the
// kernels read and write such views where they lie, without a copy. Only
// the step from one row to the next changes: a head still reads and writes
// hd consecutive elements of a row. The forward's out and lse and the
// backward's o and dout are contiguous. The f32 backward kernel takes the
// pitches as an argument of its own beside BwdF32Args: with them inside that
// struct the contiguous f32 backward ran 2.5% slower on an H100 (the same
// device code; the argument struct's layout alone). The bf16 backward keeps
// them in BwdArgs, where taking them apart measured no faster.
struct Pitch {
  size_t q, k, v, dq, dk, dv;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------- float32

constexpr int kFK = 32;         // keys a tile
constexpr int kFLd = kHD + 4;   // a Q or K row in shared memory: 16-byte aligned, 4 banks apart
constexpr int kFPLd = kFK + 4;  // a row of P
constexpr int kF32Rows = 32;    // queries a block unless the launch asks for 8 or 16

// rows x hd of a (.., stride) f32 matrix into a tile of `tile_rows` rows `ld`
// floats apart by cp.async, zeros past `rows` and `hd`: 16-byte copies when
// `vec` (hd a multiple of 4, 16-byte aligned rows), else 4-byte ones;
// completes at the next cp.async.wait_all
template <int NT>
__device__ __forceinline__ void load_f32(float* tile, int ld, int tile_rows, const float* src,
                                         size_t stride, int rows, int hd, bool vec,
                                         bool commit = true) {
  if (vec) {
    for (int i = threadIdx.x; i < tile_rows * (kHD / 4); i += NT) {
      const int r = i / (kHD / 4), c = (i % (kHD / 4)) * 4;
      const bool ok = r < rows && c < hd;
      const float* g = ok ? src + r * stride + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(tile + r * ld + c)),
                   "l"(g), "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < tile_rows * kHD; i += NT) {
      const int r = i / kHD, d = i % kHD;
      const bool ok = r < rows && d < hd;
      const float* g = ok ? src + r * stride + d : src;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(tile + r * ld + d)),
                   "l"(g), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
  if (commit) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// a block QB queries of one (item, head), 8 a warp; lane (r, c): rows
// 4r..4r+3 of the warp's 8, keys c and c + 16 of each tile, O columns
// 4c..4c+3
template <int QB>
__global__ void __launch_bounds__(QB * 4)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const unsigned char* __restrict__ mask, int lq,
                     int lk, int heads, int hd, float scale, bool vec, float* __restrict__ out,
                     float* __restrict__ lse, Pitch ld) {
  constexpr int kNT = QB * 4, kW = QB / 8;
  __shared__ __align__(16) float sq[QB * kFLd];
  __shared__ __align__(16) float sk[2][kFK * kFLd];
  __shared__ __align__(16) float sv[2][kFK * kHD];
  __shared__ __align__(16) float sp[QB * kFPLd];
  __shared__ unsigned s_keep[2];  // a bit a key of the tile: 1 = attend
  __shared__ int s_end[kW];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 15, row0 = warp * 8 + (lane >> 4) * 4;
  const size_t width = static_cast<size_t>(heads) * hd;  // out's rows
  const float* qb = q + (static_cast<size_t>(b) * lq + q0) * ld.q + h * hd;
  const float* kb = k + static_cast<size_t>(b) * lk * ld.k + h * hd;
  const float* vb = v + static_cast<size_t>(b) * lk * ld.v + h * hd;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * lk;
  float* ob = out + (static_cast<size_t>(b) * lq + q0) * width + h * hd;
  const int q_rows = min(QB, lq - q0);

  // one past the last key that is attended: later keys are never loaded
  int end = 0;
  for (int j = threadIdx.x; j < lk; j += kNT) {
    if (mb == nullptr || !mb[j]) end = j + 1;
  }
  end = static_cast<int>(__reduce_max_sync(0xFFFFFFFFu, static_cast<unsigned>(end)));
  if (lane == 0) s_end[warp] = end;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kW; ++w) end = max(end, s_end[w]);
  const int tiles = (end + kFK - 1) / kFK;
  if (tiles == 0) {  // no key attended: zero rows
    for (int i = threadIdx.x; i < q_rows * hd; i += kNT) ob[(i / hd) * width + i % hd] = 0.f;
    if (lse != nullptr) {
      for (int i = threadIdx.x; i < q_rows; i += kNT) {
        lse[(static_cast<size_t>(b) * heads + h) * lq + q0 + i] = INFINITY;
      }
    }
    return;
  }
  load_f32<kNT>(sq, kFLd, QB, qb, ld.q, q_rows, hd, vec);
  load_f32<kNT>(sk[0], kFLd, kFK, kb, ld.k, min(kFK, lk), hd, vec);
  load_f32<kNT>(sv[0], kHD, kFK, vb, ld.v, min(kFK, lk), hd, vec);

  const bool live = warp * 8 < q_rows;  // a warp whose rows all lie past Lq idles
  float acc[4][4];                      // O: rows row0 + i, columns 4c + e
  float m_run[4], l_run[4];             // the row maxima; this lane's share of the row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, base = t * kFK;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (warp == 0) {
      const int j = base + lane;
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, j < end && (mb == nullptr || !mb[j]));
      if (lane == 0) s_keep[buf] = bits;
    }
    // tile t (and Q) is in shared memory, and every warp is done with tile
    // t - 1, whose buffers the next loads take
    __syncthreads();
    if (t + 1 < tiles) {
      const int next = base + kFK;
      load_f32<kNT>(sk[buf ^ 1], kFLd, kFK, kb + next * ld.k, ld.k, min(kFK, lk - next), hd,
                    vec);
      load_f32<kNT>(sv[buf ^ 1], kHD, kFK, vb + next * ld.v, ld.v, min(kFK, lk - next), hd,
                    vec);
    }
    const unsigned keep = s_keep[buf];
    if (!live || keep == 0u) continue;

    // S: 4 rows x keys c, c + 16, full-length dot products in order of d
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    const float* kt = sk[buf];
#pragma unroll
    for (int d = 0; d < kHD; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sq + (row0 + i) * kFLd + d);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        kv[jj] = *reinterpret_cast<const float4*>(kt + (c + 16 * jj) * kFLd + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
      }
    }

    // online softmax over this tile, per row across its 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        s[i][jj] = (keep >> (c + 16 * jj)) & 1u ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing attended yet
      const float alpha = expf(m_run[i] - m_use);           // 0 on the first tile
      m_run[i] = m_new;
      const float p0 = expf(s[i][0] - m_use), p1 = expf(s[i][1] - m_use);
      l_run[i] = l_run[i] * alpha + (p0 + p1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
      sp[(row0 + i) * kFPLd + c] = p0;
      sp[(row0 + i) * kFPLd + c + 16] = p1;
    }
    __syncwarp();  // P of the warp's rows is in shared memory

    // O += P V: the tile's keys in order
    const float* vt = sv[buf];
#pragma unroll
    for (int j = 0; j < kFK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(sp + (row0 + i) * kFPLd + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + (j + jj) * kHD + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane_of(pv[i], jj);
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
    }
    __syncwarp();  // done reading P before the next tile writes it
  }
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(0xFFFFFFFFu, l, off);
    const int row = row0 + i;
    if (row >= q_rows) continue;
    if (lse != nullptr && c == 0) {
      lse[(static_cast<size_t>(b) * heads + h) * lq + q0 + row] =
          l > 0.f ? m_run[i] + logf(l) : INFINITY;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = ob + row * width + 4 * c;
    if (vec) {
      if (4 * c < hd) {
        *reinterpret_cast<float4*>(orow) =
            make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e < hd) orow[e] = acc[i][e] * inv;
      }
    }
  }
}

template <int QB>
int launch_f32(const float* q, const float* k, const float* v, const unsigned char* mask, int b,
               int lq, int lk, int heads, int hd, float scale, float* out, float* lse, Pitch ld,
               cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out) &&
                   ld.q % 4 == 0 && ld.k % 4 == 0 && ld.v % 4 == 0;
  const dim3 grid((lq + QB - 1) / QB, heads, b);
  attention_f32_kernel<QB><<<grid, QB * 4, 0, stream>>>(q, k, v, mask, lq, lk, heads, hd, scale,
                                                        vec, out, lse, ld);
  return static_cast<int>(cudaGetLastError());
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
// swizzled 64-row tile read as the B operand with its rows as columns. kTrim:
// tile rows from `rows` on (16 at a time) are left out, their columns of acc
// untouched (a branch in the products, which the untrimmed instance has not)
template <bool kTrim = false>
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4], const unsigned (&a)[4][4],
                                         const bf16* tile, int lane, int rows = 64) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (kTrim && 16 * jp >= rows) continue;
      const int row = 16 * jp + (lane & 7) + ((mi >> 1) << 3);
      unsigned r[4];
      ldmatrix_x4(smem_addr(tile + swz(row, (2 * kk + (mi & 1)) * 8)), r);
      mma(acc[2 * jp], a[kk], r[0], r[1]);
      mma(acc[2 * jp + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc (16 x 64 over hd) += C (16 x 64, fragments rounded to bf16) . T, T a
// swizzled 64-row tile read as the B operand by `ldmatrix.trans`; kTrim: tile
// rows from `rows` on (16 at a time) are left out
template <bool kTrim = false>
__device__ __forceinline__ void mma_c_t(float (&acc)[8][4], const float (&c)[8][4],
                                        const bf16* tile, int lane, int rows = 64) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kTrim && 16 * kk >= rows) continue;
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

// acc (16 x 64 over hd) += A . T, A the 16 x 64 transpose of columns
// col0..col0 + 15 of the swizzled 64 x 64 tile `at` (its rows the product's
// inner dimension, so A comes by `ldmatrix.trans` as well), T a swizzled
// 64-row tile read as the B operand by `ldmatrix.trans`
__device__ __forceinline__ void mma_at_t(float (&acc)[8][4], const bf16* at, int col0,
                                         const bf16* tile, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // matrix mi of the A fragment: columns col0 + 8 (mi & 1) of A's rows,
    // inner rows 16 kk + 8 (mi >> 1) of `at`
    unsigned a[4];
    ldmatrix_x4_trans(
        smem_addr(at + swz(16 * kk + (lane & 7) + ((mi >> 1) << 3), col0 + ((mi & 1) << 3))), a);
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
                      float* __restrict__ lse, Pitch ld) {
  __shared__ __align__(128) bf16 sq[kBQ * kHD];
  __shared__ __align__(128) bf16 sk[2][kBK * kHD];
  __shared__ __align__(128) bf16 sv[2][kBK * kHD];
  __shared__ unsigned s_keep[2][2];  // a bit a key of the tile: 1 = attend
  __shared__ int s_end[kWarps];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row and column pair
  const size_t width = static_cast<size_t>(heads) * hd;  // out's rows
  const bf16* qb = q + (static_cast<size_t>(b) * lq + q0) * ld.q + h * hd;
  const bf16* kb = k + static_cast<size_t>(b) * lk * ld.k + h * hd;
  const bf16* vb = v + static_cast<size_t>(b) * lk * ld.v + h * hd;
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
  load_tile(sq, qb, ld.q, q_rows, hd);
  load_tile(sk[0], kb, ld.k, min(kBK, lk), hd);
  load_tile(sv[0], vb, ld.v, min(kBK, lk), hd);

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
      load_tile(sk[buf ^ 1], kb + next * ld.k, ld.k, min(kBK, lk - next), hd);
      load_tile(sv[buf ^ 1], vb + next * ld.v, ld.v, min(kBK, lk - next), hd);
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
                int lq, int lk, int heads, int hd, float scale, void* out, float* lse, Pitch ld,
                cudaStream_t stream) {
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, b);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (hd % 8 != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) ||
      ld.q % 8 != 0 || ld.k % 8 != 0 || ld.v % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(out);
  attention_bf16_kernel<<<grid, kTC, 0, stream>>>(qq, kk, vv, mask, lq, lk, heads, hd,
                                                  scale_log2, oo, lse, ld);
  return static_cast<int>(cudaGetLastError());
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

// one dS^T tile in the scratch: 64 keys x 64 queries, swizzled as in shared
// memory, so that it goes out and comes back by plain 16-byte copies
constexpr int kTile = kBK * kBQ;

// dynamic shared memory of the bf16 backward: the dK/dV work's Q and dO tiles
// (two each), K, V, the warps' dS^T rows and two buffers of lse and di (57 KB:
// three blocks an SM); the dQ work uses the first 48 KB
constexpr int kBwdSmem =
    (4 * kBQ * kHD + 3 * kBK * kHD) * static_cast<int>(sizeof(bf16)) + 4 * kBQ * 4;

// what the bf16 backward's blocks share: the tensors, the shape, and the
// counters of one call: sync[0] the ticket, then one count a (item, head)
// of the di tiles done, then one a (item, head, query tile) of the key tiles
// whose dS^T is out
struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  const unsigned char* mask;
  int b, lq, lk, heads, hd;
  float scale_log2, scale;
  float* di;
  bf16* ds;
  int* sync;
  bf16 *dq, *dk, *dv;
  Pitch ld;  // rows of q, k, v, dq, dk, dv; o and dout are (B, L, heads * hd)
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the block's writes before this are seen by any block that reads `count`
// past them (a barrier, then one thread's release: the pattern of CUTLASS's
// semaphore)
__device__ __forceinline__ void count_up(int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1);
  }
}

// waits until `count` reaches `target`; what the blocks that counted wrote
// before is then seen
__device__ __forceinline__ void wait_for(const int* count, int target) {
  if (threadIdx.x == 0) {
    while (load_acquire(count) < target) {
    }
  }
  __syncthreads();
}

// di of query tile t of one (item, head): thread tid half a row (row tid / 2,
// chunks 4 (tid & 1)..+3 of 8 entries) in order of d, the halves added
__device__ void bwd_di(const BwdArgs& a, int bh, int t) {
  const int b = bh / a.heads, h = bh % a.heads, q0 = t * kBQ, rows = min(kBQ, a.lq - q0);
  const int row = threadIdx.x >> 1, chunk = (threadIdx.x & 1) * 4;
  const size_t at =
      (static_cast<size_t>(b) * a.lq + q0 + row) * a.heads * a.hd + static_cast<size_t>(h) * a.hd;
  float s = 0.f;
  if (row < rows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = (chunk + i) * 8;
      if (d >= a.hd) break;
      const uint4 o4 = *reinterpret_cast<const uint4*>(a.o + at + d);
      const uint4 g4 = *reinterpret_cast<const uint4*>(a.dout + at + d);
      const bf16* x = reinterpret_cast<const bf16*>(&o4);
      const bf16* y = reinterpret_cast<const bf16*>(&g4);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(__bfloat162float(x[e]), __bfloat162float(y[e]), s);
    }
  }
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
  if ((threadIdx.x & 1) == 0 && row < rows) a.di[static_cast<size_t>(bh) * a.lq + q0 + row] = s;
  count_up(a.sync + 1 + bh);
}

// dK, dV of key tile kt of one (item, head), 16 keys a warp, walking the
// query tiles in order, and each query tile's dS^T (rounded) out to the
// scratch, tile (item, head, query tile, key tile), counted per query tile.
// A key tile with no attended key writes zero dk, dv rows and no dS^T
// (and still counts). K and V stay in shared memory and their A fragments
// are read at each use, which leaves the registers (168) for three blocks an
// SM.
__device__ void bwd_dkv(const BwdArgs& a, int bh, int kt, unsigned char* smem) {
  bf16(*sq)[kBQ * kHD] = reinterpret_cast<bf16(*)[kBQ * kHD]>(smem);  // two Q tiles
  bf16(*sdo)[kBQ * kHD] = sq + 2;                                        // two dO tiles
  bf16* sk = sdo[2];
  bf16* sv = sk + kBK * kHD;
  bf16* sds = sv + kBK * kHD;  // this tile's dS^T, rounded
  float(*s_lse)[kBQ] = reinterpret_cast<float(*)[kBQ]>(sds + kTile);  // log2 units
  float(*s_di)[kBQ] = s_lse + 2;

  const int b = bh / a.heads, h = bh % a.heads, k0 = kt * kBK, lq = a.lq, lk = a.lk, hd = a.hd;
  const int nkt = (lk + kBK - 1) / kBK, nqt = (lq + kBQ - 1) / kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int tid = threadIdx.x;
  const size_t width = static_cast<size_t>(a.heads) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int k_rows = min(kBK, lk - k0);
  const unsigned char* mb = a.mask == nullptr ? nullptr : a.mask + static_cast<size_t>(b) * lk;
  bf16* dkb = a.dk + (static_cast<size_t>(b) * lk + k0) * a.ld.dk + head_off;
  bf16* dvb = a.dv + (static_cast<size_t>(b) * lk + k0) * a.ld.dv + head_off;
  const bf16* qb = a.q + static_cast<size_t>(b) * lq * a.ld.q + head_off;
  const bf16* dob = a.dout + static_cast<size_t>(b) * lq * width + head_off;
  const float* lse_b = a.lse + static_cast<size_t>(bh) * lq;
  const float* di_b = a.di + static_cast<size_t>(bh) * lq;
  int* done = a.sync + 1 + a.b * a.heads + static_cast<size_t>(bh) * nqt;

  int attended = 0;
  if (tid < kBK) attended = tid < k_rows && (mb == nullptr || !mb[k0 + tid]);
  if (!__syncthreads_or(attended)) {  // no key of the tile attended: zero rows
    for (int i = tid; i < k_rows * hd; i += kTC) {
      dkb[(i / hd) * a.ld.dk + i % hd] = __float2bfloat16_rn(0.f);
      dvb[(i / hd) * a.ld.dv + i % hd] = __float2bfloat16_rn(0.f);
    }
    for (int t = tid; t < nqt; t += kTC) atomicAdd(done + t, 1);  // no dS^T to see
    return;
  }
  bool keep[2];  // this thread's key rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    keep[r] = key < lk && (mb == nullptr || !mb[key]);
  }
  load_tile(sk, a.k + (static_cast<size_t>(b) * lk + k0) * a.ld.k + head_off, a.ld.k, k_rows,
            hd);
  load_tile(sv, a.v + (static_cast<size_t>(b) * lk + k0) * a.ld.v + head_off, a.ld.v, k_rows,
            hd);
  load_tile(sq[0], qb, a.ld.q, min(kBQ, lq), hd);
  load_tile(sdo[0], dob, width, min(kBQ, lq), hd);
  wait_for(a.sync + 1 + bh, nqt);  // every di tile of the (item, head) is out
  if (tid < kBQ) {
    s_lse[0][tid] = tid < lq ? lse_b[tid] * kLog2e : INFINITY;
  } else {
    const int i = tid - kBQ;
    s_di[0][i] = i < lq ? __ldcg(di_b + i) : 0.f;
  }

  unsigned kf[4][4], vf[4][4];  // A fragments of this warp's K and V rows, read at each use
  float adk[8][4], adv[8][4];
  zero(adk);
  zero(adv);
  for (int t = 0; t < nqt; ++t) {
    const int buf = t & 1, q0 = t * kBQ, rows = min(kBQ, lq - q0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile t is in shared memory; every warp is done with tile t - 1
    if (t > 0 && tid == 0) {  // every warp's dS^T of tile t - 1 is out (count_up)
      __threadfence();
      atomicAdd(done + t - 1, 1);
    }
    if (t + 1 < nqt) {
      const int next = q0 + kBQ, next_rows = min(kBQ, lq - next);
      load_tile(sq[buf ^ 1], qb + next * a.ld.q, a.ld.q, next_rows, hd);
      load_tile(sdo[buf ^ 1], dob + next * width, width, next_rows, hd);
      if (tid < kBQ) {
        s_lse[buf ^ 1][tid] = tid < next_rows ? lse_b[next + tid] * kLog2e : INFINITY;
      } else {
        const int i = tid - kBQ;
        s_di[buf ^ 1][i] = i < next_rows ? __ldcg(di_b + next + i) : 0.f;
      }
    }
    // S^T = K Q^T: this warp's 16 keys x the tile's queries; P^T in f32
    float st[8][4];
    zero(st);
    load_a_rows(sk, warp * 16, lane, kf);
    if (rows == kBQ) {
      mma_a_bt(st, kf, sq[buf], lane);
    } else {  // the ragged last tile: fragments wholly past Lq are left out
      mma_a_bt<true>(st, kf, sq[buf], lane, rows);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        st[j][e] = keep[e >> 1] ? exp2f(st[j][e] * a.scale_log2 - s_lse[buf][col]) : 0.f;
      }
    }
    // dV += P^T dO, P rounded to bf16
    if (rows == kBQ) {
      mma_c_t(adv, st, sdo[buf], lane);
    } else {
      mma_c_t<true>(adv, st, sdo[buf], lane, rows);
    }
    // dP^T = V dO^T; dS^T = (dP^T - di) P^T scale
    float dpt[8][4];
    zero(dpt);
    load_a_rows(sv, warp * 16, lane, vf);
    if (rows == kBQ) {
      mma_a_bt(dpt, vf, sdo[buf], lane);
    } else {
      mma_a_bt<true>(dpt, vf, sdo[buf], lane, rows);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        dpt[j][e] = (dpt[j][e] - s_di[buf][col]) * st[j][e] * a.scale;
      }
    }
    // dK += dS^T Q, dS rounded to bf16
    if (rows == kBQ) {
      mma_c_t(adk, dpt, sq[buf], lane);
    } else {
      mma_c_t<true>(adk, dpt, sq[buf], lane, rows);
    }
    // dS^T, rounded, to the scratch by way of this warp's 16 rows of shared
    // memory (16-byte rows; no block barrier)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<unsigned*>(sds + swz(warp * 16 + g + 8 * r, 8 * j + 2 * tig)) =
            pack_bf16(dpt[j][2 * r], dpt[j][2 * r + 1]);
      }
    }
    __syncwarp();
    const int first = warp * 16 * kChunks;  // the warp's rows, as 16-byte chunks
    uint4* out = reinterpret_cast<uint4*>(a.ds + ((static_cast<size_t>(bh) * nqt + t) * nkt + kt) *
                                                     kTile);
    for (int i = first + lane; i < first + 16 * kChunks; i += 32) {
      out[i] = reinterpret_cast<const uint4*>(sds)[i];
    }
  }
  count_up(done + nqt - 1);
  store_rows(dkb, a.ld.dk, warp * 16, k_rows, hd, adk, g, tig);
  store_rows(dvb, a.ld.dv, warp * 16, k_rows, hd, adv, g, tig);
}

// stages of the dQ work's stream of dS^T and K tiles
constexpr int kDqStages = 3;
static_assert(kDqStages * (kTile + kBK * kHD) * static_cast<int>(sizeof(bf16)) <= kBwdSmem,
              "the dQ work's stages fit in the dK/dV work's shared memory");

// dq of query tile t of one (item, head), 16 queries a warp: dS K over the
// key tiles in order up to the last attended key, once every key tile has
// counted its dS^T out; the dS^T tiles and K stream through shared memory in
// kDqStages stages (the dS^T tiles mostly come from device memory); a tile
// with no attended key (no dS^T) is skipped
__device__ void bwd_dq(const BwdArgs& a, int bh, int t, unsigned char* smem) {
  bf16(*sds)[kTile] = reinterpret_cast<bf16(*)[kTile]>(smem);
  bf16(*sk)[kBK * kHD] = reinterpret_cast<bf16(*)[kBK * kHD]>(sds + kDqStages);
  __shared__ int s_end[kWarps];

  const int b = bh / a.heads, h = bh % a.heads, q0 = t * kBQ, lq = a.lq, lk = a.lk, hd = a.hd;
  const int nkt = (lk + kBK - 1) / kBK, nqt = (lq + kBQ - 1) / kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int q_rows = min(kBQ, lq - q0);
  const bf16* kb = a.k + static_cast<size_t>(b) * lk * a.ld.k + head_off;
  const bf16* dst = a.ds + (static_cast<size_t>(bh) * nqt + t) * nkt * kTile;
  const unsigned char* mb = a.mask == nullptr ? nullptr : a.mask + static_cast<size_t>(b) * lk;
  bf16* dqb = a.dq + (static_cast<size_t>(b) * lq + q0) * a.ld.dq + head_off;

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
      dqb[(i / hd) * a.ld.dq + i % hd] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  wait_for(a.sync + 1 + a.b * a.heads + static_cast<size_t>(bh) * nqt + t, nkt);
  const auto fetch = [&](int kt, int buf) {  // dS^T tile kt (as written) and K tile kt
    for (int i = threadIdx.x; i < kTile / 8; i += kTC) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(sds[buf] + 8 * i)),
                   "l"(dst + kt * kTile + 8 * i)
                   : "memory");
    }
    load_tile(sk[buf], kb + kt * kBK * a.ld.k, a.ld.k, min(kBK, lk - kt * kBK), hd);
  };
  for (int kt = 0; kt < kDqStages - 1 && kt < tiles; ++kt) fetch(kt, kt);
  float adq[8][4];
  zero(adq);
  for (int kt = 0; kt < tiles; ++kt) {
    const int stage = kt % kDqStages, j = kt * kBK + threadIdx.x;
    if (kt + 1 < tiles) {  // one copy group a tile: all but the next one's done
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kDqStages - 2) : "memory");
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    // tile kt is in shared memory; every warp is done with tile kt - 1,
    // whose stage the next copy takes
    const bool any = __syncthreads_or(threadIdx.x < kBK && j < end && (mb == nullptr || !mb[j]));
    if (kt + kDqStages - 1 < tiles) fetch(kt + kDqStages - 1, (kt + kDqStages - 1) % kDqStages);
    if (any && warp * 16 < q_rows) mma_at_t(adq, sds[stage], warp * 16, sk[stage], lane);
  }
  store_rows(dqb, a.ld.dq, warp * 16, q_rows, hd, adq, g, tig);
}

// the whole bf16 backward in one launch: each block draws a ticket and takes
// the work it names, in ticket order every di tile, then every key tile's
// dK/dV (which waits for its (item, head)'s di), then every query tile's dQ
// (which waits for its dS^T from every key tile)
__global__ void __launch_bounds__(kTC, 3) attention_bwd_bf16_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(a.sync, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int nkt = (a.lk + kBK - 1) / kBK, nqt = (a.lq + kBQ - 1) / kBQ;
  const int n_di = a.b * a.heads * nqt, n_kv = a.b * a.heads * nkt;
  if (ticket < n_di) {
    bwd_di(a, ticket / nqt, ticket % nqt);
  } else if (ticket < n_di + n_kv) {
    bwd_dkv(a, (ticket - n_di) / nkt, (ticket - n_di) % nkt, smem);
  } else {
    bwd_dq(a, (ticket - n_di - n_kv) / nqt, (ticket - n_di - n_kv) % nqt, smem);
  }
}

// --------------------------------------------------------- backward: float32

constexpr int kFBThreads = 256;  // threads a block
constexpr int kFBK = 64;         // keys a tile, of the dK/dV work and of the dQ work's walk
constexpr int kTLd = kFBK + 4;   // a row (one dimension) of K^T or V^T: 16-byte aligned
constexpr int kRLd = kHD + 4;    // a row of Q, dO or dS in shared memory: rows 4 banks apart
constexpr int kFDq = 64;         // queries a block of the dQ work
constexpr int kFDqStages = 3;    // stages of the dQ work's stream of dS and K tiles
constexpr int kFQT = 32;         // queries a tile of the dK/dV work's walk

// what the f32 backward's blocks share: the tensors, the shape, the dS tiles
// (B * heads, key tiles, Lq, 64) the dK/dV work writes and the dQ work
// reads, and the counters: sync[0] the ticket, then one a (item, head,
// query tile) of the key tiles whose dS is out
struct BwdF32Args {
  const float *q, *k, *v, *o, *dout, *lse;
  const unsigned char* mask;
  int b, lq, lk, heads, hd;
  float scale, scale_log2;  // hd^-1/2, and times log2(e)
  bool vec;  // hd and every row pitch multiples of 4, every tensor 16-byte aligned
  float* ds;
  int* sync;
  float *dq, *dk, *dv;
};

// dynamic shared memory of the f32 backward: the dK/dV work's K^T and V^T,
// two Q and two dO tiles, P and dS, two buffers of lse and di (86 KB), or
// the dQ work's stages (99 KB), whichever is larger: two blocks an SM
constexpr int f32_bwd_smem() {
  constexpr int dkv = (2 * kHD * kTLd + 4 * kFQT * kRLd + 2 * kFQT * kFBK + 4 * kFQT) * 4;
  constexpr int dq = kFDqStages * (kFDq * kRLd + kFBK * kHD) * 4;
  return dkv > dq ? dkv : dq;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows x hd of a (.., stride) f32 matrix (keys) into its transpose in
// shared memory, dimension d at t[d * kTLd], zeros past `rows` and `hd`.
// Lane j of a warp takes key j (4 dimensions a load), so the stores of a
// warp fall in 32 distinct banks.
__device__ __forceinline__ void fill_transposed(float* t, const float* src, size_t stride,
                                                int rows, int hd, bool vec) {
  for (int i = threadIdx.x; i < kFBK * (kHD / 4); i += kFBThreads) {
    const int j = i % kFBK, d = (i / kFBK) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < rows && d < hd) {
      if (vec) {
        const float4 w = *reinterpret_cast<const float4*>(src + j * stride + d);
        x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = d + e < hd ? src[j * stride + d + e] : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) t[(d + e) * kTLd + j] = x[e];
  }
}

// the row statistics of one query tile: thread tid of the first 4 kFQT takes
// dimensions 16 (tid & 3) .. + 15 of row tid / 4 of o and dO (loaded here,
// summed by stats_finish, so that the loads overlap the work between)
struct StatRow {
  float o[16], g[16], lse;
};

__device__ __forceinline__ void stats_load(StatRow& r, const BwdF32Args& a, const float* ob,
                                           const float* gb, const float* lse_b, int q0, int rows,
                                           size_t width) {
  const int row = threadIdx.x >> 2, d0 = (threadIdx.x & 3) * 16;
  const bool live = row < rows;
  const float* op = ob + (q0 + row) * width + d0;
  const float* gp = gb + (q0 + row) * width + d0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int d = d0 + 4 * m;
    if (live && a.vec && d < a.hd) {
      const float4 x = ld4(op + 4 * m), y = ld4(gp + 4 * m);
      r.o[4 * m] = x.x, r.o[4 * m + 1] = x.y, r.o[4 * m + 2] = x.z, r.o[4 * m + 3] = x.w;
      r.g[4 * m] = y.x, r.g[4 * m + 1] = y.y, r.g[4 * m + 2] = y.z, r.g[4 * m + 3] = y.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live && !a.vec && d + e < a.hd;
        r.o[4 * m + e] = ok ? op[4 * m + e] : 0.f;
        r.g[4 * m + e] = ok ? gp[4 * m + e] : 0.f;
      }
    }
  }
  r.lse = live ? lse_b[q0 + row] : INFINITY;
}

// di = sum_d o * dO of the row: each of its 4 threads sums its 16 entries in
// order of d, then (s0 + s1) + (s2 + s3); lse log2(e) and di into shared
// memory
__device__ __forceinline__ void stats_finish(const StatRow& r, float* s_lse, float* s_di) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) s = fmaf(r.o[e], r.g[e], s);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
  if ((threadIdx.x & 3) == 0) {
    s_lse[threadIdx.x >> 2] = r.lse * kLog2e;
    s_di[threadIdx.x >> 2] = s;
  }
}

// dK, dV of key tile kt of one (item, head), walking its query tiles of kFQT
// in order, and each query tile's dS out to a.ds (counted per query tile).
// Warp w covers keys 32 (w & 1) .. +31 and lane l keys
// 32 (w & 1) + 4 (l & 7) .. +3: for S, P, dP and dS it takes 2 of the
// warp's 8 queries from (w >> 1) 8, l >> 3 + 4r (register
// tiles, dot products over d in order; a 16-byte load of K^T or V^T is one
// 128-byte line for the warp, and its Q and dO rows, 68 floats apart, sit
// in distinct banks); for dK and dV dimensions 16 (w >> 1) + 4 (l >> 3) ..
// +3, summed over the tile's queries in order from P and dS in shared
// memory. A key tile with no attended key writes zero rows and no dS (and
// still counts); a warp whose 32 keys are none attended writes zero dS and
// leaves its products out.
__device__ void bwd_f32_dkv(const BwdF32Args& a, const Pitch& ld, int bh, int kt,
                            float* smem) {
  constexpr int kQPT = kFQT / 16;
  float* skt = smem;  // K^T, V^T: 64 dimensions x kTLd
  float* svt = skt + kHD * kTLd;
  float(*sq)[kFQT * kRLd] = reinterpret_cast<float(*)[kFQT * kRLd]>(svt + kHD * kTLd);  // two
  float(*sdo)[kFQT * kRLd] = sq + 2;                                                    // two
  float* sp = sdo[2];  // P: kFQT queries x 64 keys
  float* sds = sp + kFQT * kFBK;
  float(*s_lse)[kFQT] = reinterpret_cast<float(*)[kFQT]>(sds + kFQT * kFBK);
  float(*s_di)[kFQT] = s_lse + 2;

  const int b = bh / a.heads, h = bh % a.heads, k0 = kt * kFBK, lq = a.lq, lk = a.lk, hd = a.hd;
  const int nkt = (lk + kFBK - 1) / kFBK, nqt = (lq + kFQT - 1) / kFQT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key0 = 32 * (warp & 1) + 4 * (lane & 7);       // this thread's 4 keys
  const int row0 = (warp >> 1) * 4 * kQPT + (lane >> 3);   // its queries row0 + 4r
  const int dim0 = 16 * (warp >> 1) + 4 * (lane >> 3);     // its 4 dimensions of dK, dV
  const size_t width = static_cast<size_t>(a.heads) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int k_rows = min(kFBK, lk - k0);
  const unsigned char* mb = a.mask == nullptr ? nullptr : a.mask + static_cast<size_t>(b) * lk;
  float* dkb = a.dk + (static_cast<size_t>(b) * lk + k0) * ld.dk + head_off;
  float* dvb = a.dv + (static_cast<size_t>(b) * lk + k0) * ld.dv + head_off;
  const float* qb = a.q + static_cast<size_t>(b) * lq * ld.q + head_off;
  const float* dob = a.dout + static_cast<size_t>(b) * lq * width + head_off;
  const float* ob = a.o + static_cast<size_t>(b) * lq * width + head_off;
  const float* lse_b = a.lse + static_cast<size_t>(bh) * lq;
  float* dsb = a.ds + (static_cast<size_t>(bh) * nkt + kt) * lq * kFBK;
  int* done = a.sync + 1 + static_cast<size_t>(bh) * nqt;

  int attended = 0;
  if (tid < kFBK) attended = tid < k_rows && (mb == nullptr || !mb[k0 + tid]);
  if (!__syncthreads_or(attended)) {  // no key of the tile attended: zero rows
    for (int i = tid; i < k_rows * hd; i += kFBThreads) {
      dkb[(i / hd) * ld.dk + i % hd] = 0.f;
      dvb[(i / hd) * ld.dv + i % hd] = 0.f;
    }
    for (int t = tid; t < nqt; t += kFBThreads) atomicAdd(done + t, 1);  // no dS to see
    return;
  }
  bool keep[4];  // this thread's keys
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = k0 + key0 + c;
    keep[c] = key < lk && (mb == nullptr || !mb[key]);
  }
  // any of the warp's 32 keys attended (the same keys in both products)
  const bool half = __any_sync(0xFFFFFFFFu, keep[0] || keep[1] || keep[2] || keep[3]);
  load_f32<kFBThreads>(sq[0], kRLd, kFQT, qb, ld.q, min(kFQT, lq), hd, a.vec, false);
  load_f32<kFBThreads>(sdo[0], kRLd, kFQT, dob, width, min(kFQT, lq), hd, a.vec);
  fill_transposed(skt, a.k + (static_cast<size_t>(b) * lk + k0) * ld.k + head_off, ld.k,
                  k_rows, hd, a.vec);
  fill_transposed(svt, a.v + (static_cast<size_t>(b) * lk + k0) * ld.v + head_off, ld.v,
                  k_rows, hd, a.vec);
  StatRow next;
  if (tid < 4 * kFQT) {
    stats_load(next, a, ob, dob, lse_b, 0, min(kFQT, lq), width);
    stats_finish(next, s_lse[0], s_di[0]);
  }

  float adk[4][4], adv[4][4];  // keys key0 + c, dimensions dim0 + e
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[c][e] = adv[c][e] = 0.f;
  }
  for (int t = 0; t < nqt; ++t) {
    const int buf = t & 1, q0 = t * kFQT, rows = min(kFQT, lq - q0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // tile t and its statistics are in shared memory; every thread is done
    // with tile t - 1, whose buffers the next loads take
    __syncthreads();
    if (t > 0 && tid == 0) {  // every thread's dS of tile t - 1 is out
      __threadfence();
      atomicAdd(done + t - 1, 1);
    }
    const bool more = t + 1 < nqt;
    if (more) {
      const int nq0 = q0 + kFQT, nrows = min(kFQT, lq - nq0);
      load_f32<kFBThreads>(sq[buf ^ 1], kRLd, kFQT, qb + nq0 * ld.q, ld.q, nrows, hd, a.vec,
                           false);
      load_f32<kFBThreads>(sdo[buf ^ 1], kRLd, kFQT, dob + nq0 * width, width, nrows, hd, a.vec);
      if (tid < 4 * kFQT) stats_load(next, a, ob, dob, lse_b, nq0, nrows, width);
    }
    // S = Q K^T and dP = dO V^T for this thread's queries and keys; P, dS
    float s[kQPT][4], dp[kQPT][4];
    // rows past Lq, and keys none attended, are left out of the products
    const bool live = half && row0 < rows;
    if (!half) {
#pragma unroll
      for (int r = 0; r < kQPT; ++r) {
        const int row = row0 + 4 * r;
        if (row < rows) {
          *reinterpret_cast<float4*>(dsb + (q0 + row) * kFBK + key0) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < kQPT; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      }
      const float* qrow = sq[buf] + row0 * kRLd;
      const float* grow = sdo[buf] + row0 * kRLd;
#pragma unroll 2
      for (int d = 0; d < kHD; d += 4) {
        float4 kv[4], qv[kQPT];
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[e] = ld4(skt + (d + e) * kTLd + key0);
#pragma unroll
        for (int r = 0; r < kQPT; ++r) qv[r] = ld4(qrow + 4 * r * kRLd + d);
#pragma unroll
        for (int r = 0; r < kQPT; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = lane_of(qv[r], e);
            s[r][0] = fmaf(x, kv[e].x, s[r][0]);
            s[r][1] = fmaf(x, kv[e].y, s[r][1]);
            s[r][2] = fmaf(x, kv[e].z, s[r][2]);
            s[r][3] = fmaf(x, kv[e].w, s[r][3]);
          }
        }
      }
#pragma unroll 2
      for (int d = 0; d < kHD; d += 4) {
        float4 vv[4], gv[kQPT];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = ld4(svt + (d + e) * kTLd + key0);
#pragma unroll
        for (int r = 0; r < kQPT; ++r) gv[r] = ld4(grow + 4 * r * kRLd + d);
#pragma unroll
        for (int r = 0; r < kQPT; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = lane_of(gv[r], e);
            dp[r][0] = fmaf(x, vv[e].x, dp[r][0]);
            dp[r][1] = fmaf(x, vv[e].y, dp[r][1]);
            dp[r][2] = fmaf(x, vv[e].z, dp[r][2]);
            dp[r][3] = fmaf(x, vv[e].w, dp[r][3]);
          }
        }
      }
      // P = exp2(s scale log2(e) - lse log2(e)) on attended keys; dS = (dP -
      // di) P scale; both to shared memory, dS of the rows before Lq also to
      // a.ds
#pragma unroll
      for (int r = 0; r < kQPT; ++r) {
        const int row = row0 + 4 * r;
        const float lse = s_lse[buf][row], di = s_di[buf][row];
        float p[4], g[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = keep[c] ? exp2f(s[r][c] * a.scale_log2 - lse) : 0.f;
          g[c] = (dp[r][c] - di) * p[c] * a.scale;
        }
        const float4 p4 = make_float4(p[0], p[1], p[2], p[3]);
        const float4 g4 = make_float4(g[0], g[1], g[2], g[3]);
        *reinterpret_cast<float4*>(sp + row * kFBK + key0) = p4;
        *reinterpret_cast<float4*>(sds + row * kFBK + key0) = g4;
        if (row < rows) *reinterpret_cast<float4*>(dsb + (q0 + row) * kFBK + key0) = g4;
      }
    }
    if (more && tid < 4 * kFQT) stats_finish(next, s_lse[buf ^ 1], s_di[buf ^ 1]);
    __syncthreads();  // P and dS of the tile are in shared memory
    // dV += P^T dO, dK += dS^T Q over the tile's queries in order
#pragma unroll 4
    for (int i = 0; i < (half ? rows : 0); ++i) {
      const float4 pv = ld4(sp + i * kFBK + key0), gv = ld4(sdo[buf] + i * kRLd + dim0);
      const float4 sv = ld4(sds + i * kFBK + key0), qv = ld4(sq[buf] + i * kRLd + dim0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pc = lane_of(pv, c), sc = lane_of(sv, c);
        adv[c][0] = fmaf(pc, gv.x, adv[c][0]);
        adv[c][1] = fmaf(pc, gv.y, adv[c][1]);
        adv[c][2] = fmaf(pc, gv.z, adv[c][2]);
        adv[c][3] = fmaf(pc, gv.w, adv[c][3]);
        adk[c][0] = fmaf(sc, qv.x, adk[c][0]);
        adk[c][1] = fmaf(sc, qv.y, adk[c][1]);
        adk[c][2] = fmaf(sc, qv.z, adk[c][2]);
        adk[c][3] = fmaf(sc, qv.w, adk[c][3]);
      }
    }
  }
  __syncthreads();  // the last tile's dS is out
  if (tid == 0) {
    __threadfence();
    atomicAdd(done + nqt - 1, 1);
  }
  const int d = dim0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = key0 + c;
    if (key >= k_rows || d >= hd) continue;
    float* pk = dkb + key * ld.dk + d;
    float* pv = dvb + key * ld.dv + d;
    if (a.vec) {
      *reinterpret_cast<float4*>(pk) = make_float4(adk[c][0], adk[c][1], adk[c][2], adk[c][3]);
      *reinterpret_cast<float4*>(pv) = make_float4(adv[c][0], adv[c][1], adv[c][2], adv[c][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d + e < hd) {
          pk[e] = adk[c][e];
          pv[e] = adv[c][e];
        }
      }
    }
  }
}

// dq of queries q0 = qd kFDq .. + kFDq - 1 of one (item, head): dS K over the
// key tiles in order up to the last attended key, tiles with no attended key
// (no dS) skipped; the dS tiles (rows 68 floats apart) and K stream through
// shared memory in kFDqStages stages. Warp w covers dimensions 32 (w & 1)
// .. +31, lane l dimensions 32 (w & 1) + 4 (l & 7) .. +3 of queries
// (w >> 1) 16 + l >> 3 + 4r, summed over each tile's keys in order. It
// first waits until every key tile counted the dS of the last
// query tile of kFQT (the dK/dV work's) that holds its queries: each key tile
// counts its query tiles in order.
__device__ void bwd_f32_dq(const BwdF32Args& a, const Pitch& ld, int bh, int qd,
                           float* smem) {
  constexpr int kQPT = kFDq / 16, kStage = kFDq * kRLd + kFBK * kHD;
  __shared__ int s_end[kFBThreads / 32];
  const int b = bh / a.heads, h = bh % a.heads, q0 = qd * kFDq, lq = a.lq, lk = a.lk, hd = a.hd;
  const int nkt = (lk + kFBK - 1) / kFBK, nqt = (lq + kFQT - 1) / kFQT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dim0 = 32 * (warp & 1) + 4 * (lane & 7);       // this thread's 4 dimensions
  const int row0 = (warp >> 1) * 4 * kQPT + (lane >> 3);   // its queries row0 + 4r
  const size_t head_off = static_cast<size_t>(h) * hd;
  const int q_rows = min(kFDq, lq - q0);
  const float* kb = a.k + static_cast<size_t>(b) * lk * ld.k + head_off;
  const float* dsb = a.ds + static_cast<size_t>(bh) * nkt * lq * kFBK;
  const unsigned char* mb = a.mask == nullptr ? nullptr : a.mask + static_cast<size_t>(b) * lk;
  float* dqb = a.dq + (static_cast<size_t>(b) * lq + q0) * ld.dq + head_off;

  int end = 0;  // one past the last attended key
  for (int j = tid; j < lk; j += kFBThreads) {
    if (mb == nullptr || !mb[j]) end = j + 1;
  }
  end = static_cast<int>(__reduce_max_sync(0xFFFFFFFFu, static_cast<unsigned>(end)));
  if (lane == 0) s_end[warp] = end;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kFBThreads / 32; ++w) end = max(end, s_end[w]);
  const int tiles = (end + kFBK - 1) / kFBK;
  if (tiles == 0) {  // no key attended: zero rows
    for (int i = tid; i < q_rows * hd; i += kFBThreads) dqb[(i / hd) * ld.dq + i % hd] = 0.f;
    return;
  }
  wait_for(a.sync + 1 + static_cast<size_t>(bh) * nqt + min(nqt - 1, (q0 + q_rows - 1) / kFQT),
           nkt);
  const auto fetch = [&](int kt, int stage) {  // the dS tile (rows before Lq) and K tile kt
    float* s = smem + stage * kStage;
    load_f32<kFBThreads>(s, kRLd, kFDq, dsb + (static_cast<size_t>(kt) * lq + q0) * kFBK, kFBK,
                         q_rows, kFBK, true, false);
    load_f32<kFBThreads>(s + kFDq * kRLd, kHD, kFBK, kb + kt * kFBK * ld.k, ld.k,
                         min(kFBK, lk - kt * kFBK), hd, a.vec);
  };
  for (int kt = 0; kt < kFDqStages - 1 && kt < tiles; ++kt) fetch(kt, kt);
  float adq[kQPT][4];
#pragma unroll
  for (int r = 0; r < kQPT; ++r) adq[r][0] = adq[r][1] = adq[r][2] = adq[r][3] = 0.f;
  const bool live = row0 < q_rows;
  for (int kt = 0; kt < tiles; ++kt) {
    const int stage = kt % kFDqStages, j = kt * kFBK + tid;
    if (kt + 1 < tiles) {  // one copy group a tile: all but the next one's done
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kFDqStages - 2) : "memory");
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    // tile kt is in shared memory; every thread is done with tile kt - 1,
    // whose stage the next copy takes
    const bool any =
        __syncthreads_or(tid < kFBK && j < lk && (mb == nullptr || !mb[j]));
    if (kt + kFDqStages - 1 < tiles) fetch(kt + kFDqStages - 1, (kt + kFDqStages - 1) % kFDqStages);
    if (!any || !live) continue;
    const float* sd = smem + stage * kStage + row0 * kRLd;
    const float* sk = smem + stage * kStage + kFDq * kRLd + dim0;
    // the keys up to the last attended one, in steps of 4 (the rest have dS 0)
    const int keys = min(kFBK, (end - kt * kFBK + 3) & ~3);
#pragma unroll 2
    for (int jj = 0; jj < keys; jj += 4) {
      float4 kv[4], dv[kQPT];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = ld4(sk + (jj + e) * kHD);
#pragma unroll
      for (int r = 0; r < kQPT; ++r) dv[r] = ld4(sd + 4 * r * kRLd + jj);
#pragma unroll
      for (int r = 0; r < kQPT; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = lane_of(dv[r], e);
          adq[r][0] = fmaf(x, kv[e].x, adq[r][0]);
          adq[r][1] = fmaf(x, kv[e].y, adq[r][1]);
          adq[r][2] = fmaf(x, kv[e].z, adq[r][2]);
          adq[r][3] = fmaf(x, kv[e].w, adq[r][3]);
        }
      }
    }
  }
  const int d = dim0;
#pragma unroll
  for (int r = 0; r < kQPT; ++r) {
    const int row = row0 + 4 * r;
    if (row >= q_rows || d >= hd) continue;
    float* pq = dqb + row * ld.dq + d;
    if (a.vec) {
      *reinterpret_cast<float4*>(pq) = make_float4(adq[r][0], adq[r][1], adq[r][2], adq[r][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d + e < hd) pq[e] = adq[r][e];
      }
    }
  }
}

// the whole f32 backward in one launch: each block draws a ticket, every
// key tile's dK/dV first, then every block of kFDq queries' dQ (which waits
// for its dS from every key tile; a dQ block waits only on dK/dV work of a
// lower ticket, drawn by a block that had started, so every wait ends)
__global__ void __launch_bounds__(kFBThreads, 2)
    attention_bwd_f32_kernel(const BwdF32Args a, const Pitch ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkt = (a.lk + kFBK - 1) / kFBK, nqd = (a.lq + kFDq - 1) / kFDq;
  const int n_kv = a.b * a.heads * nkt;
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(a.sync, 1);
  __syncthreads();
  const int work = s_ticket;
  float* fsmem = reinterpret_cast<float*>(smem);
  if (work < n_kv) {
    bwd_f32_dkv(a, ld, work / nkt, work % nkt, fsmem);
  } else {
    bwd_f32_dq(a, ld, (work - n_kv) / nqd, (work - n_kv) % nqd, fsmem);
  }
}

// the backward's scratch. bf16: di (B, heads, Lq) f32 from byte 0, then
// the counters (BwdArgs::sync) and the dS^T tiles (B, heads, query tiles,
// key tiles). f32: the counters (BwdF32Args::sync, as many as 32 queries a
// tile take), then the dS tiles (B * heads, key tiles of 64, Lq, 64)
struct BwdScratch {
  size_t sync, n_sync, ds, bytes;
};

BwdScratch bwd_scratch(int b, int lq, int lk, int heads, int elem_bytes) {
  const auto up = [](size_t x) { return (x + 127) / 128 * 128; };
  const size_t bh = static_cast<size_t>(b) * heads;
  BwdScratch s{};
  if (elem_bytes != 2) {
    s.n_sync = 1 + bh * ((lq + 31) / 32);
    s.ds = up(s.n_sync * sizeof(int));
    s.bytes = s.ds + bh * ((lk + kFBK - 1) / kFBK) * lq * kFBK * sizeof(float);
    return s;
  }
  const size_t nqt = (lq + kBQ - 1) / kBQ;
  s.sync = up(bh * lq * sizeof(float));
  s.n_sync = 1 + bh + bh * nqt;
  s.ds = up(s.sync + s.n_sync * sizeof(int));
  s.bytes = s.ds + bh * nqt * ((lk + kBK - 1) / kBK) * kTile * sizeof(bf16);
  return s;
}

// lets a kernel take `bytes` of dynamic shared memory, once a device, kernel
// and process: the call is not free, and every backward launches one
cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex lock;
  static std::set<std::pair<int, const void*>> done;
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  const std::lock_guard<std::mutex> hold(lock);
  if (done.count({device, kernel}) != 0) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.insert({device, kernel});
  return e;
}

// the f32 backward: a memset of the counters, then one launch
cudaError_t launch_bwd_f32(BwdF32Args a, const Pitch& ld, const BwdScratch& at,
                           unsigned char* base, cudaStream_t st) {
  const long long nkt = (a.lk + kFBK - 1) / kFBK, nqt = (a.lq + kFQT - 1) / kFQT;
  const long long nqd = (a.lq + kFDq - 1) / kFDq;
  const long long n_kv = static_cast<long long>(a.b) * a.heads * nkt;
  const long long n_q = static_cast<long long>(a.b) * a.heads * nqd;
  if (n_kv + n_q > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  constexpr int smem = f32_bwd_smem();
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(attention_bwd_f32_kernel), smem);
  if (e != cudaSuccess) return e;
  a.ds = reinterpret_cast<float*>(base + at.ds);
  a.sync = reinterpret_cast<int*>(base + at.sync);
  e = cudaMemsetAsync(a.sync, 0, (1 + static_cast<size_t>(a.b) * a.heads * nqt) * sizeof(int), st);
  if (e != cudaSuccess) return e;
  attention_bwd_f32_kernel<<<static_cast<unsigned>(n_kv + n_q), kFBThreads, smem, st>>>(a, ld);
  return cudaGetLastError();
}

bool valid_shape(int b, int lq, int lk, int heads, int hd, int elem_bytes) {
  return b > 0 && b <= 65535 && heads > 0 && heads <= 65535 && lq > 0 && lk > 0 && hd > 0 &&
         hd <= kHD && (elem_bytes == 4 || elem_bytes == 2);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q (B, Lq, heads*hd), k, v (B, Lk, heads*hd), rows q_ld, k_ld, v_ld elements
// apart (Pitch; each at least heads*hd), mask (B, Lk) bytes or null, out
// (B, Lq, heads*hd) contiguous; elem_bytes 4 = f32, 2 = bf16; lse (B, heads,
// Lq) f32 or null; config: 0 for the default launch, or for f32 the queries a
// block (8, 16 or 32)
extern "C" int amt_attention_config(const void* q, const void* k, const void* v,
                                    const unsigned char* mask, int b, int lq, int lk, int heads,
                                    int hd, float scale, int elem_bytes, void* out, float* lse,
                                    long long q_ld, long long k_ld, long long v_ld, int config,
                                    void* stream) {
  const long long width = static_cast<long long>(heads) * hd;
  if (!valid_shape(b, lq, lk, heads, hd, elem_bytes) || q_ld < width || k_ld < width ||
      v_ld < width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pitch ld{static_cast<size_t>(q_ld), static_cast<size_t>(k_ld), static_cast<size_t>(v_ld),
                 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    if (config != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(q, k, v, mask, b, lq, lk, heads, hd, scale, out, lse, ld, st);
  }
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(out);
  switch (config == 0 ? kF32Rows : config) {
    case 8: return launch_f32<8>(qq, kk, vv, mask, b, lq, lk, heads, hd, scale, oo, lse, ld, st);
    case 16:
      return launch_f32<16>(qq, kk, vv, mask, b, lq, lk, heads, hd, scale, oo, lse, ld, st);
    case 32:
      return launch_f32<32>(qq, kk, vv, mask, b, lq, lk, heads, hd, scale, oo, lse, ld, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int amt_attention(const void* q, const void* k, const void* v,
                             const unsigned char* mask, int b, int lq, int lk, int heads, int hd,
                             float scale, int elem_bytes, void* out, float* lse, long long q_ld,
                             long long k_ld, long long v_ld, void* stream) {
  return amt_attention_config(q, k, v, mask, b, lq, lk, heads, hd, scale, elem_bytes, out, lse,
                              q_ld, k_ld, v_ld, 0, stream);
}

// bytes of scratch amt_attention_bwd needs
extern "C" long long amt_attention_bwd_scratch(int b, int lq, int lk, int heads, int elem_bytes) {
  return static_cast<long long>(bwd_scratch(b, lq, lk, heads, elem_bytes).bytes);
}

// The backward of amt_attention: q, o, dout, dq (B, Lq, heads*hd), k, v, dk,
// dv (B, Lk, heads*hd), lse (B, heads, Lq) f32 from the forward, mask (B, Lk)
// bytes or null, scratch of amt_attention_bwd_scratch bytes (16-byte
// aligned); ld: the six row pitches of q, k, v, dq, dk, dv in elements (each
// at least heads*hd; o and dout contiguous). A memset of the counters and one
// kernel, bf16 or f32.
extern "C" int amt_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, const unsigned char* mask,
                                 int b, int lq, int lk, int heads, int hd, float scale,
                                 int elem_bytes, void* scratch, void* dq, void* dk, void* dv,
                                 const long long* ld_in, void* stream) {
  if (!valid_shape(b, lq, lk, heads, hd, elem_bytes) || !aligned16(scratch) ||
      ld_in == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = static_cast<long long>(heads) * hd;
  for (int i = 0; i < 6; ++i) {
    if (ld_in[i] < width) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pitch ld{static_cast<size_t>(ld_in[0]), static_cast<size_t>(ld_in[1]),
                 static_cast<size_t>(ld_in[2]), static_cast<size_t>(ld_in[3]),
                 static_cast<size_t>(ld_in[4]), static_cast<size_t>(ld_in[5])};
  const auto pitches_of = [&](size_t m) {
    return ld.q % m == 0 && ld.k % m == 0 && ld.v % m == 0 && ld.dq % m == 0 &&
           ld.dk % m == 0 && ld.dv % m == 0;
  };
  auto st = static_cast<cudaStream_t>(stream);
  const BwdScratch at = bwd_scratch(b, lq, lk, heads, elem_bytes);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  if (elem_bytes == 2) {
    const long long nkt = (lk + kBK - 1) / kBK, nqt = (lq + kBQ - 1) / kBQ;
    const long long blocks = static_cast<long long>(b) * heads * (2 * nqt + nkt);
    if (hd % 8 != 0 || blocks > 0x7FFFFFFFLL || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(o) || !aligned16(dout) || !aligned16(dq) ||
        !aligned16(dk) || !aligned16(dv) || !pitches_of(8)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const BwdArgs args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                       static_cast<const bf16*>(dout), lse, mask, b, lq, lk, heads, hd,
                       scale * kLog2e, scale, static_cast<float*>(scratch),
                       reinterpret_cast<bf16*>(base + at.ds),
                       reinterpret_cast<int*>(base + at.sync), static_cast<bf16*>(dq),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), ld};
    cudaError_t e = cudaMemsetAsync(args.sync, 0, at.n_sync * sizeof(int), st);
    if (e == cudaSuccess) {
      e = allow_smem(reinterpret_cast<const void*>(attention_bwd_bf16_kernel), kBwdSmem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    attention_bwd_bf16_kernel<<<static_cast<unsigned>(blocks), kTC, kBwdSmem, st>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
                   aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv) &&
                   pitches_of(4);
  const BwdF32Args args{static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o),
                        static_cast<const float*>(dout), lse, mask, b, lq, lk, heads, hd, scale,
                        scale * kLog2e, vec, nullptr, nullptr, static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv)};
  return static_cast<int>(launch_bwd_f32(args, ld, at, base, st));
}
