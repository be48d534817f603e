// Neighbourhood row gather: out[b, m, k, :] = x[b, idx[b, m, k], :].
//
// Replaces the forward of afford_motion_tpu/ops/pallas/gather.py
// (`gather_rows` -> `_gather_fwd_impl` -> `_gather_kernel`). The TPU kernel
// gathers bf16 through f32; here rows are copied as raw 2- or 4-byte words,
// so the result is bit-exact for f32 and bf16 alike.
//
// What bounds it on the H100: bytes, almost all of them output writes (the
// output is K times the gathered rows; a cloud's source rows, at most
// 8192 x 515 x 4 B, stay in L2). The first design, a warp an output row,
// loaded the row's index and only then the row (two dependent latencies a
// row), copied 70-1,030 bytes in 2- or 4-byte lanes with lanes idle (3 of
// 32 busy in the second step of a 35-channel bf16 row) and retired: too
// little in flight, in ~124 short waves at the path's largest call. Here:
//   - the output, (B * M * K) rows of C words, is one contiguous span; a
//     warp owns `span` consecutive output rows at a time (a multiple of 8,
//     so the span's byte start keeps the output's 16-byte alignment), and
//     the warps of a grid of resident blocks walk the spans;
//   - the span's indices (one a lane, or span / 32 a lane) are loaded in one
//     coalesced read while the warp copies the previous span, and the warp
//     turns them into source offsets in its own slice of shared memory;
//   - the span is copied 16 bytes (4 f32 or 8 bf16 words) at a time, across
//     row boundaries, with one vector store each, neighbouring lanes on
//     neighbouring 16-byte chunks; a lane issues the source loads of 1, 2 or
//     4 chunks (`mode` 0, 1, 2) before their stores;
//   - a chunk's words come from at most two source rows when C >= 8. Rows
//     of odd C are only 2- or 4-byte aligned: a chunk is read word by word,
//     stepping to the next row where a row ends, or (`wide`), where it lies
//     inside one row, as the one or two aligned 16-byte words that hold it,
//     shifted into place (those words hold bytes of x only: an allocation
//     is 16-byte aligned at both ends);
//   - words before the span's first 16-byte boundary (an output that is not
//     16-byte aligned) and after its last (a total length that is not a
//     multiple of 16 bytes) are copied one word a lane.
// Source rows are read at their words' alignment, so an `x` at any offset
// is taken.
//
// Indices are not range-checked here (nor on the TPU); they come from the
// kNN of the same cloud.
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpan = 128;   // output rows a warp's span
constexpr int kBlocksPerSm = 8;

// 16 bytes of N words as one 16-byte value
template <typename T>
__device__ __forceinline__ uint4 pack(const T (&v)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ uint4 pack<uint16_t>(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | (static_cast<unsigned>(v[1]) << 16),
                    v[2] | (static_cast<unsigned>(v[3]) << 16),
                    v[4] | (static_cast<unsigned>(v[5]) << 16),
                    v[6] | (static_cast<unsigned>(v[7]) << 16));
}
template <>
__device__ __forceinline__ uint4 pack<uint32_t>(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// the 16 bytes at p (aligned to its words only) from the one or two aligned
// 16-byte words that hold them: the 5 words from the first that holds one
// of them, then a 16-bit funnel shift where p is not 4-byte aligned
__device__ __forceinline__ uint4 load_unaligned(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* q = reinterpret_cast<const uint4*>(a & ~static_cast<uintptr_t>(15));
  const unsigned o = static_cast<unsigned>(a & 15);
  const uint4 lo = q[0];
  const uint4 hi = o != 0 ? q[1] : lo;
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned j = o >> 2;
  unsigned win[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const unsigned a0 = w[t], a1 = w[t + 1 < 8 ? t + 1 : 7], a2 = w[t + 2 < 8 ? t + 2 : 7],
                   a3 = w[t + 3 < 8 ? t + 3 : 7];
    win[t] = j == 0 ? a0 : j == 1 ? a1 : j == 2 ? a2 : a3;
  }
  unsigned out[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) out[t] = (o & 2) ? __funnelshift_r(win[t], win[t + 1], 16) : win[t];
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// a lane's place in its span: the row and word of its next chunk's first
// word, advanced by `dq` rows and `dr` words from one of its chunks to the
// next (32 chunks on)
struct Place {
  int row, ch;
  __device__ __forceinline__ void advance(int dq, int dr, int c) {
    row += dq;
    ch += dr;
    if (ch >= c) {
      ch -= c;
      ++row;
    }
  }
};

// chunks `chunk`, `chunk + 32`, ... (U of them, those below `chunks`) of a
// span, the first at `at`: word w of span row r is word w of the source row
// at offset off[r]. A chunk inside one source row is read by load_unaligned
// where kWide, else word by word, stepping to the next row's offset where a
// row ends. All of the U chunks' loads are issued before their stores.
template <typename T, int U, bool kWide>
__device__ __forceinline__ void copy_chunks(const T* __restrict__ x, const long long* off, int c,
                                            int head, int chunk, int chunks, Place& at, int dq,
                                            int dr, T* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (chunk + 32 * u < chunks) {
      int row = at.row, ch = at.ch;
      const T* src = x + off[row] + ch;
      if (kWide && ch + kVec <= c) {
        v[u] = load_unaligned(src);
      } else {
        T w[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          w[j] = *src;
          if (j + 1 < kVec) {
            ++src;
            if (++ch == c) {
              ch = 0;
              src = x + off[++row];
            }
          }
        }
        v[u] = pack<T>(w);
      }
    }
    at.advance(dq, dr, c);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ci = chunk + 32 * u;
    if (ci < chunks) *reinterpret_cast<uint4*>(dst + head + ci * kVec) = v[u];
  }
}

// grid of resident blocks; warp w of the grid copies spans w, w + warps, ...
// of `span` output rows each (rows = B * M * K in all, rows_per_batch = M * K
// of them a cloud), U chunks a lane at a time
template <typename T, int U, bool kWide>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ idx, int n, int c,
                   long long rows_per_batch, long long rows, int span, T* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ long long s_off[kWarps][kMaxSpan];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long* off = s_off[warp];
  const long long spans = (rows + span - 1) / span;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const bool narrow = rows <= 0x7fffffffLL;
  const int dq = 32 * kVec / c, dr = 32 * kVec % c;   // 32 chunks on: rows and words

  int next[kMaxSpan / 32];
  auto load = [&](long long s) {
#pragma unroll
    for (int j = 0; j < kMaxSpan / 32; ++j) {
      const long long row = s * span + j * 32 + lane;
      next[j] = j * 32 + lane < span && s < spans && row < rows ? idx[row] : 0;
    }
  };
  long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  load(s);
  for (; s < spans; s += step) {
    const long long row0 = s * span;
#pragma unroll
    for (int j = 0; j < kMaxSpan / 32; ++j) {
      const long long row = row0 + j * 32 + lane;
      if (j * 32 + lane < span && row < rows) {
        const long long b = narrow ? static_cast<long long>(static_cast<unsigned>(row) /
                                                            static_cast<unsigned>(rows_per_batch))
                                   : row / rows_per_batch;
        off[j * 32 + lane] = (b * n + next[j]) * c;
      }
    }
    __syncwarp();
    load(s + step);   // the next span's indices, in flight during the copy
    const int elems = static_cast<int>(min(static_cast<long long>(span), rows - row0)) * c;
    T* dst = out + row0 * c;
    // words before the first 16-byte boundary of the span, 16-byte chunks,
    // words after the last
    const int head = min(elems, static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(T)));
    const int chunks = (elems - head) / kVec;
    for (int e = lane; e < head; e += 32) dst[e] = x[off[e / c] + e % c];
    for (int e = head + chunks * kVec + lane; e < elems; e += 32) {
      dst[e] = x[off[e / c] + e % c];
    }
    Place at;
    at.row = (head + lane * kVec) / c;
    at.ch = head + lane * kVec - at.row * c;
    for (int ci = lane; ci < chunks; ci += 32 * U) {
      copy_chunks<T, U, kWide>(x, off, c, head, ci, chunks, at, dq, dr, dst);
    }
    __syncwarp();
  }
}

template <typename T, int U, bool kWide>
cudaError_t launch(const void* x, const int* idx, int b, int n, int c, int m, int k, int span,
                   void* out, cudaStream_t stream) {
  const long long rows_per_batch = static_cast<long long>(m) * k;
  const long long rows = rows_per_batch * b;
  const long long spans = (rows + span - 1) / span;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long blocks = std::min((spans + kWarps - 1) / kWarps,
                                    static_cast<long long>(sms) * kBlocksPerSm);
  gather_rows_kernel<T, U, kWide><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), idx, n, c, rows_per_batch, rows, span, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, bool kWide>
cudaError_t launch_mode(const void* x, const int* idx, int b, int n, int c, int m, int k,
                        int mode, int span, void* out, cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch<T, 1, kWide>(x, idx, b, n, c, m, k, span, out, stream);
    case 1:
      return launch<T, 2, kWide>(x, idx, b, n, c, m, k, span, out, stream);
    default:
      return launch<T, 4, kWide>(x, idx, b, n, c, m, k, span, out, stream);
  }
}

}  // namespace

// x (b, n, c) and out (b, m, k, c) in float32 (elem_bytes 4) or bfloat16
// (2), each at any offset that keeps its words aligned; idx (b, m, k) int32
// in [0, n). mode 0, 1, 2: 1, 2 or 4 chunks a lane at a time; wide: a chunk
// inside one source row read as aligned 16-byte words (1) or word by word
// (0); span: output rows a warp at a time, 8, 16, 32, 64 or 128 (span * c
// below 2^31).
extern "C" int amt_gather_rows(const void* x, const int* idx, int b, int n, int c, int m, int k,
                               int elem_bytes, int mode, int wide, int span, void* out,
                               void* stream) {
  if (b <= 0 || n <= 0 || c <= 0 || m <= 0 || k <= 0 || mode < 0 || mode > 2 ||
      (span != 8 && span != 16 && span != 32 && span != 64 && span != kMaxSpan) ||
      static_cast<long long>(span) * c > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % elem_bytes != 0 ||
      reinterpret_cast<uintptr_t>(x) % elem_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (elem_bytes == 4) {
    e = wide ? launch_mode<uint32_t, true>(x, idx, b, n, c, m, k, mode, span, out, st)
             : launch_mode<uint32_t, false>(x, idx, b, n, c, m, k, mode, span, out, st);
  } else if (elem_bytes == 2) {
    e = wide ? launch_mode<uint16_t, true>(x, idx, b, n, c, m, k, mode, span, out, st)
             : launch_mode<uint16_t, false>(x, idx, b, n, c, m, k, mode, span, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

extern "C" const char* amt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
