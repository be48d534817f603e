// Windowed (banded) neighbourhood gather:
//   out[b, m, k, :] = x[b, idx[b, m, k], :]  if start <= idx[b, m, k] < start + S
//                   = 0                      otherwise,
// with start the window start of query row m's tile of 128 rows, read per
// tile from starts (G,) (stride 0 between clouds) or per cloud and tile from
// starts (B, G) (stride G).
//
// Replaces afford_motion_tpu/ops/pallas/banded.py (`gather_banded` ->
// `_gather_banded_impl` -> `_gather_kernel`). The TPU kernel multiplies a
// one-hot matrix over the window with the window's rows on its matrix unit,
// because a row copy costs it a scalar operation per row; a row whose
// index misses the window has no hit in the one-hot and comes out zero. A
// GPU copies rows at memory speed, so no one-hot is built and no product is
// computed here: the rows are copied as raw 2- or 4-byte words, bit-exact for
// f32 and bf16 (for finite x the one-hot product is exact too), and the
// window test supplies the zero rows.
//
// What bounds it on the H100: bytes, almost all of them output writes (the
// output is K times the gathered rows). A warp a row (the first design) wrote
// short rows of 70-1,030 bytes in 2-byte words with idle lanes and little in
// flight. Here:
//   - a block takes a tile of 128 query rows, or a part of one; the tile's
//     window of S source rows is one contiguous span of x[b], and the
//     block's output one contiguous span of out;
//   - the window comes into shared memory in one bulk copy
//     (`cp.async.bulk` completing on an mbarrier), while the threads turn the
//     block's indices into window rows;
//   - every thread assembles 16 bytes of the output span at a time from the
//     window (a chunk may cross rows: C is rarely a multiple of 8) and writes
//     them with one vector store, neighbouring threads on neighbouring
//     chunks;
//   - windows too large for shared memory (f32 at the wider levels) take the
//     second instance, which reads the window's rows from device memory (they
//     stay in L2) with the same assembly.
// Calls with few tiles split each tile's rows across blocks, so the card
// fills; each block copies the whole window.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kTileQueries = 128;  // TQ of the window policy

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
struct Chunk;  // 16 bytes of N words
template <>
struct Chunk<8> {
  static __device__ __forceinline__ void store(void* p, const uint16_t (&v)[8]) {
    uint4 w;
    w.x = v[0] | (static_cast<unsigned>(v[1]) << 16);
    w.y = v[2] | (static_cast<unsigned>(v[3]) << 16);
    w.z = v[4] | (static_cast<unsigned>(v[5]) << 16);
    w.w = v[6] | (static_cast<unsigned>(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = w;
  }
};
template <>
struct Chunk<4> {
  static __device__ __forceinline__ void store(void* p, const uint32_t (&v)[4]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// grid (parts, tiles, b): block (part, tile, b) writes query rows
// [tile * 128 + part * rows, + rows) of cloud b, rows = 128 / parts.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_banded_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                     const int* __restrict__ starts, int starts_stride, int n, int c, int m,
                     int k, int s, int rows, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  const int part = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int start = starts[b * starts_stride + tile];
  const int q0 = tile * kTileQueries + part * rows;
  const int out_rows = rows * k;
  int* rel = reinterpret_cast<int*>(smem);  // window row of each output row
  T* win = reinterpret_cast<T*>(smem + (static_cast<size_t>(out_rows) * 4 + 15) / 16 * 16);
  const T* src = x + (static_cast<size_t>(b) * n + start) * c;
  const unsigned bytes = static_cast<unsigned>(s) * c * sizeof(T);
  const bool bulk = kStaged && (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0;

  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(&bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(win)), "l"(src), "r"(bytes), "r"(smem_addr(&bar))
        : "memory");
  }
  const int* ip = idx + (static_cast<size_t>(b) * m + q0) * k;
  for (int i = threadIdx.x; i < out_rows; i += kThreads) rel[i] = ip[i] - start;
  if (kStaged && !bulk) {  // a window start or size that leaves the rows unaligned
    for (int i = threadIdx.x; i < s * c; i += kThreads) win[i] = src[i];
  }
  __syncthreads();
  if (bulk) {
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&bar)), "r"(0u)
          : "memory");
    }
  }
  const T* from = kStaged ? win : src;

  constexpr int kVec = 16 / sizeof(T);
  T* dst = out + (static_cast<size_t>(b) * m + q0) * k * c;
  const int chunks = out_rows * c / kVec;
  for (int chunk = threadIdx.x; chunk < chunks; chunk += kThreads) {
    const int e = chunk * kVec;
    int row = e / c;
    int ch = e - row * c;
    unsigned r = static_cast<unsigned>(rel[row]);
    T v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = r < static_cast<unsigned>(s) ? from[r * c + ch] : T(0);
      if (j + 1 < kVec && ++ch == c) {
        ch = 0;
        r = static_cast<unsigned>(rel[++row]);
      }
    }
    Chunk<kVec>::store(dst + e, v);
  }
}

template <typename T, bool kStaged>
cudaError_t launch(const void* x, const int* idx, const int* starts, int stride, int b, int n,
                   int c, int m, int k, int s, int parts, void* out, cudaStream_t stream) {
  const int rows = kTileQueries / parts;
  size_t smem = (static_cast<size_t>(rows) * k * 4 + 15) / 16 * 16;
  if (kStaged) smem += static_cast<size_t>(s) * c * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(gather_banded_kernel<T, kStaged>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(parts, m / kTileQueries, b);
  gather_banded_kernel<T, kStaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), idx, starts, stride, n, c, m, k, s, rows, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// x (b, n, c) and out (b, m, k, c) in float32 (elem_bytes 4) or bfloat16 (2),
// out 16-byte aligned; idx (b, m, k) int32; starts int32, (m / 128,) with
// starts_stride 0 or (b, m / 128) with starts_stride m / 128, each in
// [0, n - s]. parts: blocks a tile (1, 2, 4, 8 or 16); staged: the window in
// shared memory (1) or read from device memory (0).
extern "C" int amt_gather_banded(const void* x, const int* idx, const int* starts,
                                 int starts_stride, int b, int n, int c, int m, int k, int s,
                                 int elem_bytes, int parts, int staged, void* out, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || c <= 0 || m <= 0 || m % kTileQueries != 0 || k <= 0 ||
      s <= 0 || s > n || (starts_stride != 0 && starts_stride != m / kTileQueries) ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8 && parts != 16) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(kTileQueries) * k * c * elem_bytes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (elem_bytes == 4) {
    e = staged ? launch<uint32_t, true>(x, idx, starts, starts_stride, b, n, c, m, k, s, parts,
                                        out, st)
               : launch<uint32_t, false>(x, idx, starts, starts_stride, b, n, c, m, k, s, parts,
                                         out, st);
  } else if (elem_bytes == 2) {
    e = staged ? launch<uint16_t, true>(x, idx, starts, starts_stride, b, n, c, m, k, s, parts,
                                        out, st)
               : launch<uint16_t, false>(x, idx, starts, starts_stride, b, n, c, m, k, s, parts,
                                         out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
