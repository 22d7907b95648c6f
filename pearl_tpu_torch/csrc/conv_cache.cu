// Diagonal scatter of a new frame's conv1 contributions into the conv1 cache,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel of pearl_tpu/ops/conv_cache.py (`_cache_write_tpu`,
// `_write_kernel`: T DMAs started together, then awaited): for every kernel
// position p = 0..T-1, in place,
//     cache[(cursor - p) mod T, p, b, :] <- y[b, p*D : (p+1)*D]
// where y is the contrib conv's NCHW output (B, T*OC, OH, OW) seen as B rows of
// T chunks of D = OC*OH*OW contiguous elements, and the cache is the
// contiguous row-major (T, P, B, D) array with P = T. The TPU kernel's
// (T, P, D, B) batch-minor order and its (OH*OW, OC, B) source view are
// XLA:TPU layout devices and are not carried over: in this order a chunk is B
// strided rows, the gather `cache[cursor]` is one contiguous slab, and the
// masked sum over it is conv2's NCHW input with no transpose.
//
// Bound on an H100: bytes. y read once, T slabs written once (at B = 1024,
// T = 4, D = 6400 bf16: 2 x 52.4 MB, 31.3 us at 3.35 TB/s). The design is
// row_copy.cuh's: one launch moves all T chunks (grid z is the position), in
// the widest word (16, 8, 4, 2 or 1 bytes) that divides the chunk length, the
// source's row stride and both base addresses, so an odd D or a sliced source
// moves in narrower words and never faults; grid (row, chunk of row, position),
// ROW_COPY_THREADS threads x ROW_COPY_UNROLL words, loads before stores.
//
// Sizes and strides arrive in bytes. The entry point returns
// cudaGetLastError() after its launch.

#include "row_copy.cuh"

template <typename W>
__global__ void __launch_bounds__(ROW_COPY_THREADS)
cache_write_kernel(W* __restrict__ cache, const W* __restrict__ y, long long y_stride,
                   long long B, int T, int cursor, int words) {
  const long long row = blockIdx.x;
  const int p = blockIdx.z;
  const int j = (cursor - p + T) % T;
  const W* src = y + row * y_stride + (long long)p * words;
  W* dst = cache + (((long long)j * T + p) * B + row) * words;
  const int base = blockIdx.y * (ROW_COPY_THREADS * ROW_COPY_UNROLL) + threadIdx.x;
  W v[ROW_COPY_UNROLL];
#pragma unroll
  for (int k = 0; k < ROW_COPY_UNROLL; ++k) {
    const int i = base + k * ROW_COPY_THREADS;
    if (i < words) v[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < ROW_COPY_UNROLL; ++k) {
    const int i = base + k * ROW_COPY_THREADS;
    if (i < words) dst[i] = v[k];
  }
}

template <typename W>
static int cache_write_launch_as(void* cache, const void* y, long long y_stride, long long B,
                                 long long T, long long chunk_bytes, long long cursor,
                                 cudaStream_t stream) {
  const long long w = (long long)sizeof(W);
  const long long words = chunk_bytes / w;
  const long long per_block = ROW_COPY_THREADS * ROW_COPY_UNROLL;
  const long long chunks = (words + per_block - 1) / per_block;
  if (B > 2147483647LL || chunks > 65535LL || T > 65535LL || words > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)B, (unsigned)chunks, (unsigned)T);
  cache_write_kernel<W><<<grid, ROW_COPY_THREADS, 0, stream>>>(
      static_cast<W*>(cache), static_cast<const W*>(y), y_stride / w, B, (int)T, (int)cursor,
      (int)words);
  return (int)cudaGetLastError();
}

// cache (T, T, B, chunk_bytes) contiguous; y rows of T*chunk_bytes bytes with
// row stride y_stride.
extern "C" int cache_write(void* cache, const void* y, long long y_stride, long long B,
                           long long T, long long chunk_bytes, long long cursor, void* stream) {
  if (cache == nullptr || y == nullptr || B < 0 || T < 1 || chunk_bytes < 0 || cursor < 0 ||
      cursor >= T) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || chunk_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CACHE_WRITE_TRY(W)                                                                  \
  if (chunk_bytes % (long long)sizeof(W) == 0 && row_copy_fits(sizeof(W), cache, 0) &&      \
      row_copy_fits(sizeof(W), y, y_stride)) {                                              \
    return cache_write_launch_as<W>(cache, y, y_stride, B, T, chunk_bytes, cursor, s);      \
  }
  CACHE_WRITE_TRY(uint4)
  CACHE_WRITE_TRY(uint2)
  CACHE_WRITE_TRY(uint32_t)
  CACHE_WRITE_TRY(uint16_t)
#undef CACHE_WRITE_TRY
  return cache_write_launch_as<unsigned char>(cache, y, y_stride, B, T, chunk_bytes, cursor, s);
}
