// Strided row copy for Hopper (sm_90a), shared by ring_write.cu and
// layout_fence.cu: dst[r, :] <- src[r, :] for every row r, where dst and src
// are (rows, row_bytes) byte matrices with their own row strides, and src is
// picked per row between two sources when SELECT is set.
//
// The work is pure data movement, so the card's memory rate bounds it: every
// needed source byte read once, every destination byte written once. The
// design is therefore only about wide, coalesced accesses with enough of
// them in flight:
//   - the copy runs in the widest word W (16, 8, 4, 2 or 1 bytes) that
//     divides the row length, every row stride and every base address, so an
//     aligned row (7056 bf16 = 14112 B = 882 x 16) moves as 16-byte words and
//     a ragged one falls back to narrower words, never to a wrong access;
//   - grid = (rows, chunks of a row); a block of ROW_COPY_THREADS threads
//     takes ROW_COPY_UNROLL words per thread, neighbouring threads on
//     neighbouring words, all loads issued before the first store;
//   - the per-row select reads one byte per block and then only the picked
//     source row: the other source's row is never touched.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define ROW_COPY_THREADS 256
#define ROW_COPY_UNROLL 4

template <typename W, bool SELECT>
__global__ void __launch_bounds__(ROW_COPY_THREADS)
row_copy_kernel(W* __restrict__ dst, long long dst_stride, const W* __restrict__ a,
                long long a_stride, const W* __restrict__ b, long long b_stride,
                const unsigned char* __restrict__ pick_b, int words) {
  const long long row = blockIdx.x;
  const W* src = a + row * a_stride;
  if (SELECT) {
    if (pick_b[row]) src = b + row * b_stride;
  }
  W* out = dst + row * dst_stride;
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
    if (i < words) out[i] = v[k];
  }
}

// Strides and row_bytes are in bytes. `b` and `pick_b` are null when there is
// one source. Returns cudaGetLastError() after the launch.
template <typename W, bool SELECT>
static int row_copy_launch_as(void* dst, long long dst_stride, const void* a, long long a_stride,
                              const void* b, long long b_stride, const void* pick_b,
                              long long rows, long long row_bytes, cudaStream_t stream) {
  const long long w = (long long)sizeof(W);
  const long long words = row_bytes / w;
  const long long per_block = ROW_COPY_THREADS * ROW_COPY_UNROLL;
  const long long chunks = (words + per_block - 1) / per_block;
  if (rows > 2147483647LL || chunks > 65535LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)rows, (unsigned)chunks);
  row_copy_kernel<W, SELECT><<<grid, ROW_COPY_THREADS, 0, stream>>>(
      static_cast<W*>(dst), dst_stride / w, static_cast<const W*>(a), a_stride / w,
      static_cast<const W*>(b), b_stride / w, static_cast<const unsigned char*>(pick_b),
      (int)words);
  return (int)cudaGetLastError();
}

static inline bool row_copy_fits(long long w, const void* p, long long stride) {
  return p == nullptr || ((uintptr_t)p % (uintptr_t)w == 0 && stride % w == 0);
}

template <bool SELECT>
static int row_copy_launch(void* dst, long long dst_stride, const void* a, long long a_stride,
                           const void* b, long long b_stride, const void* pick_b, long long rows,
                           long long row_bytes, cudaStream_t stream) {
  if (rows < 0 || row_bytes < 0 || dst == nullptr || a == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (SELECT && (b == nullptr || pick_b == nullptr)) return (int)cudaErrorInvalidValue;
  if (rows == 0 || row_bytes == 0) return 0;
#define ROW_COPY_TRY(W)                                                                      \
  if (row_bytes % (long long)sizeof(W) == 0 && row_copy_fits(sizeof(W), dst, dst_stride) &&  \
      row_copy_fits(sizeof(W), a, a_stride) && row_copy_fits(sizeof(W), b, b_stride)) {      \
    return row_copy_launch_as<W, SELECT>(dst, dst_stride, a, a_stride, b, b_stride, pick_b,  \
                                         rows, row_bytes, stream);                           \
  }
  ROW_COPY_TRY(uint4)
  ROW_COPY_TRY(uint2)
  ROW_COPY_TRY(uint32_t)
  ROW_COPY_TRY(uint16_t)
#undef ROW_COPY_TRY
  return row_copy_launch_as<unsigned char, SELECT>(dst, dst_stride, a, a_stride, b, b_stride,
                                                   pick_b, rows, row_bytes, stream);
}
