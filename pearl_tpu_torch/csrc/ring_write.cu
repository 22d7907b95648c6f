// In-place frame-ring slab writes for Hopper (sm_90a).
//
// Replaces the TPU kernels of pearl_tpu/ops/ring_write.py:
//   ring_write        <- ring_slab_write_tfb (`_kernel`):
//                        ring[:, cursor, :] <- entry
//   ring_write_where  <- ring_slab_write_where_tfb (`_where_kernel`):
//                        ring[:, cursor, :] <- where(done, reset, obs)
// Both write one (B, F) frame into slot `cursor` of the contiguous row-major
// (B, T, F) ring and never touch the other T-1 slots. The TPU kernels see
// the ring as a (T, F, B) transposed view with (F, B) entries because of
// XLA:TPU's layout rules; none of that exists here.
//
// Bound on an H100: bytes. One frame read and one frame written (at B = 1024,
// F = 7056 bf16: 2 x 14.45 MB, 8.6 us at 3.35 TB/s); the select adds B bytes
// of `done` and reads, per row, only the source it picks. A frame is moved
// as bytes whatever its element type, so one kernel serves float32 and
// bfloat16; row_copy.cuh has the design (16-byte words on aligned rows,
// narrower words on ragged ones, grid over (row, chunk of row)).
//
// Sources are (B, F) with unit inner stride and their own row stride. Sizes
// and strides arrive in bytes. Each entry point returns cudaGetLastError()
// after its launch.

#include "row_copy.cuh"

extern "C" int ring_write(void* ring, const void* entry, long long entry_stride, long long B,
                          long long T, long long row_bytes, long long cursor, void* stream) {
  if (ring == nullptr || T < 1 || cursor < 0 || cursor >= T) return (int)cudaErrorInvalidValue;
  char* slab = static_cast<char*>(ring) + cursor * row_bytes;
  return row_copy_launch<false>(slab, T * row_bytes, entry, entry_stride, nullptr, 0, nullptr, B,
                                row_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" int ring_write_where(void* ring, const void* obs, long long obs_stride,
                                const void* reset, long long reset_stride, const void* done,
                                long long B, long long T, long long row_bytes, long long cursor,
                                void* stream) {
  if (ring == nullptr || T < 1 || cursor < 0 || cursor >= T) return (int)cudaErrorInvalidValue;
  char* slab = static_cast<char*>(ring) + cursor * row_bytes;
  return row_copy_launch<true>(slab, T * row_bytes, obs, obs_stride, reset, reset_stride, done, B,
                               row_bytes, static_cast<cudaStream_t>(stream));
}
