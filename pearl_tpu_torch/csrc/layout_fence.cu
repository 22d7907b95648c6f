// Copy fence and masked-scale fences for Hopper (sm_90a).
//
// Replaces the TPU kernels of pearl_tpu/ops/layout_fence.py:
//   copy_fence           <- copy_fence (`_copy_kernel`): bit-exact (B, F) copy;
//   masked_scale_fence   <- masked_scale_fence (`_fence_kernel`):
//                           ring * valid[..., None] * (1/div), (B, T, F);
//   masked_scale_fence4  <- masked_scale_fence4 (`_fence4_kernel`): the same
//                           values as the (B, T, H, W) NCHW conv input.
// On the TPU these exist to stop XLA's layout assignment; here they are the
// data movement the visual path needs anyway. copy_fence materialises the
// newest frame of the ring, a (B, F) view with row stride T*F, as a
// contiguous frame before the ring is written in place. The masked-scale
// fences are the one fused pass that masks the frames older than the episode
// and normalises the pixels for conv1. The ring is row-major (B, T, F), whose
// (B, T, H, W) form is the same bytes, so both fences share one kernel body
// and differ only in the shape check of their entry points.
//
// Bound on an H100: bytes, for all three. copy_fence reads and writes one
// frame (2 x 14.45 MB at B = 1024, F = 7056 bf16: 8.6 us at 3.35 TB/s); a
// masked-scale fence reads and writes the whole window (2 x 57.8 MB at T = 4:
// 34.5 us) plus B*T mask bytes. The design is only about wide, coalesced
// accesses: copy_fence is row_copy.cuh's strided row copy; the fence moves
// 16 bytes per thread access (4 float or 8 bfloat16) when F allows, scalars
// otherwise, grid over (row of B*T, chunk of row).
//
// Arithmetic, exactly `_fence_kernel`'s: y = float(x) * m with m = 0.0f or
// 1.0f, then y = y * inv where inv = float(1.0 / div) is passed in and is
// skipped altogether when div == 1 (SCALE false), then round to nearest even
// into the ring's type. Two multiplies, never a divide, never an fma.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>

#include "row_copy.cuh"

#define FENCE_THREADS 256
#define FENCE_UNROLL 2

extern "C" int copy_fence(void* out, const void* x, long long x_stride, long long B,
                          long long row_bytes, void* stream) {
  return row_copy_launch<false>(out, row_bytes, x, x_stride, nullptr, 0, nullptr, B, row_bytes,
                                static_cast<cudaStream_t>(stream));
}

template <bool SCALE>
__device__ __forceinline__ float fence_value(float x, float m, float inv) {
  float y = __fmul_rn(x, m);
  if (SCALE) y = __fmul_rn(y, inv);
  return y;
}

// 16 bytes of T: 4 float or 8 bfloat16.
template <typename T, bool SCALE>
__device__ __forceinline__ uint4 fence_word(uint4 w, float m, float inv);

template <>
__device__ __forceinline__ uint4 fence_word<float, true>(uint4 w, float m, float inv) {
  w.x = __float_as_uint(fence_value<true>(__uint_as_float(w.x), m, inv));
  w.y = __float_as_uint(fence_value<true>(__uint_as_float(w.y), m, inv));
  w.z = __float_as_uint(fence_value<true>(__uint_as_float(w.z), m, inv));
  w.w = __float_as_uint(fence_value<true>(__uint_as_float(w.w), m, inv));
  return w;
}

template <>
__device__ __forceinline__ uint4 fence_word<float, false>(uint4 w, float m, float inv) {
  w.x = __float_as_uint(fence_value<false>(__uint_as_float(w.x), m, inv));
  w.y = __float_as_uint(fence_value<false>(__uint_as_float(w.y), m, inv));
  w.z = __float_as_uint(fence_value<false>(__uint_as_float(w.z), m, inv));
  w.w = __float_as_uint(fence_value<false>(__uint_as_float(w.w), m, inv));
  return w;
}

template <bool SCALE>
__device__ __forceinline__ unsigned fence_bf16_pair(unsigned u, float m, float inv) {
  // A bfloat16 is the high half of a float: widen by shifting, exactly.
  const float lo = __uint_as_float(u << 16);
  const float hi = __uint_as_float(u & 0xffff0000u);
  const __nv_bfloat16 rlo = __float2bfloat16_rn(fence_value<SCALE>(lo, m, inv));
  const __nv_bfloat16 rhi = __float2bfloat16_rn(fence_value<SCALE>(hi, m, inv));
  return (unsigned)__bfloat16_as_ushort(rlo) | ((unsigned)__bfloat16_as_ushort(rhi) << 16);
}

template <>
__device__ __forceinline__ uint4 fence_word<__nv_bfloat16, true>(uint4 w, float m, float inv) {
  w.x = fence_bf16_pair<true>(w.x, m, inv);
  w.y = fence_bf16_pair<true>(w.y, m, inv);
  w.z = fence_bf16_pair<true>(w.z, m, inv);
  w.w = fence_bf16_pair<true>(w.w, m, inv);
  return w;
}

template <>
__device__ __forceinline__ uint4 fence_word<__nv_bfloat16, false>(uint4 w, float m, float inv) {
  w.x = fence_bf16_pair<false>(w.x, m, inv);
  w.y = fence_bf16_pair<false>(w.y, m, inv);
  w.z = fence_bf16_pair<false>(w.z, m, inv);
  w.w = fence_bf16_pair<false>(w.w, m, inv);
  return w;
}

__device__ __forceinline__ float fence_load(const float* p) { return *p; }
__device__ __forceinline__ float fence_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void fence_store(float* p, float y) { *p = y; }
__device__ __forceinline__ void fence_store(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16_rn(y);
}

// Rows of F elements, F * sizeof(T) a multiple of 16 and both bases aligned.
template <typename T, bool SCALE>
__global__ void __launch_bounds__(FENCE_THREADS)
masked_scale_vec_kernel(const uint4* __restrict__ x, const unsigned char* __restrict__ valid,
                        uint4* __restrict__ out, int words, float inv) {
  const long long row = blockIdx.x;
  const float m = valid[row] ? 1.0f : 0.0f;
  const uint4* src = x + row * words;
  uint4* dst = out + row * words;
  const int base = blockIdx.y * (FENCE_THREADS * FENCE_UNROLL) + threadIdx.x;
  uint4 v[FENCE_UNROLL];
#pragma unroll
  for (int k = 0; k < FENCE_UNROLL; ++k) {
    const int i = base + k * FENCE_THREADS;
    if (i < words) v[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < FENCE_UNROLL; ++k) {
    const int i = base + k * FENCE_THREADS;
    if (i < words) dst[i] = fence_word<T, SCALE>(v[k], m, inv);
  }
}

// Any F: one element per thread access.
template <typename T, bool SCALE>
__global__ void __launch_bounds__(FENCE_THREADS)
masked_scale_scalar_kernel(const T* __restrict__ x, const unsigned char* __restrict__ valid,
                           T* __restrict__ out, int F, float inv) {
  const long long row = blockIdx.x;
  const float m = valid[row] ? 1.0f : 0.0f;
  const T* src = x + row * F;
  T* dst = out + row * F;
  const int base = blockIdx.y * (FENCE_THREADS * FENCE_UNROLL) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < FENCE_UNROLL; ++k) {
    const int i = base + k * FENCE_THREADS;
    if (i < F) fence_store(dst + i, fence_value<SCALE>(fence_load(src + i), m, inv));
  }
}

template <typename T, bool SCALE>
static int masked_scale_launch_as(const void* x, const void* valid, void* out, long long rows,
                                  long long F, float inv, cudaStream_t stream) {
  const long long per_block = FENCE_THREADS * FENCE_UNROLL;
  const long long row_bytes = F * (long long)sizeof(T);
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const long long n = vec ? row_bytes / 16 : F;
  const long long chunks = (n + per_block - 1) / per_block;
  if (rows > 2147483647LL || chunks > 65535LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)rows, (unsigned)chunks);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  if (vec) {
    masked_scale_vec_kernel<T, SCALE><<<grid, FENCE_THREADS, 0, stream>>>(
        static_cast<const uint4*>(x), v, static_cast<uint4*>(out), (int)n, inv);
  } else {
    masked_scale_scalar_kernel<T, SCALE><<<grid, FENCE_THREADS, 0, stream>>>(
        static_cast<const T*>(x), v, static_cast<T*>(out), (int)n, inv);
  }
  return (int)cudaGetLastError();
}

// elem: 0 = float32, 1 = bfloat16. scale: 0 skips the second multiply.
static int masked_scale_launch(const void* x, const void* valid, void* out, long long rows,
                               long long F, int elem, int scale, float inv, void* stream) {
  if (x == nullptr || valid == nullptr || out == nullptr || rows < 0 || F < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 0) {
    return scale ? masked_scale_launch_as<float, true>(x, valid, out, rows, F, inv, s)
                 : masked_scale_launch_as<float, false>(x, valid, out, rows, F, inv, s);
  }
  if (elem == 1) {
    return scale ? masked_scale_launch_as<__nv_bfloat16, true>(x, valid, out, rows, F, inv, s)
                 : masked_scale_launch_as<__nv_bfloat16, false>(x, valid, out, rows, F, inv, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ring (B, T, F) -> out (B, T, F).
extern "C" int masked_scale_fence(const void* ring, const void* valid, void* out, long long B,
                                  long long T, long long F, int elem, int scale, float inv,
                                  void* stream) {
  if (B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  return masked_scale_launch(ring, valid, out, B * T, F, elem, scale, inv, stream);
}

// ring (B, T, H*W) -> out (B, T, H, W): the same bytes, checked to be H*W wide.
extern "C" int masked_scale_fence4(const void* ring, const void* valid, void* out, long long B,
                                   long long T, long long F, long long H, long long W, int elem,
                                   int scale, float inv, void* stream) {
  if (B < 0 || T < 0 || H < 0 || W < 0 || H * W != F) return (int)cudaErrorInvalidValue;
  return masked_scale_launch(ring, valid, out, B * T, F, elem, scale, inv, stream);
}
