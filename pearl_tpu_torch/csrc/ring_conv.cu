// First convolution of the visual act path, read straight from the frame
// ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pearl_tpu/ops/ring_conv.py (`ring_conv1`,
// `_kernel`): conv1 over the T frames of the ring in ring order, with the
// validity mask, the /255 folded into the weights, bias and relu, in one pass:
//     out[b, oc, oy, ox] = relu(bias[oc] + sum_{t, ky, kx} m[b, t] *
//                               ring[b, t, (oy*s + ky)*W + ox*s + kx] *
//                               wmat[(t*k + ky)*k + kx, oc])
// ring (B, T, H*W) row-major, valid (B, T) bytes, wmat (T*k*k, OC) float32
// already rotated by the cursor, divided by 255 and rounded to the ring's
// type, bias (OC,) float32; out (B, OC, OH, OW) row-major in the ring's type,
// the NCHW input of conv2. Nothing of the TPU kernel's (T, H, W/s, s, B) view,
// its per-column 2-D dots or its im2col scratch is needed here.
//
// Arithmetic, the reference's: the masked patch is x or exactly zero; products
// accumulate in float32 (a bfloat16 x times a bfloat16-rounded weight is exact
// in float32); bias is added in float32, then relu, then one rounding into the
// output's type. Only the order of the T*k*k-term sum differs. A frame whose
// valid flag is false is skipped for the whole block: its contribution is
// exactly zero for finite pixels.
//
// Bound on an H100 at B = 1024, T = 4, 84 x 84, k = 8, s = 4, OC = 16: bytes in
// bfloat16 (57.8 MB read + 13.1 MB written, 21.2 us at 3.35 TB/s; its 3.36
// GFLOP run here on the CUDA cores in float32, 50 us at 67 TFLOP/s, which is
// what this first version is really held to), operations in float32.
//
// Design: a block per (env, tile of R output rows). The T bands of
// (R-1)*s + k input rows are contiguous in the ring and are staged in shared
// memory with 16-byte loads (element loads when a band is not 16-byte
// aligned), beside the whole wmat and the bias. Each thread holds the OC
// outputs of two pixels (rows r and r + R/2 of the tile, the same column) in
// registers, so one broadcast float4 read of a weight row serves two pixels;
// the epilogue's stores are coalesced along ox for every oc. R is the largest
// tile whose shared memory stays under RC_SMEM_BUDGET, so several blocks fit
// an SM. Tensor cores (an implicit GEMM of M = B*OH*OW, N = OC, K = T*k*k) and
// TMA staging are the next step, not taken here.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define RC_MAX_T 32
#define RC_MAX_THREADS 256
#define RC_SMEM_BUDGET (56 * 1024)
// 227 KB a block may use, less the kernel's static shared memory.
#define RC_SMEM_MAX (232448 - 1024)

__device__ __forceinline__ float rc_load(const float* p) { return *p; }
__device__ __forceinline__ float rc_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void rc_store(float* p, float y) { *p = y; }
__device__ __forceinline__ void rc_store(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16_rn(y);
}

// K, S: kernel size and stride fixed at compile time, or 0 to take k_rt, s_rt.
template <typename E, int OC, int K, int S>
__global__ void __launch_bounds__(RC_MAX_THREADS)
ring_conv1_kernel(const E* __restrict__ ring, const unsigned char* __restrict__ valid,
                  const float* __restrict__ wmat, const float* __restrict__ bias,
                  E* __restrict__ out, int T, int H, int W, int k_rt, int s_rt, int OH, int OW,
                  int R, int RH, int band_stride) {
  const int k = K ? K : k_rt;
  const int s = S ? S : s_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned char sv[RC_MAX_T];
  const int n_w = T * k * k * OC;
  float* sw = reinterpret_cast<float*>(smem);
  float* sb = sw + n_w;
  E* sx = reinterpret_cast<E*>(sb + OC);  // (n_w + OC) * 4 bytes: a multiple of 16

  const long long b = blockIdx.x;
  const int oy0 = blockIdx.y * R;
  const int rows_out = min(R, OH - oy0);
  const int band_elems = ((rows_out - 1) * s + k) * W;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  if (tid < T) sv[tid] = valid[b * T + tid];
  for (int i = tid; i < n_w / 4; i += nthreads) {
    reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(wmat)[i];
  }
  if (tid < OC) sb[tid] = bias[tid];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (!sv[t]) continue;
    const E* src = ring + ((b * T + t) * H + (long long)oy0 * s) * W;
    E* dst = sx + (size_t)t * band_stride;
    const size_t bytes = (size_t)band_elems * sizeof(E);
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
      const int n16 = (int)(bytes / 16);
      for (int i = tid; i < n16; i += nthreads) {
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
      }
    } else {
      for (int i = tid; i < band_elems; i += nthreads) dst[i] = src[i];
    }
  }
  __syncthreads();

  for (int item = tid; item < RH * OW; item += nthreads) {
    const int r0 = item / OW;
    const int ox = item - r0 * OW;
    if (r0 >= rows_out) continue;
    const bool has1 = r0 + RH < rows_out;
    const int r1 = has1 ? r0 + RH : r0;
    float acc0[OC], acc1[OC];
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      acc0[oc] = 0.0f;
      acc1[oc] = 0.0f;
    }
    for (int t = 0; t < T; ++t) {
      if (!sv[t]) continue;
      const E* band = sx + (size_t)t * band_stride + ox * s;
      for (int ky = 0; ky < k; ++ky) {
        const E* p0 = band + (r0 * s + ky) * W;
        const E* p1 = band + (r1 * s + ky) * W;
        const float4* wrow = reinterpret_cast<const float4*>(sw + ((t * k + ky) * k) * OC);
#pragma unroll
        for (int kx = 0; kx < (K ? K : k); ++kx) {
          const float x0 = rc_load(p0 + kx);
          const float x1 = rc_load(p1 + kx);
#pragma unroll
          for (int q = 0; q < OC / 4; ++q) {
            const float4 w = wrow[kx * (OC / 4) + q];
            acc0[4 * q + 0] = fmaf(x0, w.x, acc0[4 * q + 0]);
            acc0[4 * q + 1] = fmaf(x0, w.y, acc0[4 * q + 1]);
            acc0[4 * q + 2] = fmaf(x0, w.z, acc0[4 * q + 2]);
            acc0[4 * q + 3] = fmaf(x0, w.w, acc0[4 * q + 3]);
            acc1[4 * q + 0] = fmaf(x1, w.x, acc1[4 * q + 0]);
            acc1[4 * q + 1] = fmaf(x1, w.y, acc1[4 * q + 1]);
            acc1[4 * q + 2] = fmaf(x1, w.z, acc1[4 * q + 2]);
            acc1[4 * q + 3] = fmaf(x1, w.w, acc1[4 * q + 3]);
          }
        }
      }
    }
    E* o = out + (b * OC * OH + oy0) * OW + ox;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      const size_t plane = (size_t)oc * OH * OW;
      rc_store(o + plane + (size_t)r0 * OW, fmaxf(acc0[oc] + sb[oc], 0.0f));
      if (has1) rc_store(o + plane + (size_t)r1 * OW, fmaxf(acc1[oc] + sb[oc], 0.0f));
    }
  }
}

// Shared memory of a block with tiles of R output rows; the band of one frame
// is padded to a multiple of 16 bytes so that every band starts aligned.
static long long rc_band_stride(long long R, long long W, long long k, long long s,
                                long long esize) {
  const long long per16 = 16 / esize;
  const long long elems = ((R - 1) * s + k) * W;
  return (elems + per16 - 1) / per16 * per16;
}

static long long rc_smem_bytes(long long R, long long T, long long W, long long k, long long s,
                               long long OC, long long esize) {
  return (T * k * k * OC + OC) * 4 + T * rc_band_stride(R, W, k, s, esize) * esize;
}

template <typename E, int OC, int K, int S>
static int rc_launch_as(const void* ring, const void* valid, const void* wmat, const void* bias,
                        void* out, long long B, int T, int H, int W, int k, int s,
                        cudaStream_t stream) {
  const int OH = (H - k) / s + 1;
  const int OW = (W - k) / s + 1;
  const long long esize = (long long)sizeof(E);
  // The fewest tiles per env whose block stays under the budget; one output
  // row per tile may go up to the card's limit.
  int R = OH;
  for (int n = 1; n <= OH; ++n) {
    R = (OH + n - 1) / n;
    if (rc_smem_bytes(R, T, W, k, s, OC, esize) <= RC_SMEM_BUDGET) break;
  }
  const long long smem = rc_smem_bytes(R, T, W, k, s, OC, esize);
  if (smem > RC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int tiles = (OH + R - 1) / R;
  if (tiles > 65535 || B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int RH = (R + 1) / 2;
  int threads = (RH * OW + 31) / 32 * 32;
  if (threads < 128) threads = 128;
  if (threads > RC_MAX_THREADS) threads = RC_MAX_THREADS;
  auto kernel = ring_conv1_kernel<E, OC, K, S>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)B, (unsigned)tiles);
  kernel<<<grid, threads, (size_t)smem, stream>>>(
      static_cast<const E*>(ring), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(wmat), static_cast<const float*>(bias), static_cast<E*>(out), T,
      H, W, k, s, OH, OW, R, RH, (int)rc_band_stride(R, W, k, s, esize));
  return (int)cudaGetLastError();
}

template <typename E, int OC>
static int rc_launch_oc(const void* ring, const void* valid, const void* wmat, const void* bias,
                        void* out, long long B, int T, int H, int W, int k, int s,
                        cudaStream_t stream) {
  if (k == 8 && s == 4) {
    return rc_launch_as<E, OC, 8, 4>(ring, valid, wmat, bias, out, B, T, H, W, k, s, stream);
  }
  return rc_launch_as<E, OC, 0, 0>(ring, valid, wmat, bias, out, B, T, H, W, k, s, stream);
}

template <typename E>
static int rc_launch_elem(const void* ring, const void* valid, const void* wmat,
                          const void* bias, void* out, long long B, int T, int H, int W, int k,
                          int s, int OC, cudaStream_t stream) {
  switch (OC) {
    case 4: return rc_launch_oc<E, 4>(ring, valid, wmat, bias, out, B, T, H, W, k, s, stream);
    case 8: return rc_launch_oc<E, 8>(ring, valid, wmat, bias, out, B, T, H, W, k, s, stream);
    case 16: return rc_launch_oc<E, 16>(ring, valid, wmat, bias, out, B, T, H, W, k, s, stream);
    case 32: return rc_launch_oc<E, 32>(ring, valid, wmat, bias, out, B, T, H, W, k, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// elem: 0 = float32, 1 = bfloat16 (the type of ring and out). wmat and bias
// are float32 and 16-byte aligned.
extern "C" int ring_conv1(const void* ring, const void* valid, const void* wmat, const void* bias,
                          void* out, long long B, int T, int H, int W, int k, int s, int OC,
                          int elem, void* stream) {
  if (ring == nullptr || valid == nullptr || wmat == nullptr || bias == nullptr ||
      out == nullptr || B < 0 || T < 1 || T > RC_MAX_T || k < 1 || s < 1 || H < k || W < k ||
      (reinterpret_cast<uintptr_t>(wmat) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == 0) {
    return rc_launch_elem<float>(ring, valid, wmat, bias, out, B, T, H, W, k, s, OC, st);
  }
  if (elem == 1) {
    return rc_launch_elem<__nv_bfloat16>(ring, valid, wmat, bias, out, B, T, H, W, k, s, OC, st);
  }
  return (int)cudaErrorInvalidValue;
}
