// First convolution of the visual act path, read straight from the frame
// ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pearl_tpu/ops/ring_conv.py (`ring_conv1`,
// `_kernel`): conv1 over the T frames of the ring in ring order, with the
// validity mask, the /255 folded into the weights, bias and relu, in one pass:
//     out[b, oc, oy, ox] = relu(bias[oc] + sum_{t, ky, kx} m[b, t] *
//                               ring[b, t, (oy*s + ky)*W + ox*s + kx] *
//                               wmat[(t*k + ky)*k + kx, oc])
// ring (B, T, H*W) row-major, valid (B, T) bytes, wmat (T*k*k, OC) in the
// ring's type, already rotated by the cursor and divided by 255, bias (OC,)
// float32; out (B, OC, OH, OW) row-major in the ring's type,
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
// bfloat16 (57.8 MB read + 13.1 MB written, 21.2 us at 3.35 TB/s): its 3.36
// GFLOP are 3.4 us on the tensor cores but 50 us on the CUDA cores, behind
// shared-memory loads of about one per two FMAs. A float32 ring is bound by
// its float32 operations (its tolerance, 2e-5, rules out TF32).
//
// Two bodies; `rc_pick_body` chooses (a pure function of the element type, the
// geometry, the ring's alignment and the shared memory a block may use; the
// Python wrapper mirrors it as `pick_body`):
//
//   RC_BODY_MMA  a bfloat16 ring with k a multiple of 8, s and W multiples of
//     4, OC 8, 16 or 32, frames of a multiple of 16 bytes at a 16-byte aligned
//     base, and room for two envs' frames in shared memory. An implicit GEMM
//     on the tensor cores, M = pixels, N = OC, K = T*k*k, bf16 x bf16 with
//     float32 accumulation in `mma.sync.m16n8k16`. Overlapping patches (k = 8,
//     s = 4) are no regular tile in shared memory, so A comes from registers,
//     gathered straight from the staged frames. One k-step of 16 is two kernel
//     rows (ky, ky+1) x 8 kx of one frame, and the 16 columns of the tile are
//     dealt out so that a lane's two A registers of a pixel are ONE aligned
//     8-byte word: lane c = lane % 4 takes row ky + c/2, kx = 4*(c%2) .. +3
//     (columns 2c, 2c+1 and 2c+8, 2c+9 of the tile), at ((oy*s + ky + c/2)*W +
//     ox*s + 4*(c%2)); lanes of neighbouring pixels share words by broadcast.
//     B, the weights, is laid out once per block in the same order of columns,
//     as the lanes read it (one 16-byte load per k-step and 16 channels). A
//     warp holds two 16-pixel tiles so that a B load serves four `mma`s.
//     Blocks are persistent over envs: the T frames of an env are
//     contiguous in the ring, and each valid one is moved by ONE bulk copy
//     (`cp.async.bulk`, no tensor map) that reports to an `mbarrier`; two or
//     three envs' frames are in flight or in use at a time, so the next env's
//     bytes arrive while this one is multiplied. Every input byte is read
//     once. The epilogue adds bias, clamps, rounds once and goes through
//     shared memory, where out[b] lies as in device memory, so that the
//     stores are 16 bytes wide.
//
//   RC_BODY_GENERAL  everything else (a float32 ring, k = 4 or 5, s = 2 or 3,
//     OC = 4, unaligned frames, frames too large to stage whole): a block per
//     (env, tile of R output rows). The T bands of (R-1)*s + k input rows are
//     staged with 16-byte loads (element loads when a band is not aligned)
//     beside wmat (as float32) and the bias; each thread holds the OC outputs
//     of two pixels in registers and runs float32 FMAs on the CUDA cores; R
//     is the largest tile under RC_SMEM_BUDGET, so several blocks fit an SM.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define RC_BODY_GENERAL 0
#define RC_BODY_MMA 1

#define RC_MAX_T 32
#define RC_MAX_THREADS 256
#define RC_SMEM_BUDGET (56 * 1024)
// 227 KB a block may use, less the kernel's static shared memory.
#define RC_SMEM_MAX (232448 - 1024)

// ----------------------------------------------------------------- mma body

#define RC_MMA_MAX_STAGES 3
#define RC_MT 2  // 16-pixel tiles a warp holds at a time
#define RC_MMA_MAX_WARPS (32 / RC_MT)

__device__ __forceinline__ uint32_t rc_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void rc_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void rc_mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void rc_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes from device memory into shared memory, both 16-byte
// aligned, bytes a multiple of 16; completion is counted on the barrier.
__device__ __forceinline__ void rc_bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// D += A (16 x 16, row) * B (16 x 8, col), bf16 operands, float32 sum.
__device__ __forceinline__ void rc_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the mma body, in bytes from a 128-byte aligned base:
// `stages` envs of T frames, the weights in fragment order, out[b] twice (one
// env's is stored while the next one's is written), the bias, the barriers
// and the stages' valid flags.
struct RcMmaLayout {
  long long frame_bytes, stage_bytes, w_off, out_off, out_bytes, bias_off, bar_off, valid_off,
      total;
};

__host__ __device__ static inline RcMmaLayout rc_mma_layout(long long T, long long H,
                                                             long long W, long long k,
                                                             long long OC, long long P,
                                                             long long stages) {
  RcMmaLayout l;
  l.frame_bytes = H * W * 2;
  l.stage_bytes = T * l.frame_bytes;
  l.w_off = stages * l.stage_bytes;
  l.out_off = l.w_off + T * k * k * OC * 2;
  l.out_bytes = (OC * P * 2 + 15) / 16 * 16;
  l.bias_off = l.out_off + 2 * l.out_bytes;
  l.bar_off = l.bias_off + OC * 4;
  l.valid_off = l.bar_off + RC_MMA_MAX_STAGES * 8;
  l.total = l.valid_off + RC_MMA_MAX_STAGES * RC_MAX_T;
  return l;
}

// NT: tiles of 8 output channels (OC = 8 * NT). K: the kernel size fixed at
// compile time (the k-steps of a frame are then unrolled, so that the loads of
// one run under the `mma`s of another), or 0 to take k at run time.
template <int NT, int K>
__global__ void __launch_bounds__(RC_MMA_MAX_WARPS * 32)
ring_conv1_mma_kernel(const __nv_bfloat16* __restrict__ ring,
                      const unsigned char* __restrict__ valid,
                      const __nv_bfloat16* __restrict__ wmat, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, long long B, int T, int H, int W, int k_rt,
                      int s, int OH, int OW, int stages, int out_vec) {
  constexpr int OC = 8 * NT;
  constexpr int kUnrollY = K ? K / 2 : 2, kUnrollX = K ? K / 8 : 1;
  const int k = K ? K : k_rt;
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = OH * OW;
  const RcMmaLayout lay = rc_mma_layout(T, H, W, k, OC, P, stages);
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem + lay.w_off);
  float* sbias = reinterpret_cast<float*>(smem + lay.bias_off);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bar_off);
  unsigned char* sv = smem + lay.valid_off;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t frame_bytes = (uint32_t)lay.frame_bytes;
  const long long frame_elems = (long long)H * W;

  // Warp 0 is the producer, lane t for frame t: the valid flags of env b into
  // the stage's slot, one arrival that announces the bytes, one bulk copy per
  // valid frame. `on` is this lane's flag (0 for lanes >= T).
  auto start_copies = [&](long long b, int stage, unsigned char on) {
    const unsigned mask = __ballot_sync(0xffffffffu, on != 0);
    if (lane < T) sv[stage * RC_MAX_T + lane] = on;
    __syncwarp();
    const uint32_t bar = rc_smem_addr(bars + stage);
    if (lane == 0) rc_mbar_arrive_expect(bar, (uint32_t)__popc(mask) * frame_bytes);
    __syncwarp();
    if (on) {
      const uint32_t dst = rc_smem_addr(smem + (long long)stage * lay.stage_bytes);
      rc_bulk_load(dst + lane * frame_bytes, ring + (b * T + lane) * frame_elems, frame_bytes,
                   bar);
    }
  };

  // The weights in the order the lanes read them: word ((ks*32 + lane)*NT +
  // nt)*2 + r holds rows (2*tq + 8*r, +1) of k-step ks (kernel row ky + tq/2,
  // kx = 4*(tq%2) + 2*r, +1), column nt*8 + g. Each thread takes 16-byte
  // pieces of wmat (8 channels of one row, one trip to device memory for the
  // whole block) and scatters their halves.
  const int kxbs = k >> 3, kyps = k >> 1;
  const int ksteps_per_frame = kxbs * kyps;
  unsigned short* wf16 = reinterpret_cast<unsigned short*>(wf);
  const int n_pieces = T * k * k * NT;
  auto scatter = [&](int i, const uint4& v) {
    const int row = i / NT, nt = i - row * NT;
    const int t = row / (k * k), in_frame = row - t * k * k;
    const int ky = in_frame / k, kx = in_frame - ky * k;
    const int ks = (t * kyps + (ky >> 1)) * kxbs + (kx >> 3);
    const int c = ((ky & 1) << 1) | ((kx & 7) >> 2);
    const int slot = (ks * 32 + c) * NT + nt;  // + 4 * NT per channel of the piece
    const int sub = ((kx >> 1) & 1) * 2 + (kx & 1);
    const uint32_t pairs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wf16[(slot + 4 * NT * j) * 4 + sub] = (unsigned short)(pairs[j >> 1] >> (16 * (j & 1)));
    }
  };
  // The first pieces and the bias are asked for BEFORE the frames: behind the
  // first envs' bulk copies (all blocks start theirs at once) a small load
  // waits many microseconds.
  const uint4* pieces = reinterpret_cast<const uint4*>(wmat);
  uint4 first[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = tid + q * nthreads;
    first[q] = i < n_pieces ? __ldg(pieces + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  const float my_bias = tid < OC ? __ldg(bias + tid) : 0.0f;

  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < stages; ++i) rc_mbar_init(rc_smem_addr(bars + i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    unsigned char on[RC_MMA_MAX_STAGES];  // all the flags first: one trip, not `stages`
#pragma unroll
    for (int i = 0; i < RC_MMA_MAX_STAGES; ++i) {
      const long long b = blockIdx.x + (long long)i * gridDim.x;
      on[i] = (i < stages && b < B && lane < T) ? valid[b * T + lane] : (unsigned char)0;
    }
#pragma unroll
    for (int i = 0; i < RC_MMA_MAX_STAGES; ++i) {
      const long long b = blockIdx.x + (long long)i * gridDim.x;
      if (i < stages && b < B) start_copies(b, i, on[i]);
    }
  }

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = tid + q * nthreads;
    if (i < n_pieces) scatter(i, first[q]);
  }
  for (int i = tid + 2 * nthreads; i < n_pieces; i += nthreads) scatter(i, __ldg(pieces + i));
  if (tid < OC) sbias[tid] = my_bias;
  __syncthreads();  // weights and bias laid out; the barriers' init is visible

  const int n_tiles = (P + 15) >> 4;
  const int n_units = (n_tiles + RC_MT - 1) / RC_MT;  // a unit: RC_MT tiles of 16 pixels
  const int half_w = W >> 1;               // a frame row, in 32-bit words
  const int frame_words = (int)(frame_elems >> 1);

  int it = 0;
  for (long long b = blockIdx.x; b < B; b += gridDim.x, ++it) {
    const int stage = it % stages;
    // The flags of the env that will take this stage next, asked for now so
    // that they have arrived when the stage is free.
    const long long nb = b + (long long)stages * gridDim.x;
    unsigned char next_on = 0;
    if (warp == 0 && nb < B && lane < T) next_on = valid[nb * T + lane];
    rc_mbar_wait(rc_smem_addr(bars + stage), (uint32_t)((it / stages) & 1));
    const uint32_t* frames = reinterpret_cast<const uint32_t*>(smem + stage * lay.stage_bytes);
    __nv_bfloat16* sout =
        reinterpret_cast<__nv_bfloat16*>(smem + lay.out_off + (it & 1) * lay.out_bytes);
    const unsigned char* on = sv + stage * RC_MAX_T;

    for (int unit = warp; unit < n_units; unit += nwarps) {
      // This lane's four pixels: rows g and g + 8 of the unit's two tiles.
      int pix[2 * RC_MT], aoff[2 * RC_MT];
#pragma unroll
      for (int i = 0; i < 2 * RC_MT; ++i) {
        pix[i] = (RC_MT * unit + (i >> 1)) * 16 + g + 8 * (i & 1);
        const int pc = min(pix[i], P - 1);  // a clamped pixel is computed and dropped
        const int oy = pc / OW, ox = pc - oy * OW;
        aoff[i] = ((oy * s * W + ox * s) >> 1) + 2 * (tq & 1) + (tq >> 1) * half_w;
      }
      float acc[RC_MT][NT][4];
#pragma unroll
      for (int m = 0; m < RC_MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][nt][c] = 0.0f;
        }
      }
      for (int t = 0; t < T; ++t) {
        if (!on[t]) continue;
        const uint32_t* fb = frames + t * frame_words;
        const uint2* bp =
            reinterpret_cast<const uint2*>(wf) + ((size_t)t * ksteps_per_frame * 32 + lane) * NT;
#pragma unroll kUnrollY
        for (int kyp = 0; kyp < (K ? K / 2 : kyps); ++kyp) {
#pragma unroll kUnrollX
          for (int kxb = 0; kxb < (K ? K / 8 : kxbs); ++kxb) {
            uint2 bv[NT];
            if (NT == 2) {  // one 16-byte load: 8 lanes a phase, 32 different banks
              const uint4 b4 = *reinterpret_cast<const uint4*>(bp);
              bv[0] = make_uint2(b4.x, b4.y);
              bv[NT - 1] = make_uint2(b4.z, b4.w);
            } else {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) bv[nt] = bp[nt];
            }
            bp += 32 * NT;
            const int woff = kyp * W + kxb * 4;  // rows 2*kyp, columns kxb*8, in words
#pragma unroll
            for (int m = 0; m < RC_MT; ++m) {
              const uint2 lo = *reinterpret_cast<const uint2*>(fb + aoff[2 * m] + woff);
              const uint2 hi = *reinterpret_cast<const uint2*>(fb + aoff[2 * m + 1] + woff);
              const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) rc_mma(acc[m][nt], a, bv[nt].x, bv[nt].y);
            }
          }
        }
      }
      // Bias, relu and the one rounding; out[b] as it lies in device memory.
#pragma unroll
      for (int m = 0; m < RC_MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n0 = nt * 8 + 2 * tq;
          const float b0 = sbias[n0], b1 = sbias[n0 + 1];
          const int p0 = pix[2 * m], p1 = pix[2 * m + 1];
          if (p0 < P) {
            sout[n0 * P + p0] = __float2bfloat16_rn(fmaxf(acc[m][nt][0] + b0, 0.0f));
            sout[(n0 + 1) * P + p0] = __float2bfloat16_rn(fmaxf(acc[m][nt][1] + b1, 0.0f));
          }
          if (p1 < P) {
            sout[n0 * P + p1] = __float2bfloat16_rn(fmaxf(acc[m][nt][2] + b0, 0.0f));
            sout[(n0 + 1) * P + p1] = __float2bfloat16_rn(fmaxf(acc[m][nt][3] + b1, 0.0f));
          }
        }
      }
    }
    __syncthreads();  // the stage's frames and flags are read, out[b] is whole

    if (warp == 0 && nb < B) start_copies(nb, stage, next_on);
    __nv_bfloat16* ob = out + b * OC * P;
    if (out_vec) {
      const int n16 = OC * P / 8;
      for (int i = tid; i < n16; i += nthreads) {
        reinterpret_cast<uint4*>(ob)[i] = reinterpret_cast<const uint4*>(sout)[i];
      }
    } else {
      for (int i = tid; i < OC * P; i += nthreads) ob[i] = sout[i];
    }
    // No second barrier: the next env's out goes to the other buffer, and this
    // one is written again only after the next env's barrier above.
  }
}

// Stages of the mma body: the most of 3 whose frames fit `smem_max` bytes
// beside the fixed part (0 when not even one env does).
static int rc_mma_stages(long long T, long long H, long long W, long long k, long long OC,
                         long long P, long long smem_max) {
  const RcMmaLayout one = rc_mma_layout(T, H, W, k, OC, P, 1);
  const long long fixed = one.total - one.stage_bytes;
  long long stages = (smem_max - fixed) / one.stage_bytes;
  if (stages > RC_MMA_MAX_STAGES) stages = RC_MMA_MAX_STAGES;
  return stages < 0 ? 0 : (int)stages;
}

template <int NT, int K>
static int rc_launch_mma(const void* ring, const void* valid, const void* wmat, const void* bias,
                         void* out, long long B, int T, int H, int W, int k, int s,
                         cudaStream_t stream) {
  const int OH = (H - k) / s + 1, OW = (W - k) / s + 1, OC = 8 * NT;
  const long long P = (long long)OH * OW;
  const int stages = rc_mma_stages(T, H, W, k, OC, P, RC_SMEM_MAX);
  const long long smem = rc_mma_layout(T, H, W, k, OC, P, stages).total;
  // Warps: one round of units (two 16-pixel tiles) where 16 warps suffice,
  // else the fewest warps that need no more rounds than 16 would.
  const int units = (int)(((P + 15) / 16 + RC_MT - 1) / RC_MT);
  const int rounds = (units + RC_MMA_MAX_WARPS - 1) / RC_MMA_MAX_WARPS;
  int warps = (units + rounds - 1) / rounds;
  if (warps < 4) warps = 4;
  auto kernel = ring_conv1_mma_kernel<NT, K>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long resident = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(B < resident ? B : resident);
  const int out_vec = (OC * P * 2) % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  kernel<<<grid, warps * 32, (size_t)smem, stream>>>(
      static_cast<const __nv_bfloat16*>(ring), static_cast<const unsigned char*>(valid),
      static_cast<const __nv_bfloat16*>(wmat), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, T, H, W, k, s, OH, OW, stages, out_vec);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- general body

__device__ __forceinline__ float rc_load(const float* p) { return *p; }
__device__ __forceinline__ float rc_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void rc_store(float* p, float y) { *p = y; }
__device__ __forceinline__ void rc_store(__nv_bfloat16* p, float y) {
  *p = __float2bfloat16_rn(y);
}

// K, S: kernel size and stride fixed at compile time, or 0 to take k_rt, s_rt.
template <typename E, int OC, int K, int S>
__global__ void __launch_bounds__(RC_MAX_THREADS)
ring_conv1_general_kernel(const E* __restrict__ ring, const unsigned char* __restrict__ valid,
                          const E* __restrict__ wmat, const float* __restrict__ bias,
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
  if (sizeof(E) == 4 && (reinterpret_cast<uintptr_t>(wmat) & 15) == 0) {
    for (int i = tid; i < n_w / 4; i += nthreads) {
      reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(wmat)[i];
    }
  } else {
    for (int i = tid; i < n_w; i += nthreads) sw[i] = rc_load(wmat + i);
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
  auto kernel = ring_conv1_general_kernel<E, OC, K, S>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)B, (unsigned)tiles);
  kernel<<<grid, threads, (size_t)smem, stream>>>(
      static_cast<const E*>(ring), static_cast<const unsigned char*>(valid),
      static_cast<const E*>(wmat), static_cast<const float*>(bias), static_cast<E*>(out), T,
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

// ------------------------------------------------------------------- entry

// The body for a ring: RC_BODY_*. Pure. elem: 0 = float32, 1 = bfloat16;
// ring_aligned: the ring's base address is a multiple of 16.
static int rc_pick_body(int elem, int T, int H, int W, int k, int s, int OC, int ring_aligned,
                        long long smem_max) {
  const long long P = (long long)((H - k) / s + 1) * ((W - k) / s + 1);
  const bool mma = elem == 1 && k % 8 == 0 && s % 4 == 0 && W % 4 == 0 && OC % 8 == 0 &&
                   OC <= 32 && ((long long)H * W * 2) % 16 == 0 && ring_aligned &&
                   rc_mma_stages(T, H, W, k, OC, P, smem_max) >= 2;
  return mma ? RC_BODY_MMA : RC_BODY_GENERAL;
}

// The choice alone: the body `ring_conv1` would launch for a block that may
// use `smem_max` bytes of shared memory.
extern "C" int ring_conv1_pick(int elem, int T, int H, int W, int k, int s, int OC,
                               int ring_aligned, long long smem_max) {
  return rc_pick_body(elem, T, H, W, k, s, OC, ring_aligned, smem_max);
}

// elem: 0 = float32, 1 = bfloat16: the type of ring, wmat and out. bias is
// float32. wmat is 16-byte aligned. `picked` receives the body that was launched (RC_BODY_*).
extern "C" int ring_conv1(const void* ring, const void* valid, const void* wmat, const void* bias,
                          void* out, long long B, int T, int H, int W, int k, int s, int OC,
                          int elem, void* stream, int* picked) {
  if (ring == nullptr || valid == nullptr || wmat == nullptr || bias == nullptr ||
      out == nullptr || B < 0 || T < 1 || T > RC_MAX_T || k < 1 || s < 1 || H < k || W < k ||
      (elem != 0 && elem != 1) || (reinterpret_cast<uintptr_t>(wmat) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int aligned = (reinterpret_cast<uintptr_t>(ring) & 15) == 0;
  const int body = rc_pick_body(elem, T, H, W, k, s, OC, aligned, RC_SMEM_MAX);
  if (picked != nullptr) *picked = body;
  if (body == RC_BODY_MMA) {
    if (OC == 16 && k == 8) {
      return rc_launch_mma<2, 8>(ring, valid, wmat, bias, out, B, T, H, W, k, s, st);
    }
    switch (OC) {
      case 8: return rc_launch_mma<1, 0>(ring, valid, wmat, bias, out, B, T, H, W, k, s, st);
      case 16: return rc_launch_mma<2, 0>(ring, valid, wmat, bias, out, B, T, H, W, k, s, st);
      case 32: return rc_launch_mma<4, 0>(ring, valid, wmat, bias, out, B, T, H, W, k, s, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (elem == 0) {
    return rc_launch_elem<float>(ring, valid, wmat, bias, out, B, T, H, W, k, s, OC, st);
  }
  return rc_launch_elem<__nv_bfloat16>(ring, valid, wmat, bias, out, B, T, H, W, k, s, OC, st);
}
