// Fused relu-MLP forward for Hopper (sm_90a): x@W1^T+b1 -> relu -> ... -> @Wn^T+bn.
//
// Replaces the TPU kernel `_pallas_forward` in pearl_tpu/ops/fused_mlp.py.
// Computes what it computes (the whole chain in one kernel, activations never
// written to device memory), not a block-by-block copy of it.
//
// Bound on an H100 at the DQN act shape (B = 131072, 4 -> 64 -> 64 -> 2):
// x plus the output is 3 MB, about 1 us at 3.35 TB/s, while the chain is
// 2*B*(4*64 + 64*64 + 64*2) ~= 1.17 GFLOP of float32 on the CUDA cores
// (67 TFLOP/s, ~17 us). So the kernel is bound by operations, and by the
// shared-memory loads that feed them. The design:
//   - one thread carries one row through the whole chain; every sum is an
//     f32 fma chain in registers, 8 (or 4) outputs at a time;
//   - every W and b is staged once per block in shared memory, transposed to
//     (in, out) with `out` padded to a multiple of 4, so the 8 weights an
//     output group needs are two broadcast float4 loads per input, shared by
//     the whole warp; a row's input value is one conflict-free load reused
//     for all 8 outputs;
//   - a row's activations live in a per-thread column of two shared-memory
//     ping-pong buffers ([feature][row], row stride R+1), so no thread reads
//     another's activations and layers need no barrier;
//   - blocks are persistent (grid = resident blocks, at most one per tile):
//     each stages the weights once and walks over many row tiles;
//   - the ragged last tile is masked (zero inputs, no stores), never padded.
// Limits: at most 8 layers, every width <= 256, and the staged weights plus a
// 32-row activation tile must fit the block's shared memory (227 KB).
// The C entry point returns cudaGetLastError() after the launch, or -1 when
// the chain does not fit shared memory.

#include <cuda_runtime.h>
#include <stddef.h>

#define MLP_MAX_LAYERS 8
#define MLP_MAX_WIDTH 256

struct MLPArgs {
  const float* w[MLP_MAX_LAYERS];  // (out, in) row-major: nn.Linear's layout
  const float* b[MLP_MAX_LAYERS];  // (out,)
  int dims[MLP_MAX_LAYERS + 1];
  int n_layers;
};

__host__ __device__ static inline int pad4(int n) { return (n + 3) & ~3; }

// Floats of staged weights and biases, and the widest activation column
// (input and hidden widths; the output goes straight to device memory).
__host__ __device__ static inline void mlp_layout(const int* dims, int n_layers,
                                                   int* weight_floats, int* max_width) {
  int off = 0;
  int maxw = dims[0];
  for (int l = 0; l < n_layers; ++l) {
    const int dp = pad4(dims[l + 1]);
    off += dims[l] * dp + dp;
    if (l + 1 < n_layers && dims[l + 1] > maxw) maxw = dims[l + 1];
  }
  *weight_floats = off;
  *max_width = maxw;
}

static size_t mlp_smem_bytes(const int* dims, int n_layers, int rows) {
  int wf, maxw;
  mlp_layout(dims, n_layers, &wf, &maxw);
  return sizeof(float) * ((size_t)wf + 2 * (size_t)maxw * (size_t)(rows + 1));
}

// acc[q] = b[j0+q] + sum_k h[k] * W[j0+q][k] for q < JB, over this thread's row.
template <int JB>
__device__ __forceinline__ void dense_group(const float* __restrict__ cur, int rs, int tid,
                                            int din, const float* __restrict__ wt,
                                            const float* __restrict__ bias, int dp, int j0,
                                            float (&acc)[JB]) {
#pragma unroll
  for (int q = 0; q < JB; q += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + j0 + q);
    acc[q] = b4.x;
    acc[q + 1] = b4.y;
    acc[q + 2] = b4.z;
    acc[q + 3] = b4.w;
  }
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const float h = cur[k * rs + tid];
    const float* wrow = wt + k * dp + j0;
#pragma unroll
    for (int q = 0; q < JB; q += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wrow + q);
      acc[q] = fmaf(h, w4.x, acc[q]);
      acc[q + 1] = fmaf(h, w4.y, acc[q + 1]);
      acc[q + 2] = fmaf(h, w4.z, acc[q + 2]);
      acc[q + 3] = fmaf(h, w4.w, acc[q + 3]);
    }
  }
}

template <int JB>
__device__ __forceinline__ void emit_group(const float (&acc)[JB], int j0, int dout, bool last,
                                           float* __restrict__ nxt, int rs, int tid,
                                           float* __restrict__ out, int row, int B) {
#pragma unroll
  for (int q = 0; q < JB; ++q) {
    const int j = j0 + q;
    if (j < dout) {
      if (!last) {
        const float v = acc[q];
        nxt[j * rs + tid] = v < 0.f ? 0.f : v;  // relu; NaN passes through as in torch
      } else if (row < B) {
        out[(size_t)row * dout + j] = acc[q];
      }
    }
  }
}

__global__ void fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                                 MLPArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int R = blockDim.x;
  const int rs = R + 1;
  const int tid = threadIdx.x;

  // Stage every layer's W (transposed to (in, out_pad4)) and b (padded) once.
  int off = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1], dp = pad4(dout);
    float* wt = smem + off;
    const float* w = a.w[l];
    for (int i = tid; i < din * dp; i += R) {
      const int k = i / dp, j = i - k * dp;
      wt[i] = j < dout ? w[j * din + k] : 0.f;
    }
    off += din * dp;
    for (int j = tid; j < dp; j += R) smem[off + j] = j < dout ? a.b[l][j] : 0.f;
    off += dp;
  }
  int wf, maxw;
  mlp_layout(a.dims, a.n_layers, &wf, &maxw);
  float* act0 = smem + wf;
  float* act1 = act0 + maxw * rs;

  const int D = a.dims[0];
  const int n_tiles = (B + R - 1) / R;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * R;
    const int rows = min(R, B - r0);
    __syncthreads();  // weights staged; the previous tile's input reads are done
    const float* xt = x + (size_t)r0 * D;
    for (int i = tid; i < R * D; i += R) {  // coalesced read of the row tile
      const int r = i / D, k = i - r * D;
      act0[k * rs + r] = r < rows ? xt[i] : 0.f;
    }
    __syncthreads();

    const int row = r0 + tid;
    float* cur = act0;
    float* nxt = act1;
    int woff = 0;
    for (int l = 0; l < a.n_layers; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1], dp = pad4(dout);
      const float* wt = smem + woff;
      const float* bias = wt + din * dp;
      woff += din * dp + dp;
      const bool last = l == a.n_layers - 1;
      int j0 = 0;
      for (; j0 + 8 <= dp; j0 += 8) {
        float acc[8];
        dense_group<8>(cur, rs, tid, din, wt, bias, dp, j0, acc);
        emit_group<8>(acc, j0, dout, last, nxt, rs, tid, out, row, B);
      }
      if (j0 < dp) {  // dp is a multiple of 4: one group of 4 is left
        float acc[4];
        dense_group<4>(cur, rs, tid, din, wt, bias, dp, j0, acc);
        emit_group<4>(acc, j0, dout, last, nxt, rs, tid, out, row, B);
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

extern "C" int fused_mlp_forward(const void* x, void* out, int B, int n_layers, const int* dims,
                                 const void* const* w, const void* const* b, void* stream) {
  if (n_layers < 1 || n_layers > MLP_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  MLPArgs a;
  a.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > MLP_MAX_WIDTH) return (int)cudaErrorInvalidValue;
    a.dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
  }
  if (B <= 0) return 0;

  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int rows = 0;
  size_t smem = 0;
  for (int r = 128; r >= 32; r /= 2) {
    smem = mlp_smem_bytes(dims, n_layers, r);
    if (smem <= (size_t)optin) {
      rows = r;
      break;
    }
  }
  if (rows == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_kernel, rows, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const int tiles = (B + rows - 1) / rows;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  fused_mlp_kernel<<<grid, rows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), B, a);
  return (int)cudaGetLastError();
}
