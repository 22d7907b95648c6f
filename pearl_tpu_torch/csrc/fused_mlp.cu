// Fused relu-MLP forward for Hopper (sm_90a): x@W1^T+b1 -> relu -> ... -> @Wn^T+bn.
//
// Replaces the TPU kernel `_pallas_forward` in pearl_tpu/ops/fused_mlp.py.
// Computes what it computes (the whole chain in one kernel, activations never
// written to device memory), not a block-by-block copy of it.
//
// Bound on an H100 at the DQN act shape (B = 131072, 4 -> 64 -> 64 -> 2):
// x plus the output is 3 MB, about 1 us at 3.35 TB/s, while the chain is
// 2*B*(4*64 + 64*64 + 64*2) ~= 1.17 GFLOP of float32 on the CUDA cores
// (67 TFLOP/s, ~17 us). So the kernel is bound by operations: by the FMA
// pipe's instruction slots and by the shared-memory loads that feed them. The
// tolerance (1e-5 against a full-float32 chain) rules out plain TF32 `mma`.
// At the learn shape (B = 1024) the work is 9 MFLOP and the time is latency:
// what counts is how many SMs take part and how long one row's chain is.
//
// Three bodies; `mlp_pick_body` chooses (a pure function of B, the widths, the
// SM count and the shared memory a block may use; the Python wrapper mirrors
// it as `pick_body`):
//
//   MLP_BODY_ROWS   B <= 32 * SMs, any widths. A warp carries two rows; the 16
//     lanes of a row split its outputs, 4 each (columns 4q + 64m), so B = 1024
//     makes 128 blocks of 4 warps and a row's chain is 16 times shorter than
//     with one thread per row. Where the weights fit 96 KB (and every input
//     width is a multiple of 4) the block first copies them to shared memory
//     as they lie, all loads in flight at once: one trip to L2 instead of one
//     per unrolled batch of every layer. No block-wide barrier after that: a
//     row's activations ping-pong between two shared-memory vectors that only
//     its own half-warp touches.
//
//   MLP_BODY_TILED  larger B, every width after the first <= 64. A block of
//     4 warps carries 256 rows. Each thread holds a register tile of 8 rows
//     (4*lane .. 4*lane+3 and the same 128 further on) by CT output columns
//     (CT = 16, 8 or 4 by the layer's width; warp w owns columns [w*CT,
//     (w+1)*CT)), so per input feature two float4 loads of its rows'
//     activations (conflict-free, the tile is [feature][row]) and CT/4
//     broadcast float4 weight loads feed 8*CT FMAs: 6 loads per 128 FMAs where
//     one thread per row needed 48. Shared memory returns 128 bytes a cycle
//     whether a load is a broadcast or not, so what counts is registers
//     loaded per FMA, and 8 x 16 is the smallest tile that leaves the FMA pipe
//     the limit. A thread holds all its outputs of a layer before it stores
//     any, so the activation tile is ONE buffer rewritten in place between
//     two barriers: 64 KB at width 64 beside 19 KB of staged weights, two
//     blocks an SM. A layer of at most 4 outputs splits the rows over the
//     warps instead (`tl_layer_narrow`). Blocks are persistent and stage the
//     weights once (transposed, with 16-byte loads along the input dimension).
//     The 128 accumulators leave no registers to spare: fetching the next
//     input tile ahead into registers made the kernel slower.
//
//   MLP_BODY_GENERAL  larger B with a width above 64: one thread per row,
//     8 outputs at a time, ping-pong activation columns (the first design).
//
// Every body masks the ragged last tile (zero inputs, no stores). Limits: at
// most 8 layers, every width <= 256. The C entry point returns
// cudaGetLastError() after the launch, or -1 when no body fits shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define MLP_MAX_LAYERS 8
#define MLP_MAX_WIDTH 256

#define MLP_BODY_ROWS 0
#define MLP_BODY_TILED 1
#define MLP_BODY_GENERAL 2

#define ROWS_WARPS 4          // warps per block of the rows body, 2 rows each
#define ROWS_PER_SM 32        // the rows body takes B <= ROWS_PER_SM * SMs
#define TL_RL 8               // rows a lane of the tiled body (4 or 8)
#define TL_ROWS (32 * TL_RL)  // rows per tile of the tiled body
#define TL_THREADS 128
#define TL_MAX_WIDTH 64       // widest layer output of the tiled body
#define TL_MIN_BLOCKS 2       // resident blocks an SM the tiled body is compiled for
#define TL_UNROLL 2           // input features per trip of the tiled body's inner loop
#define ROWS_STAGE_BYTES (96 * 1024)  // the rows body stages weights up to this size

struct MLPArgs {
  const float* w[MLP_MAX_LAYERS];  // (out, in) row-major: nn.Linear's layout
  const float* b[MLP_MAX_LAYERS];  // (out,)
  int dims[MLP_MAX_LAYERS + 1];
  int n_layers;
};

__host__ __device__ static inline int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;  // NaN passes through as in torch
}

// ---------------------------------------------------------------- rows body

// Floats of the rows body's staged weights: every W as it lies in device
// memory, (out, in), each row padded by 4 floats (so that the 8 lanes of a
// 16-byte load phase fall on different banks), then b.
__host__ __device__ static inline long long rows_stage_floats(const int* dims, int n_layers) {
  long long n = 0;
  for (int l = 0; l < n_layers; ++l) {
    n += (long long)dims[l + 1] * (dims[l] + 4) + pad4(dims[l + 1]);
  }
  return n;
}

// Whether the rows body stages the weights in shared memory (the 16-byte
// loads need every input width a multiple of 4).
static bool rows_staged(const int* dims, int n_layers) {
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] & 3) return false;
  }
  return rows_stage_floats(dims, n_layers) * 4 <= ROWS_STAGE_BYTES;
}

// STAGED: the block first copies every W and b into shared memory with all its
// loads in flight at once, then runs the chains from there. Otherwise the
// weights are read from device memory (L1/L2) as they are needed.
template <bool STAGED>
__global__ void __launch_bounds__(ROWS_WARPS * 32)
fused_mlp_rows_kernel(const float* __restrict__ x, float* __restrict__ out, int B, MLPArgs a) {
  __shared__ __align__(16) float act[ROWS_WARPS][2][2][MLP_MAX_WIDTH];
  extern __shared__ __align__(16) float wsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, q = lane & 15;
  const long long row = ((long long)blockIdx.x * ROWS_WARPS + warp) * 2 + half;
  const bool live = row < B;
  float* cur = act[warp][0][half];
  float* nxt = act[warp][1][half];

  const int D = a.dims[0];
  for (int k = q; k < D; k += 16) cur[k] = live ? x[row * D + k] : 0.f;
  if (STAGED) {
    int off = 0;
    for (int l = 0; l < a.n_layers; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1], st = din + 4, d4 = din >> 2;
      const float4* w4 = reinterpret_cast<const float4*>(a.w[l]);
      const bool aligned = (reinterpret_cast<uintptr_t>(a.w[l]) & 15) == 0;
      for (int i = threadIdx.x; i < dout * d4; i += ROWS_WARPS * 32) {
        const int j = i / d4, k4 = i - j * d4;
        float4 v;
        if (aligned) {
          v = __ldg(w4 + i);
        } else {
          const float* p = a.w[l] + (size_t)i * 4;
          v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
        }
        *reinterpret_cast<float4*>(wsm + off + j * st + 4 * k4) = v;
      }
      off += dout * st;
      for (int j = threadIdx.x; j < dout; j += ROWS_WARPS * 32) wsm[off + j] = __ldg(a.b[l] + j);
      off += pad4(dout);
    }
    __syncthreads();
  } else {
    __syncwarp();
  }

  int woff = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1];
    const int st = STAGED ? din + 4 : din;
    const float* __restrict__ w = STAGED ? wsm + woff : a.w[l];
    const float* __restrict__ bias = STAGED ? w + dout * st : a.b[l];
    woff += dout * st + pad4(dout);
    const bool last = l == a.n_layers - 1;
    const bool vec = STAGED || ((din & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0);
    for (int j0 = 4 * q; j0 < dout; j0 += 64) {
      float acc[4];
      const float* wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = min(j0 + i, dout - 1);  // a clamped column is computed and dropped
        acc[i] = bias[j];
        wr[i] = w + (size_t)j * st;
      }
      if (vec) {
#pragma unroll 4
        for (int k = 0; k < din; k += 4) {
          const float4 h = *reinterpret_cast<const float4*>(cur + k);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w4 = *reinterpret_cast<const float4*>(wr[i] + k);
            acc[i] = fmaf(h.x, w4.x, acc[i]);
            acc[i] = fmaf(h.y, w4.y, acc[i]);
            acc[i] = fmaf(h.z, w4.z, acc[i]);
            acc[i] = fmaf(h.w, w4.w, acc[i]);
          }
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < din; ++k) {
          const float h = cur[k];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = fmaf(h, wr[i][k], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i;
        if (j < dout) {
          if (!last) {
            nxt[j] = relu(acc[i]);
          } else if (live) {
            out[row * dout + j] = acc[i];
          }
        }
      }
    }
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// --------------------------------------------------------------- tiled body

// Output columns per thread for a layer of `dout` outputs, so that 4 warps
// cover the layer in one pass, and the staged weight rows' stride: dout
// rounded up to whole column tiles (the padding is zero).
__host__ __device__ static inline int tl_ct(int dout) {
  const int dp = pad4(dout);
  return dp > 32 ? 16 : dp > 16 ? 8 : 4;
}
__host__ __device__ static inline int tl_stride(int dout) {
  const int ct = tl_ct(dout);
  return (dout + ct - 1) / ct * ct;
}

// Floats of staged weights and biases, and the widest activation the tile
// holds (the input and every hidden width; the output goes to device memory).
__host__ __device__ static inline void tl_layout(const int* dims, int n_layers,
                                                  int* weight_floats, int* max_width) {
  int off = 0, maxw = dims[0];
  for (int l = 0; l < n_layers; ++l) {
    const int st = tl_stride(dims[l + 1]);
    off += dims[l] * st + st;
    if (l + 1 < n_layers && dims[l + 1] > maxw) maxw = dims[l + 1];
  }
  *weight_floats = off;
  *max_width = maxw;
}

static size_t tl_smem_bytes(const int* dims, int n_layers) {
  int wf, maxw;
  tl_layout(dims, n_layers, &wf, &maxw);
  return sizeof(float) * ((size_t)wf + (size_t)maxw * TL_ROWS);
}

// One layer for the block's TL_ROWS rows. Every thread of the block calls it
// (the barriers are unconditional); a warp whose columns lie beyond the layer
// only waits. A lane holds RL = TL_RL rows, in groups of 4 adjacent ones
// (rows 128*i + 4*lane .. + 3), by CT columns.
template <int CT>
__device__ __forceinline__ void tl_layer(float* __restrict__ act, const float* __restrict__ wt,
                                         const float* __restrict__ bias, int din, int dout,
                                         int wstride, bool last, float* __restrict__ out,
                                         long long r0, int B, int warp, int lane) {
  constexpr int RG = TL_RL / 4;  // groups of 4 rows a lane
  const int j0 = warp * CT;
  const bool active = j0 < wstride;
  float acc[RG][4][CT];
  if (active) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float bj = bias[j0 + c];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r][c] = bj;
      }
    }
    const float* ap = act + 4 * lane;
    const float* wp = wt + j0;
    constexpr int kUnroll = TL_UNROLL;
#pragma unroll kUnroll
    for (int k = 0; k < din; ++k) {
      float4 h[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        h[i] = *reinterpret_cast<const float4*>(ap + k * TL_ROWS + 128 * i);
      }
#pragma unroll
      for (int c = 0; c < CT; c += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp + k * wstride + c);
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          acc[i][0][c] = fmaf(h[i].x, w4.x, acc[i][0][c]);
          acc[i][0][c + 1] = fmaf(h[i].x, w4.y, acc[i][0][c + 1]);
          acc[i][0][c + 2] = fmaf(h[i].x, w4.z, acc[i][0][c + 2]);
          acc[i][0][c + 3] = fmaf(h[i].x, w4.w, acc[i][0][c + 3]);
          acc[i][1][c] = fmaf(h[i].y, w4.x, acc[i][1][c]);
          acc[i][1][c + 1] = fmaf(h[i].y, w4.y, acc[i][1][c + 1]);
          acc[i][1][c + 2] = fmaf(h[i].y, w4.z, acc[i][1][c + 2]);
          acc[i][1][c + 3] = fmaf(h[i].y, w4.w, acc[i][1][c + 3]);
          acc[i][2][c] = fmaf(h[i].z, w4.x, acc[i][2][c]);
          acc[i][2][c + 1] = fmaf(h[i].z, w4.y, acc[i][2][c + 1]);
          acc[i][2][c + 2] = fmaf(h[i].z, w4.z, acc[i][2][c + 2]);
          acc[i][2][c + 3] = fmaf(h[i].z, w4.w, acc[i][2][c + 3]);
          acc[i][3][c] = fmaf(h[i].w, w4.x, acc[i][3][c]);
          acc[i][3][c + 1] = fmaf(h[i].w, w4.y, acc[i][3][c + 1]);
          acc[i][3][c + 2] = fmaf(h[i].w, w4.z, acc[i][3][c + 2]);
          acc[i][3][c + 3] = fmaf(h[i].w, w4.w, acc[i][3][c + 3]);
        }
      }
    }
  }
  if (!last) {
    __syncthreads();  // every warp has read the layer's input
    if (active) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if (j0 + c < dout) {
#pragma unroll
          for (int i = 0; i < RG; ++i) {
            *reinterpret_cast<float4*>(act + (j0 + c) * TL_ROWS + 128 * i + 4 * lane) =
                make_float4(relu(acc[i][0][c]), relu(acc[i][1][c]), relu(acc[i][2][c]),
                            relu(acc[i][3][c]));
          }
        }
      }
    }
    __syncthreads();
  } else if (active) {
#pragma unroll
    for (int i = 0; i < RG; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = r0 + 128 * i + 4 * lane + r;
        if (row < B) {
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            if (j0 + c < dout) out[row * dout + j0 + c] = acc[i][r][c];
          }
        }
      }
    }
  }
}

// A layer of at most 4 outputs (the Q head of a small action space): one
// column tile would leave three of the four warps idle, and the same warp of
// every resident block shares one scheduler. So the ROWS are split instead:
// warp w takes rows [w * TL_ROWS/4, (w+1) * TL_ROWS/4), a lane TL_RL/4 of
// them, 32 apart (conflict-free scalar loads), with all 4 columns.
__device__ __forceinline__ void tl_layer_narrow(float* __restrict__ act,
                                                const float* __restrict__ wt,
                                                const float* __restrict__ bias, int din, int dout,
                                                int wstride, bool last, float* __restrict__ out,
                                                long long r0, int B, int warp, int lane) {
  constexpr int RN = TL_RL / 4;  // rows a lane
  const int rr = warp * (TL_ROWS / 4) + lane;
  float acc[RN][4];
  const float4 b4 = *reinterpret_cast<const float4*>(bias);
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    acc[i][0] = b4.x;
    acc[i][1] = b4.y;
    acc[i][2] = b4.z;
    acc[i][3] = b4.w;
  }
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const float4 w4 = *reinterpret_cast<const float4*>(wt + k * wstride);
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const float h = act[k * TL_ROWS + rr + 32 * i];
      acc[i][0] = fmaf(h, w4.x, acc[i][0]);
      acc[i][1] = fmaf(h, w4.y, acc[i][1]);
      acc[i][2] = fmaf(h, w4.z, acc[i][2]);
      acc[i][3] = fmaf(h, w4.w, acc[i][3]);
    }
  }
  if (!last) {
    __syncthreads();  // every warp has read the layer's input
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < dout) {
#pragma unroll
        for (int i = 0; i < RN; ++i) act[c * TL_ROWS + rr + 32 * i] = relu(acc[i][c]);
      }
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const long long row = r0 + rr + 32 * i;
      if (row < B) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < dout) out[row * dout + c] = acc[i][c];
        }
      }
    }
  }
}


__global__ void __launch_bounds__(TL_THREADS, TL_MIN_BLOCKS)
fused_mlp_tiled_kernel(const float* __restrict__ x, float* __restrict__ out, int B, MLPArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Stage every layer's W (transposed to (in, stride)) and b (padded) once.
  // Neighbouring threads take neighbouring outputs j, so the transposed stores
  // fall on different banks; each reads 4 consecutive inputs of its row of W
  // with one 16-byte load (single loads when W's rows are not that aligned),
  // several in flight at a time.
  int off = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1], st = tl_stride(dout);
    float* wt = smem + off;
    const float* w = a.w[l];
    if ((din & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
      const int n = (din >> 2) * st;
#pragma unroll 4
      for (int i = tid; i < n; i += TL_THREADS) {
        const int k4 = i / st, j = i - k4 * st;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < dout) v = __ldg(reinterpret_cast<const float4*>(w + (size_t)j * din) + k4);
        wt[(4 * k4) * st + j] = v.x;
        wt[(4 * k4 + 1) * st + j] = v.y;
        wt[(4 * k4 + 2) * st + j] = v.z;
        wt[(4 * k4 + 3) * st + j] = v.w;
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < din * st; i += TL_THREADS) {
        const int k = i / st, j = i - k * st;
        wt[i] = j < dout ? __ldg(w + (size_t)j * din + k) : 0.f;
      }
    }
    off += din * st;
    for (int j = tid; j < st; j += TL_THREADS) smem[off + j] = j < dout ? a.b[l][j] : 0.f;
    off += st;
  }
  float* act = smem + off;  // [feature][row], TL_ROWS rows; off is a multiple of 4

  const int D = a.dims[0];
  const int n_tiles = (B + TL_ROWS - 1) / TL_ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * TL_ROWS;
    const int rows = (int)min((long long)TL_ROWS, B - r0);
    __syncthreads();  // weights staged; the previous tile's last layer has read `act`
    const float* xt = x + r0 * D;
    for (int i = tid; i < TL_ROWS * D; i += TL_THREADS) {  // coalesced read of the row tile
      const int r = i / D, k = i - r * D;
      act[k * TL_ROWS + r] = r < rows ? xt[i] : 0.f;
    }
    __syncthreads();

    int woff = 0;
    for (int l = 0; l < a.n_layers; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1], st = tl_stride(dout);
      const float* wt = smem + woff;
      const float* bias = wt + din * st;
      woff += din * st + st;
      const bool last = l == a.n_layers - 1;
      if (dout <= 4) {
        tl_layer_narrow(act, wt, bias, din, dout, st, last, out, r0, B, warp, lane);
        continue;
      }
      switch (tl_ct(dout)) {
        case 16: tl_layer<16>(act, wt, bias, din, dout, st, last, out, r0, B, warp, lane); break;
        case 8: tl_layer<8>(act, wt, bias, din, dout, st, last, out, r0, B, warp, lane); break;
        default: tl_layer<4>(act, wt, bias, din, dout, st, last, out, r0, B, warp, lane); break;
      }
    }
  }
}

// ------------------------------------------------------------- general body

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

// Rows per block of the general body: the most of 128, 64, 32 whose staged
// weights and two activation tiles fit `optin` bytes; 0 when none does.
static int general_rows(const int* dims, int n_layers, size_t optin) {
  for (int r = 128; r >= 32; r /= 2) {
    if (mlp_smem_bytes(dims, n_layers, r) <= optin) return r;
  }
  return 0;
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
        nxt[j * rs + tid] = relu(acc[q]);
      } else if (row < B) {
        out[(size_t)row * dout + j] = acc[q];
      }
    }
  }
}

__global__ void fused_mlp_general_kernel(const float* __restrict__ x, float* __restrict__ out,
                                         int B, MLPArgs a) {
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

// ------------------------------------------------------------------- entry

// The body for a chain: MLP_BODY_*, or -1 when B is past the rows body and
// neither other body fits `optin` bytes of shared memory. Pure.
static int mlp_pick_body(long long B, int n_layers, const int* dims, int sms, size_t optin) {
  if (B <= (long long)ROWS_PER_SM * sms) return MLP_BODY_ROWS;
  bool narrow = true;
  for (int l = 1; l <= n_layers; ++l) narrow = narrow && dims[l] <= TL_MAX_WIDTH;
  if (narrow && tl_smem_bytes(dims, n_layers) <= optin) return MLP_BODY_TILED;
  if (general_rows(dims, n_layers, optin) > 0) return MLP_BODY_GENERAL;
  return -1;
}

static bool mlp_dims_ok(int n_layers, const int* dims) {
  if (n_layers < 1 || n_layers > MLP_MAX_LAYERS) return false;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > MLP_MAX_WIDTH) return false;
  }
  return true;
}

// The choice alone, for a card with `sms` SMs and `optin` bytes of shared
// memory a block: what `fused_mlp_forward` would launch. -2 for bad widths.
extern "C" int fused_mlp_pick(int B, int n_layers, const int* dims, int sms, int optin) {
  if (!mlp_dims_ok(n_layers, dims)) return -2;
  return mlp_pick_body(B, n_layers, dims, sms, (size_t)optin);
}

// An empty kernel: what one launch costs the card when there is no work, the
// floor under every small-B time.
__global__ void fused_mlp_empty_kernel() {}

extern "C" int fused_mlp_empty_launch(void* stream) {
  fused_mlp_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// What the card's FMA pipes give a kernel like the tiled body at best: 128
// independent float32 accumulators a thread, operands in registers, nothing
// else in the loop. Timed beside the kernel, it says how much of the gap to
// the published peak is the kernel's and how much the card's.
__global__ void __launch_bounds__(128) fused_mlp_fma_probe_kernel(float* out, int iters) {
  float acc[128], h[8], w[16];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = (float)(threadIdx.x + i);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = 1.0f + i;
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 2.0f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = fmaf(h[i & 7], w[i >> 3], acc[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] += 1.0f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// `out` holds blocks * 128 floats; the launch does 2 * blocks * 128 * 128 * iters
// floating-point operations.
extern "C" int fused_mlp_fma_probe(void* out, int blocks, int iters, void* stream) {
  fused_mlp_fma_probe_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

// Grid of a persistent kernel: its resident blocks, at most one per tile.
template <typename Kernel>
static int persistent_grid(Kernel kernel, int threads, size_t smem, int tiles, int sms,
                           cudaError_t* err) {
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (*err != cudaSuccess) return 0;
  int per_sm = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) per_sm = 1;
  return tiles < per_sm * sms ? tiles : per_sm * sms;
}

// `picked` receives the body that was launched (MLP_BODY_*).
extern "C" int fused_mlp_forward(const void* x, void* out, int B, int n_layers, const int* dims,
                                 const void* const* w, const void* const* b, void* stream,
                                 int* picked) {
  if (!mlp_dims_ok(n_layers, dims)) return (int)cudaErrorInvalidValue;
  MLPArgs a;
  a.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) a.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
  }
  if (B <= 0) return 0;

  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int body = mlp_pick_body(B, n_layers, dims, sms, (size_t)optin);
  if (body < 0) return -1;
  if (picked != nullptr) *picked = body;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;

  if (body == MLP_BODY_ROWS) {
    const int rows_per_block = 2 * ROWS_WARPS;
    const int grid = (B + rows_per_block - 1) / rows_per_block;
    if (rows_staged(dims, n_layers)) {
      const size_t smem = (size_t)rows_stage_floats(dims, n_layers) * 4;
      err = cudaFuncSetAttribute(fused_mlp_rows_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      fused_mlp_rows_kernel<true><<<grid, ROWS_WARPS * 32, smem, st>>>(xf, of, B, a);
    } else {
      fused_mlp_rows_kernel<false><<<grid, ROWS_WARPS * 32, 0, st>>>(xf, of, B, a);
    }
  } else if (body == MLP_BODY_TILED) {
    const size_t smem = tl_smem_bytes(dims, n_layers);
    const int tiles = (B + TL_ROWS - 1) / TL_ROWS;
    const int grid = persistent_grid(fused_mlp_tiled_kernel, TL_THREADS, smem, tiles, sms, &err);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_tiled_kernel<<<grid, TL_THREADS, smem, st>>>(xf, of, B, a);
  } else {
    const int rows = general_rows(dims, n_layers, (size_t)optin);
    const size_t smem = mlp_smem_bytes(dims, n_layers, rows);
    const int tiles = (B + rows - 1) / rows;
    const int grid = persistent_grid(fused_mlp_general_kernel, rows, smem, tiles, sms, &err);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_general_kernel<<<grid, rows, smem, st>>>(xf, of, B, a);
  }
  return (int)cudaGetLastError();
}
