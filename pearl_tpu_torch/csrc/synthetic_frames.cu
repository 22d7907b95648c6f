// SyntheticAtari's frames of one vector step, with auto-reset, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the frame generator to XLA,
// which fuses it. Eager PyTorch does not: `SyntheticAtari._obs` builds a
// (B, H, W, F) float32 grid through four broadcast adds, a `sin` and a cast,
// and an auto-resetting vector step runs it twice (the terminal frames and a
// fresh reset for every env) and then a `where`. This kernel writes both of
// the step's frame batches in one pass and keeps nothing in float32 in
// device memory:
//
//   obs[b]      = frame(phase[b], t[b] + 1)
//   next_obs[b] = frame(fresh_phase[b], 0) where done[b], else obs[b]
//   frame(p, s)[(h * W + w) * F + f] =
//       sin((((p + 0.11 h) + 0.07 w) + 0.5 f) + 0.31 s), rounded to the output type
//
// Arithmetic, bit for bit PyTorch's: each product and sum in float32 in the
// order `_obs` writes it, through __fmul_rn / __fadd_rn so that nothing is
// contracted into an FMA; the constants are the Python doubles cast to
// float, as PyTorch casts a scalar operand; `sinf` without fast math (what
// `torch.sin` calls for float32); one round to nearest even into bfloat16.
//
// Bound on an H100: bytes written. At B = 16384, 84 x 84 x 1 bf16 the two
// outputs are 2 x 231 MB, 0.138 ms at 3.35 TB/s; the inputs are 13 bytes an
// env. The sines, about one an output pair (only done rows compute a second
// frame), are some 116 M a step, which the stores hide. Design: a block per
// env row; thread 0 stages the row's four scalars in shared memory; each
// thread then computes a run of VEC consecutive elements (VEC = 16 bytes of
// output: 8 bf16 or 4 float32), walking (h, w, f) incrementally (integer
// division by W and F would cost about as much as a sine), and stores the
// run once or twice as one 16-byte word. Rows whose length is not a
// multiple of VEC, or outputs not 16-byte aligned, take the same body at
// VEC = 1. Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

// `out_dtype` codes, shared with ops/synthetic_frames.py.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// An element's (h, w, f), held as floats: whole numbers below 2^24 are exact
// in float32, so stepping by 1.0f gives what a conversion would, without one.
struct Coord {
  float h, w, f;
};

__device__ __forceinline__ float frame_value(float phase, float s_term, Coord c) {
  // (((phase + 0.11 h) + 0.07 w) + 0.5 f) + 0.31 s, each step rounded.
  const float a_h = __fmul_rn(static_cast<float>(0.11), c.h);
  const float a_w = __fmul_rn(static_cast<float>(0.07), c.w);
  const float a_f = __fmul_rn(static_cast<float>(0.5), c.f);
  float x = __fadd_rn(phase, a_h);
  x = __fadd_rn(x, a_w);
  x = __fadd_rn(x, a_f);
  x = __fadd_rn(x, s_term);
  return sinf(x);
}

__device__ __forceinline__ void advance(Coord& c, float W, float F) {
  c.f += 1.0f;
  if (c.f == F) {
    c.f = 0.0f;
    c.w += 1.0f;
    if (c.w == W) {
      c.w = 0.0f;
      c.h += 1.0f;
    }
  }
}

template <typename OutT, int VEC>
struct alignas(sizeof(OutT) * VEC) Run {
  OutT v[VEC];
};

template <typename OutT, int VEC>
__device__ __forceinline__ void store_run(OutT* dst, const Run<OutT, VEC>& r) {
  if constexpr (VEC == 1) {
    dst[0] = r.v[0];
  } else {
    static_assert(sizeof(Run<OutT, VEC>) == 16, "a run is one 16-byte word");
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&r);
  }
}

__device__ __forceinline__ void put(float& dst, float x) { dst = x; }
__device__ __forceinline__ void put(__nv_bfloat16& dst, float x) { dst = __float2bfloat16_rn(x); }

template <typename OutT, int VEC>
__device__ __forceinline__ Run<OutT, VEC> make_run(float phase, float s_term, Coord c, float W,
                                                   float F) {
  Run<OutT, VEC> r;
  if (F == 1.0f) {
    // One frame an env (the pixel cells): f is 0, and its term adds +0, which
    // leaves every sum as it is (the partial sum is never -0: phase + 0.11 h
    // rounds a zero sum to +0). Without the f walk and that term the kernel
    // runs a sixth fewer instructions, and it is bound by instruction
    // throughput nearly as much as by its stores (0.197 -> 0.173 ms at
    // 16384 x 84 x 84 bf16, H100).
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = __fadd_rn(phase, __fmul_rn(static_cast<float>(0.11), c.h));
      x = __fadd_rn(x, __fmul_rn(static_cast<float>(0.07), c.w));
      put(r.v[j], sinf(__fadd_rn(x, s_term)));
      c.w += 1.0f;
      if (c.w == W) {
        c.w = 0.0f;
        c.h += 1.0f;
      }
    }
    return r;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    put(r.v[j], frame_value(phase, s_term, c));
    advance(c, W, F);
  }
  return r;
}

template <typename OutT, int VEC>
__global__ void __launch_bounds__(kThreads)
    synthetic_frames_kernel(const float* __restrict__ phase, const int* __restrict__ t,
                            const float* __restrict__ fresh_phase,
                            const bool* __restrict__ done, OutT* __restrict__ obs,
                            OutT* __restrict__ next_obs, int W, int F, long long row) {
  __shared__ float s_phase, s_fresh;
  __shared__ int s_t;
  __shared__ bool s_done;
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) {
    s_phase = phase[b];
    s_t = t[b];
    s_fresh = fresh_phase[b];
    s_done = done[b];
  }
  __syncthreads();
  const float p = s_phase;
  const float step_term = __fmul_rn(static_cast<float>(0.31), static_cast<float>(s_t + 1));
  const float fresh = s_fresh;
  const float reset_term = __fmul_rn(static_cast<float>(0.31), 0.0f);
  const bool is_done = s_done;

  OutT* obs_row = obs + b * row;
  OutT* next_row = next_obs + b * row;
  const int HWF = static_cast<int>(row);
  const float Wf = static_cast<float>(W), Ff = static_cast<float>(F);
  // The thread's first element as (h, w, f), and the loop's stride as the
  // same: each iteration adds the stride with one carry into w and one into
  // h, so that no iteration divides.
  constexpr int kStride = kThreads * VEC;
  int e = threadIdx.x * VEC;
  int f = e % F, w = (e / F) % W, h = e / F / W;
  const int df = kStride % F, dw = (kStride / F) % W, dh = kStride / F / W;
  for (; e < HWF; e += kStride) {
    const Coord c{static_cast<float>(h), static_cast<float>(w), static_cast<float>(f)};
    f += df;
    w += dw + (f >= F);
    f -= f >= F ? F : 0;
    h += dh + (w >= W);
    w -= w >= W ? W : 0;
    const Run<OutT, VEC> r = make_run<OutT, VEC>(p, step_term, c, Wf, Ff);
    store_run<OutT, VEC>(obs_row + e, r);
    if (is_done) {
      store_run<OutT, VEC>(next_row + e, make_run<OutT, VEC>(fresh, reset_term, c, Wf, Ff));
    } else {
      store_run<OutT, VEC>(next_row + e, r);
    }
  }
}

template <typename OutT>
int launch(const float* phase, const int* t, const float* fresh_phase, const bool* done, void* obs,
           void* next_obs, long long B, int H, int W, int F, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(OutT);
  const long long row = static_cast<long long>(H) * W * F;
  const bool aligned = row % kVec == 0 && reinterpret_cast<uintptr_t>(obs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(next_obs) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(B));
  auto* o = static_cast<OutT*>(obs);
  auto* n = static_cast<OutT*>(next_obs);
  if (aligned) {
    synthetic_frames_kernel<OutT, kVec>
        <<<grid, kThreads, 0, stream>>>(phase, t, fresh_phase, done, o, n, W, F, row);
  } else {
    synthetic_frames_kernel<OutT, 1>
        <<<grid, kThreads, 0, stream>>>(phase, t, fresh_phase, done, o, n, W, F, row);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int synthetic_frames(const void* phase, const void* t, const void* fresh_phase,
                                const void* done, void* obs, void* next_obs, long long B, int H,
                                int W, int F, int out_dtype, void* stream) {
  if (phase == nullptr || t == nullptr || fresh_phase == nullptr || done == nullptr ||
      obs == nullptr || next_obs == nullptr || B < 1 || B > INT_MAX || H < 1 || W < 1 || F < 1 ||
      static_cast<long long>(H) * W * F > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(phase);
  const auto* ti = static_cast<const int*>(t);
  const auto* fp = static_cast<const float*>(fresh_phase);
  const auto* d = static_cast<const bool*>(done);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBFloat16)
    return launch<__nv_bfloat16>(p, ti, fp, d, obs, next_obs, B, H, W, F, s);
  if (out_dtype == kFloat32) return launch<float>(p, ti, fp, d, obs, next_obs, B, H, W, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
