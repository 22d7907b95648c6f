"""SyntheticAtari's frames of one auto-resetting vector step in one pass.

Replaces no TPU kernel: the JAX package's XLA fuses the frame generator, and
eager PyTorch runs it as separate float32 passes. A CUDA C++ kernel written
by hand for Hopper (`csrc/synthetic_frames.cu`, built for sm_90a by
`ops/_build.py` and bound with `ctypes`):

    synthetic_frames(phase, t, fresh_phase, done, H=, W=, frames=, dtype=)
        -> (obs, next_obs), each (B, H * W * frames) in `dtype`:
        obs[b]      the frame at (phase[b], t[b] + 1), the step's terminal frame
        next_obs[b] the frame at (fresh_phase[b], 0) where done[b], else obs[b]

A frame is `SyntheticAtari._obs`'s: `sin(phase + 0.11 h + 0.07 w + 0.5 f +
0.31 t)` summed in float32 in that order, in (h, w, f) order with f
innermost, rounded once to `dtype` (bfloat16 or float32). The kernel does
the same float32 operations as PyTorch's kernels, so the frames are equal
bit for bit to two `_obs` calls and a `where`.

What bounds it on an H100: the bytes written, two (B, H*W*frames) outputs
(462 MB at B = 16384, 84 x 84 x 1 bfloat16: 0.138 ms at 3.35 TB/s). What it
replaces held four float32 grids of that size and a where in device memory.

Dispatch: CUDA inputs launch the kernel (or raise), CPU inputs run the plain
version (`synthetic_frames_reference`). Nothing falls back.
`synthetic_frames.launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pearl_tpu_torch.ops._build import load_library, on_card
from pearl_tpu_torch.utils import profiling

# The kernel's `out_dtype` codes (csrc/synthetic_frames.cu).
_OUT_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _grid(phase: torch.Tensor, t: torch.Tensor, H: int, W: int, frames: int,
          dtype: torch.dtype) -> torch.Tensor:
    device = phase.device
    h = torch.arange(H, dtype=torch.float32, device=device)[None, :, None, None]
    w = torch.arange(W, dtype=torch.float32, device=device)[None, None, :, None]
    f = torch.arange(frames, dtype=torch.float32, device=device)[None, None, None, :]
    p = phase[:, None, None, None]
    s = t.to(torch.float32)[:, None, None, None]
    grid = torch.sin(p + 0.11 * h + 0.07 * w + 0.5 * f + 0.31 * s).to(dtype)
    return grid.reshape(grid.shape[0], -1)


def synthetic_frames_reference(
    phase: torch.Tensor, t: torch.Tensor, fresh_phase: torch.Tensor, done: torch.Tensor,
    *, H: int, W: int, frames: int, dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: the terminal frames at (phase, t + 1), the fresh ones at
    (fresh_phase, 0), and `where(done, fresh, terminal)`."""
    obs = _grid(phase, t + 1, H, W, frames, dtype)
    fresh = _grid(fresh_phase, torch.zeros_like(t), H, W, frames, dtype)
    return obs, torch.where(done[:, None], fresh, obs)


def _check(phase, t, fresh_phase, done, H, W, frames, dtype) -> None:
    B = phase.shape[0] if phase.dim() == 1 else -1
    for arg, x, want in (("phase", phase, torch.float32), ("t", t, torch.int32),
                         ("fresh_phase", fresh_phase, torch.float32), ("done", done, torch.bool)):
        if x.shape != (B,) or x.dtype != want:
            raise TypeError(f"synthetic_frames: {arg} must be (B,) {want}, got "
                            f"{tuple(x.shape)} {x.dtype} (phase {tuple(phase.shape)})")
        if x.device != phase.device:
            raise ValueError(f"synthetic_frames: {arg} is on {x.device}, phase on {phase.device}")
        if not x.is_contiguous():
            raise ValueError(f"synthetic_frames: {arg} must be contiguous")
    if min(H, W, frames) < 1:
        raise ValueError(f"synthetic_frames: H, W and frames must be positive, got {H}, {W}, "
                         f"{frames}")
    if dtype not in _OUT_DTYPE:
        raise TypeError(f"synthetic_frames: dtype must be float32 or bfloat16, got {dtype}")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("synthetic_frames")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.synthetic_frames.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.synthetic_frames.restype = ctypes.c_int
    return lib


def synthetic_frames(
    phase: torch.Tensor, t: torch.Tensor, fresh_phase: torch.Tensor, done: torch.Tensor,
    *, H: int, W: int, frames: int, dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A vector step's (obs, next_obs) frames with auto-reset.

    phase, fresh_phase: (B,) float32; t: (B,) int32, the step count before
    the step; done: (B,) bool. Returns two contiguous (B, H*W*frames)
    tensors of `dtype` (bfloat16 or float32)."""
    with profiling.span("op.synthetic_frames"):
        _check(phase, t, fresh_phase, done, H, W, frames, dtype)
        if not on_card("synthetic_frames", phase):
            return synthetic_frames_reference(
                phase, t, fresh_phase, done, H=H, W=W, frames=frames, dtype=dtype)
        B = phase.shape[0]
        obs = torch.empty((B, H * W * frames), dtype=dtype, device=phase.device)
        next_obs = torch.empty_like(obs)
        if B == 0:
            return obs, next_obs
        with torch.cuda.device(phase.device):
            stream = torch.cuda.current_stream(phase.device).cuda_stream
            err = _kernel_lib().synthetic_frames(
                phase.data_ptr(), t.data_ptr(), fresh_phase.data_ptr(), done.data_ptr(),
                obs.data_ptr(), next_obs.data_ptr(), B, H, W, frames, _OUT_DTYPE[dtype], stream,
            )
        if err != 0:
            raise RuntimeError(f"synthetic_frames kernel launch failed: CUDA error {err}")
        synthetic_frames.launches += 1
        return obs, next_obs


synthetic_frames.launches = 0
