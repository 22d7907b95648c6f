"""Copy fence and masked-scale fences: kernels B3, B6a and B6b of the port.

Replaces the TPU kernels of `pearl_tpu/ops/layout_fence.py` with CUDA C++
kernels written by hand for Hopper (`csrc/layout_fence.cu`, built for sm_90a
by `ops/_build.py` and bound with `ctypes`):

    copy_fence(x)                         bit-exact (B, F) copy, any dtype
    masked_scale_fence(ring, valid, div)  ring * valid[..., None] * (1/div),
                                          (B, T, F) in the ring's dtype
    masked_scale_fence4(ring, valid, H=, W=, div=)
                                          the same values as the (B, T, H, W)
                                          NCHW conv input

On the TPU these stop XLA's layout assignment. Here each has a plain job.
`copy_fence` takes the newest frame of the ring, a (B, F) view with row stride
T*F, and materialises the contiguous frame the replay buffer stores, before
the ring is written in place. The masked-scale fences are the one fused pass
that zeroes the frames older than the episode and normalises the pixels for
conv1; `CNNQValueNetwork._q_all_ring` always goes through one of them. The
ring is data, not a differentiated input, so none of them has a backward.

Arithmetic of the fences, exactly the reference's `_fence_kernel`: in
float32, `(x * m) * float32(1 / div)` with m = 0.0 or 1.0 — a reciprocal
multiply, not a divide, and no second multiply at all when div == 1 — then
rounded to the ring's dtype (float32 or bfloat16).

What bounds them on an H100: bytes. copy_fence reads and writes one frame
(2 x 14.45 MB at B = 1024, F = 7056 bf16, 8.6 us at 3.35 TB/s); a fence reads
and writes the whole window (2 x 57.8 MB at T = 4, 34.5 us).
`csrc/layout_fence.cu` has the design.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (`*_reference`). Nothing falls back. Each wrapper's
`.launches` counts its kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pearl_tpu_torch.ops._build import load_library, on_card
from pearl_tpu_torch.utils import profiling

_ELEM = {torch.float32: 0, torch.bfloat16: 1}


def copy_fence_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch contiguous copy of a (B, F) tensor."""
    return x.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _reciprocal(div: float) -> float:
    """float32(1 / div) as a Python float, the constant the kernels multiply by."""
    return torch.tensor(1.0 / div, dtype=torch.float32).item()


def masked_scale_fence_reference(
    ring: torch.Tensor, valid: torch.Tensor, div: float = 255.0
) -> torch.Tensor:
    """Plain PyTorch `(float(ring) * valid[..., None]) * float32(1 / div)`,
    rounded to the ring's dtype; (B, T, F)."""
    y = ring.to(torch.float32) * valid[..., None].to(torch.float32)
    if div != 1.0:
        y = y * _reciprocal(div)
    return y.to(ring.dtype)


def masked_scale_fence4_reference(
    ring: torch.Tensor, valid: torch.Tensor, *, H: int, W: int, div: float = 255.0
) -> torch.Tensor:
    """`masked_scale_fence_reference` shaped (B, T, H, W)."""
    B, T, F = ring.shape
    if F != H * W:
        raise ValueError(f"masked_scale_fence4: F = {F} is not H*W = {H}*{W}")
    return masked_scale_fence_reference(ring, valid, div).reshape(B, T, H, W)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("layout_fence")
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.copy_fence.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.copy_fence.restype = ctypes.c_int
    lib.masked_scale_fence.argtypes = [ptr, ptr, ptr, i64, i64, i64, i32, i32, f32, ptr]
    lib.masked_scale_fence.restype = ctypes.c_int
    lib.masked_scale_fence4.argtypes = [
        ptr, ptr, ptr, i64, i64, i64, i64, i64, i32, i32, f32, ptr
    ]
    lib.masked_scale_fence4.restype = ctypes.c_int
    return lib


def copy_fence(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact contiguous copy of a (B, F) tensor of any dtype with unit
    inner stride and any row stride (such as a ring's newest-frame view)."""
    with profiling.span("op.copy_fence"):
        if x.dim() != 2:
            raise ValueError(f"copy_fence: x must be (B, F), got shape {tuple(x.shape)}")
        if not on_card("copy_fence", x):
            return copy_fence_reference(x)
        B, F = x.shape
        if F > 1 and x.stride(1) != 1:
            raise ValueError(f"copy_fence: x must have unit inner stride, got {x.stride()}")
        out = torch.empty((B, F), dtype=x.dtype, device=x.device)
        if B == 0 or F == 0:
            return out
        size = x.element_size()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _kernel_lib().copy_fence(
                out.data_ptr(), x.data_ptr(), x.stride(0) * size, B, F * size, stream
            )
        if err != 0:
            raise RuntimeError(f"copy_fence kernel launch failed: CUDA error {err}")
        copy_fence.launches += 1
        return out


copy_fence.launches = 0


def _check_fence(name: str, ring: torch.Tensor, valid: torch.Tensor) -> Tuple[int, int, int]:
    if ring.dim() != 3:
        raise ValueError(f"{name}: ring must be (B, T, F), got shape {tuple(ring.shape)}")
    B, T, F = ring.shape
    if ring.dtype not in _ELEM:
        raise TypeError(f"{name}: ring is {ring.dtype}; float32 or bfloat16 required")
    if valid.shape != (B, T) or valid.dtype != torch.bool:
        raise TypeError(
            f"{name}: valid must be ({B}, {T}) bool, got {tuple(valid.shape)} {valid.dtype}"
        )
    if valid.device != ring.device:
        raise ValueError(f"{name}: valid is on {valid.device}, the ring on {ring.device}")
    if not ring.is_contiguous() or not valid.is_contiguous():
        raise ValueError(f"{name}: ring and valid must be contiguous")
    return B, T, F


def masked_scale_fence(
    ring: torch.Tensor, valid: torch.Tensor, div: float = 255.0
) -> torch.Tensor:
    """`ring * valid[..., None] * (1 / div)`, computed in float32 and stored
    in the ring's dtype.

    ring (B, T, F) float32 or bfloat16, contiguous; valid (B, T) bool.
    Returns a new (B, T, F) tensor."""
    with profiling.span("op.masked_scale_fence"):
        B, T, F = _check_fence("masked_scale_fence", ring, valid)
        if not on_card("masked_scale_fence", ring):
            return masked_scale_fence_reference(ring, valid, div)
        out = torch.empty((B, T, F), dtype=ring.dtype, device=ring.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(ring.device):
            stream = torch.cuda.current_stream(ring.device).cuda_stream
            err = _kernel_lib().masked_scale_fence(
                ring.data_ptr(), valid.data_ptr(), out.data_ptr(), B, T, F,
                _ELEM[ring.dtype], int(div != 1.0), _reciprocal(div), stream,
            )
        if err != 0:
            raise RuntimeError(f"masked_scale_fence kernel launch failed: CUDA error {err}")
        masked_scale_fence.launches += 1
        return out


masked_scale_fence.launches = 0


def masked_scale_fence4(
    ring: torch.Tensor, valid: torch.Tensor, *, H: int, W: int, div: float = 255.0
) -> torch.Tensor:
    """`masked_scale_fence` emitting the (B, T, H, W) NCHW conv input; the
    ring's F must equal H * W."""
    with profiling.span("op.masked_scale_fence4"):
        B, T, F = _check_fence("masked_scale_fence4", ring, valid)
        if F != H * W:
            raise ValueError(f"masked_scale_fence4: F = {F} is not H*W = {H}*{W}")
        if not on_card("masked_scale_fence4", ring):
            return masked_scale_fence4_reference(ring, valid, H=H, W=W, div=div)
        out = torch.empty((B, T, H, W), dtype=ring.dtype, device=ring.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(ring.device):
            stream = torch.cuda.current_stream(ring.device).cuda_stream
            err = _kernel_lib().masked_scale_fence4(
                ring.data_ptr(), valid.data_ptr(), out.data_ptr(), B, T, F, H, W,
                _ELEM[ring.dtype], int(div != 1.0), _reciprocal(div), stream,
            )
        if err != 0:
            raise RuntimeError(f"masked_scale_fence4 kernel launch failed: CUDA error {err}")
        masked_scale_fence4.launches += 1
        return out


masked_scale_fence4.launches = 0
