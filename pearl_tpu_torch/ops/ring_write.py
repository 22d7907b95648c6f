"""In-place frame-ring slab writes: kernels B2 and B7 of the port.

Replaces the TPU kernels of `pearl_tpu/ops/ring_write.py` with CUDA C++
kernels written by hand for Hopper (`csrc/ring_write.cu`, built for sm_90a by
`ops/_build.py` and bound with `ctypes`):

    ring_write(ring, entry, cursor)            ring[:, cursor, :] <- entry
        (`ring_slab_write_tfb` / the `ring_write` wrapper there)
    ring_write_where(ring, obs, reset, done, cursor)
        ring[:, cursor, :] <- where(done[:, None], reset, obs)
        (`ring_slab_write_where_tfb`)

Both write INTO the ring they are given and return it; the other T-1 slots
are never touched. The ring is a contiguous row-major (B, T, F) tensor (the
reference's (T, F, B) view and (F, B) entries are XLA:TPU layout devices and
are not carried over); sources are (B, F) with unit inner stride and any row
stride. `cursor` is a host integer, passed to the kernel by value.

What bounds them on an H100: bytes. One frame read, one written (2 x 14.45 MB
at B = 1024, F = 7056 bf16, 8.6 us at 3.35 TB/s); the select reads, per row,
only the source it picks. `csrc/row_copy.cuh` has the design.

Dispatch: a CUDA ring launches the kernel (or raises), a CPU ring runs the
plain version (`ring_write_reference`, `ring_write_where_reference`). Nothing
falls back. `ring_write.launches` and `ring_write_where.launches` count
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pearl_tpu_torch.ops._build import load_library, on_card
from pearl_tpu_torch.utils import profiling


def ring_write_reference(ring: torch.Tensor, entry: torch.Tensor, cursor: int) -> torch.Tensor:
    """Plain PyTorch `ring[:, cursor, :] <- entry`, in place; returns `ring`."""
    ring[:, cursor, :].copy_(entry)
    return ring


def ring_write_where_reference(
    ring: torch.Tensor, obs: torch.Tensor, reset: torch.Tensor, done: torch.Tensor, cursor: int
) -> torch.Tensor:
    """Plain PyTorch `ring[:, cursor, :] <- where(done, reset, obs)`, in
    place; returns `ring`."""
    ring[:, cursor, :].copy_(torch.where(done[:, None], reset, obs))
    return ring


def _check(name: str, ring: torch.Tensor, cursor: int, **sources: torch.Tensor) -> None:
    if ring.dim() != 3:
        raise ValueError(f"{name}: ring must be (B, T, F), got shape {tuple(ring.shape)}")
    if not ring.is_contiguous():
        raise ValueError(f"{name}: ring must be contiguous (it is written in place)")
    B, T, F = ring.shape
    if isinstance(cursor, torch.Tensor) or not 0 <= int(cursor) < T:
        raise ValueError(f"{name}: cursor must be a host integer in [0, {T}), got {cursor!r}")
    for arg, t in sources.items():
        if t.shape != (B, F):
            raise ValueError(f"{name}: {arg} must be ({B}, {F}), got shape {tuple(t.shape)}")
        if t.dtype != ring.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the ring is {ring.dtype}")
        if t.device != ring.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the ring on {ring.device}")
        if F > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: {arg} must have unit inner stride, got {t.stride()}")


def _check_done(name: str, ring: torch.Tensor, done: torch.Tensor) -> None:
    if done.shape != (ring.shape[0],) or done.dtype != torch.bool:
        raise TypeError(
            f"{name}: done must be ({ring.shape[0]},) bool, got {tuple(done.shape)} {done.dtype}"
        )
    if done.device != ring.device:
        raise ValueError(f"{name}: done is on {done.device}, the ring on {ring.device}")
    if not done.is_contiguous():
        raise ValueError(f"{name}: done must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("ring_write")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.ring_write.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.ring_write.restype = ctypes.c_int
    lib.ring_write_where.argtypes = [ptr, ptr, i64, ptr, i64, ptr, i64, i64, i64, i64, ptr]
    lib.ring_write_where.restype = ctypes.c_int
    return lib


def ring_write(ring: torch.Tensor, entry: torch.Tensor, cursor: int) -> torch.Tensor:
    """`ring[:, cursor, :] <- entry` in place; returns `ring`.

    ring (B, T, F) contiguous; entry (B, F) of the ring's dtype and device;
    cursor a host integer in [0, T)."""
    with profiling.span("op.ring_write"):
        _check("ring_write", ring, cursor, entry=entry)
        if not on_card("ring_write", ring):
            return ring_write_reference(ring, entry, int(cursor))
        B, T, F = ring.shape
        if B == 0 or F == 0:
            return ring
        size = ring.element_size()
        with torch.cuda.device(ring.device):
            stream = torch.cuda.current_stream(ring.device).cuda_stream
            err = _kernel_lib().ring_write(
                ring.data_ptr(), entry.data_ptr(), entry.stride(0) * size,
                B, T, F * size, int(cursor), stream,
            )
        if err != 0:
            raise RuntimeError(f"ring_write kernel launch failed: CUDA error {err}")
        ring_write.launches += 1
        return ring


ring_write.launches = 0


def ring_write_where(
    ring: torch.Tensor, obs: torch.Tensor, reset: torch.Tensor, done: torch.Tensor, cursor: int
) -> torch.Tensor:
    """`ring[:, cursor, :] <- where(done[:, None], reset, obs)` in place;
    returns `ring`.

    ring (B, T, F) contiguous; obs and reset (B, F) of the ring's dtype and
    device; done (B,) bool; cursor a host integer in [0, T)."""
    with profiling.span("op.ring_write_where"):
        _check("ring_write_where", ring, cursor, obs=obs, reset=reset)
        _check_done("ring_write_where", ring, done)
        if not on_card("ring_write_where", ring):
            return ring_write_where_reference(ring, obs, reset, done, int(cursor))
        B, T, F = ring.shape
        if B == 0 or F == 0:
            return ring
        size = ring.element_size()
        with torch.cuda.device(ring.device):
            stream = torch.cuda.current_stream(ring.device).cuda_stream
            err = _kernel_lib().ring_write_where(
                ring.data_ptr(), obs.data_ptr(), obs.stride(0) * size,
                reset.data_ptr(), reset.stride(0) * size, done.data_ptr(),
                B, T, F * size, int(cursor), stream,
            )
        if err != 0:
            raise RuntimeError(f"ring_write_where kernel launch failed: CUDA error {err}")
        ring_write_where.launches += 1
        return ring


ring_write_where.launches = 0
