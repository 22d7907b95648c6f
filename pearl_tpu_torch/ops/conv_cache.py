"""Incremental conv1 cache for the visual act path: kernel B4 of the port.

Port of `pearl_tpu/ops/conv_cache.py`. conv1 is linear in its input and its
input channels are the T stacked frames, so

    conv1(window)[b] = sum_s conv(frame_s, K_{p(s)})[b],  p(s) = (s - cursor) % T

(p is frame s's time position in the window, 0 = oldest). One frame enters
the window per step, so the act path caches every resident frame's
contribution under ALL T position kernels, computed once when the frame
arrives, and conv1 of the window becomes a T-term masked sum over cached
slabs: no convolution reads the ring on the act path.

Diagonal rule: entry (j, p) holds the contribution of the frame in ring slot
s = (j + p) % T under kernel position p, that is j = (s - p) % T. At read time
the frame at position p sits in slot (cursor + p) % T, so every entry the
current window needs lies in the single row j == cursor; and a new frame,
written at slot c, scatters its T contributions to rows j = (c - p) % T.

Layout (the port's own; the reference's (T, P, D, B) batch-minor order exists
only for XLA:TPU): the cache is a contiguous row-major (T, P, B, D) tensor
with P = T and D = OC*OH*OW in (OC, OH, OW) order. `F.conv2d` gives the
contrib output y as NCHW (B, T*OC, OH, OW) with channel index p*OC + oc, so
chunk p is `y[:, p*OC:(p+1)*OC]`: B rows of D contiguous elements with row
stride T*D. The write is then T strided row copies, `cache[cursor]` is one
contiguous (P, B, D) slab, and `gather_sum`'s (B, D) result is conv2's NCHW
input (B, OC, OH, OW) with no transpose.

    cache_write(cache, y, cursor, T=, OC=)   cache[(cursor - p) % T, p] <- chunk_p(y)
                                             for p = 0..T-1, IN PLACE, one launch
    gather_sum(cache, valid, cursor)         sum_p valid[:, (cursor + p) % T] * cache[cursor, p]
                                             -> (B, D) float32 (plain PyTorch, as
                                             the reference's is plain jnp)

`cache_write` is a CUDA C++ kernel written by hand for Hopper
(`csrc/conv_cache.cu`, built for sm_90a by `ops/_build.py`, bound with
`ctypes`). What bounds it on an H100: bytes, y read once and T slabs written
once (2 x 52.4 MB at B = 1024, T = 4, D = 6400 bf16: 31.3 us at 3.35 TB/s).

Exactness: contributions are computed with the current conv1 weights, and
`PearlAgent.learn` refreshes the whole cache after every weight update. The
only deviation from the direct conv is the grouping of the float32 sum (T
partial convolutions summed in float32 against one convolution over all
T*k*k taps), so the cached Q agrees with the direct Q to a tolerance, not bit
for bit.

Dispatch: a CUDA cache launches the kernel (or raises), a CPU cache runs the
plain version (`cache_write_reference`). Nothing falls back.
`cache_write.launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pearl_tpu_torch.ops._build import load_library, on_card
from pearl_tpu_torch.utils import profiling


def contrib_chunks(y: torch.Tensor, T: int, OC: int):
    """The T per-position (B, D) chunks of a contrib conv output
    (B, T*OC, OH, OW), D = OC*OH*OW: views when y is contiguous."""
    B = y.shape[0]
    return [y[:, p * OC : (p + 1) * OC].reshape(B, -1) for p in range(T)]


def cache_write_reference(
    cache: torch.Tensor, y: torch.Tensor, cursor: int, *, T: int, OC: int
) -> torch.Tensor:
    """Plain PyTorch `cache[(cursor - p) % T, p] <- chunk_p(y)`: T slice
    assignments, in place; returns `cache`."""
    for p, chunk in enumerate(contrib_chunks(y, T, OC)):
        cache[(cursor - p) % T, p].copy_(chunk)
    return cache


def _check(cache: torch.Tensor, y: torch.Tensor, cursor: int, T: int, OC: int) -> None:
    if cache.dim() != 4 or cache.shape[0] != T or cache.shape[1] != T:
        raise ValueError(f"cache_write: cache must be ({T}, {T}, B, D), got {tuple(cache.shape)}")
    if not cache.is_contiguous():
        raise ValueError("cache_write: cache must be contiguous (it is written in place)")
    B, D = cache.shape[2], cache.shape[3]
    if y.dim() != 4 or y.shape[0] != B or y.shape[1] != T * OC:
        raise ValueError(
            f"cache_write: y must be ({B}, {T * OC}, OH, OW), got shape {tuple(y.shape)}"
        )
    if OC * y.shape[2] * y.shape[3] != D:
        raise ValueError(
            f"cache_write: a chunk of y has {OC}*{y.shape[2]}*{y.shape[3]} elements, "
            f"the cache's D is {D}"
        )
    if isinstance(cursor, torch.Tensor) or not 0 <= int(cursor) < T:
        raise ValueError(f"cache_write: cursor must be a host integer in [0, {T}), got {cursor!r}")
    if y.device != cache.device:
        raise ValueError(f"cache_write: y is on {y.device}, the cache on {cache.device}")


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("conv_cache")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.cache_write.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.cache_write.restype = ctypes.c_int
    return lib


def cache_write(
    cache: torch.Tensor, y: torch.Tensor, cursor: int, *, T: int, OC: int
) -> torch.Tensor:
    """`cache[(cursor - p) % T, p] <- chunk_p(y)` for every position p, in
    place; returns `cache`.

    cache:  (T, T, B, D) diagonal contribution cache, contiguous
    y:      (B, T*OC, OH, OW) contrib conv output of the new frame (the frame
            the ring write just placed at slot `cursor`), D = OC*OH*OW; each
            batch row's T*D elements contiguous, any row stride (a channel
            slice of a wider tensor is taken as it is). Cast to the cache's
            dtype if it differs.
    cursor: host integer in [0, T)."""
    with profiling.span("op.cache_write"):
        _check(cache, y, cursor, T, OC)
        y = y.to(cache.dtype)
        if not on_card("cache_write", cache):
            return cache_write_reference(cache, y, int(cursor), T=T, OC=OC)
        B, D = cache.shape[2], cache.shape[3]
        if B == 0 or D == 0:
            return cache
        _, C, OH, OW = y.shape
        rows_contiguous = (
            (OW == 1 or y.stride(3) == 1)
            and (OH == 1 or y.stride(2) == OW)
            and (C == 1 or y.stride(1) == OH * OW)
        )
        if not rows_contiguous:
            raise ValueError(
                f"cache_write: each row of y must be contiguous in (C, OH, OW) order, got strides "
                f"{y.stride()} for shape {tuple(y.shape)}"
            )
        size = cache.element_size()
        with torch.cuda.device(cache.device):
            stream = torch.cuda.current_stream(cache.device).cuda_stream
            err = _kernel_lib().cache_write(
                cache.data_ptr(), y.data_ptr(), y.stride(0) * size, B, T, D * size, int(cursor),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"cache_write kernel launch failed: CUDA error {err}")
        cache_write.launches += 1
        return cache


cache_write.launches = 0


def gather_sum(cache: torch.Tensor, valid: torch.Tensor, cursor: int) -> torch.Tensor:
    """sum_p valid[:, (cursor + p) % T] * cache[cursor, p] -> (B, D) float32.

    The diagonal rule puts every entry the current window needs in row
    j == cursor, so this is one contiguous slab and a T-term masked sum in
    float32, p ascending as the reference sums. Invalid slots (the zero
    padding of a young episode) contribute zero, as in the masked window
    convolution this replaces."""
    T = cache.shape[0]
    slab = cache[cursor]  # (P, B, D)
    acc = torch.zeros(slab.shape[1:], dtype=torch.float32, device=cache.device)
    for p in range(T):
        v = valid[:, (cursor + p) % T]
        acc = acc + slab[p].to(torch.float32) * v[:, None].to(torch.float32)
    return acc
