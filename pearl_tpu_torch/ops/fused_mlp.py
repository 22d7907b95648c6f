"""Fused relu-MLP forward: kernel B1 of the port.

Replaces the TPU kernel `_pallas_forward` of `pearl_tpu/ops/fused_mlp.py`
with a CUDA C++ kernel written by hand for Hopper (`csrc/fused_mlp.cu`,
built for sm_90a by `ops/_build.py` and bound with `ctypes`). The chain is
`x @ W1^T + b1 -> relu -> ... -> @ Wn^T + bn`; every W is in nn.Linear's
(out, in) layout — the transpose of the flax `Dense.kernel` the reference
takes — and every b is (out,).

What bounds it on an H100 at the DQN act shape (B = 131072, 4 -> 64 -> 64 ->
2): x plus the output is 3 MB, about 1 us at 3.35 TB/s, but the chain is
2*B*(4*64 + 64*64 + 64*2) ~= 1.17 GFLOP of float32 on the CUDA cores (~17 us
at 67 TFLOP/s), so it is bound by operations: by the FMA pipe's instruction
slots and the shared-memory loads that feed them. At the learn shape (B =
1024) the time is latency: how many SMs take part and how long one row's
chain is. The source has three bodies, and its C entry picks one (`pick_body`
mirrors the choice here, so that it can be tested without a card):

  rows     B <= 32 * SMs, any widths: a warp carries two rows, the 16 lanes
           of a row split its outputs, the weights are copied to shared
           memory in one trip (or read from L1/L2 when they do not fit);
  tiled    larger B, every width after the first <= 64: a thread holds an
           8-row by 16-column register tile (6 shared-memory loads per 128
           FMAs), the activation tile is one buffer rewritten in place, two
           persistent blocks of 4 warps and 256 rows an SM;
  general  larger B with a wider layer: one thread per row, 8 outputs at a
           time (the first design).

All keep each row's activations on chip for the whole chain;
`csrc/fused_mlp.cu` has the designs in full.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
`fused_mlp_reference`, the plain PyTorch chain. Nothing falls back. The
backward pass recomputes through the plain chain, as the reference's
`_fused_bwd` does (the TPU kernel had no backward kernel, so none is written).
`fused_mlp.launches` counts kernel launches and nothing else;
`fused_mlp.launches_by_body` splits the same count by the body launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pearl_tpu_torch.utils import profiling

MAX_LAYERS = 8
MAX_WIDTH = 256
# The bodies of `csrc/fused_mlp.cu`, by the number its entry point reports.
BODIES = ("rows", "tiled", "general")
ROWS_PER_SM = 32  # the rows body takes B <= ROWS_PER_SM * SMs
TILE_ROWS = 256  # rows per tile of the tiled body
TILE_MAX_WIDTH = 64  # its widest layer output
H100_SMS = 132
H100_SMEM_OPTIN = 232448  # bytes of shared memory a block may use


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _tile_stride(dout: int) -> int:
    """Stride of a staged weight row in the tiled body: `dout` rounded up to
    whole column tiles of 16, 8 or 4 (by the layer's width)."""
    dp = _pad4(dout)
    ct = 16 if dp > 32 else 8 if dp > 16 else 4
    return -(-dout // ct) * ct


def _tiled_smem_bytes(dims: Sequence[int]) -> int:
    weights = sum((i + 1) * _tile_stride(o) for i, o in zip(dims[:-1], dims[1:]))
    return 4 * (weights + max(dims[:-1]) * TILE_ROWS)


def _general_smem_bytes(dims: Sequence[int], rows: int) -> int:
    weights = sum(i * _pad4(o) + _pad4(o) for i, o in zip(dims[:-1], dims[1:]))
    return 4 * (weights + 2 * max(dims[:-1]) * (rows + 1))


def pick_body(
    B: int, dims: Sequence[int], sms: int = H100_SMS, smem_optin: int = H100_SMEM_OPTIN
) -> str:
    """The body `fused_mlp_forward` launches for B rows of a chain of widths
    `dims` on a card with `sms` SMs and `smem_optin` bytes of shared memory a
    block: the mirror of `mlp_pick_body` in `csrc/fused_mlp.cu`. Raises
    ValueError for a chain the kernel does not take."""
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS or min(dims) < 1 or max(dims) > MAX_WIDTH:
        raise ValueError(
            f"fused_mlp kernel takes 1 to {MAX_LAYERS} layers of width 1 to "
            f"{MAX_WIDTH}; got widths {tuple(dims)}"
        )
    if B <= ROWS_PER_SM * sms:
        return "rows"
    if max(dims[1:]) <= TILE_MAX_WIDTH and _tiled_smem_bytes(dims) <= smem_optin:
        return "tiled"
    if _general_smem_bytes(dims, 32) <= smem_optin:
        return "general"
    raise ValueError(
        f"fused_mlp kernel: widths {tuple(dims)} do not fit one block's shared memory"
    )


def fused_mlp_reference(x: torch.Tensor, wb: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch relu-MLP chain — the semantics the kernel must match
    (counterpart of the reference's `_reference_forward`)."""
    h = x
    n_layers = len(wb) // 2
    for i in range(n_layers):
        h = F.linear(h, wb[2 * i], wb[2 * i + 1])
        if i < n_layers - 1:
            h = F.relu(h)
    return h


def _check(x: torch.Tensor, wb: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """Validate the operands; returns the chain's widths (d0, d1, ..., dn)."""
    if len(wb) == 0 or len(wb) % 2:
        raise ValueError(f"fused_mlp takes (W1, b1, ..., Wn, bn); got {len(wb)} tensors")
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be (B, D), got shape {tuple(x.shape)}")
    dims = [int(x.shape[1])]
    for i, t in enumerate((x, *wb)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp: operand {i} is {t.dtype}, float32 required")
        if t.device != x.device:
            raise ValueError(f"fused_mlp: operand {i} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp: operand {i} is not contiguous")
    for layer in range(len(wb) // 2):
        w, b = wb[2 * layer], wb[2 * layer + 1]
        if w.dim() != 2 or w.shape[1] != dims[-1] or b.shape != (w.shape[0],):
            raise ValueError(
                f"fused_mlp: layer {layer} has W {tuple(w.shape)}, b {tuple(b.shape)}; "
                f"expected W (out, {dims[-1]}) and b (out,)"
            )
        dims.append(int(w.shape[0]))
    return tuple(dims)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from pearl_tpu_torch.ops._build import load_library

    lib = load_library("fused_mlp")
    lib.fused_mlp_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.fused_mlp_forward.restype = ctypes.c_int
    lib.fused_mlp_pick.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ]
    lib.fused_mlp_pick.restype = ctypes.c_int
    lib.fused_mlp_empty_launch.argtypes = [ctypes.c_void_p]
    lib.fused_mlp_empty_launch.restype = ctypes.c_int
    lib.fused_mlp_fma_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fused_mlp_fma_probe.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, wb: Sequence[torch.Tensor], dims: Tuple[int, ...]) -> torch.Tensor:
    n_layers = len(dims) - 1
    if n_layers > MAX_LAYERS or max(dims) > MAX_WIDTH:
        raise ValueError(
            f"fused_mlp kernel takes at most {MAX_LAYERS} layers of width <= "
            f"{MAX_WIDTH}; got widths {dims}"
        )
    B = x.shape[0]
    out = torch.empty((B, dims[-1]), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _kernel_lib()
    c_dims = (ctypes.c_int * len(dims))(*dims)
    picked = ctypes.c_int(-1)
    c_w = (ctypes.c_void_p * n_layers)(*(wb[2 * i].data_ptr() for i in range(n_layers)))
    c_b = (ctypes.c_void_p * n_layers)(*(wb[2 * i + 1].data_ptr() for i in range(n_layers)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mlp_forward(
            x.data_ptr(), out.data_ptr(), B, n_layers, c_dims, c_w, c_b, stream,
            ctypes.byref(picked),
        )
    if err == -1:
        raise ValueError(
            f"fused_mlp kernel: widths {dims} do not fit one block's shared memory"
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    fused_mlp.launches += 1
    fused_mlp.launches_by_body[BODIES[picked.value]] += 1
    return out


def kernel_pick(B: int, dims: Sequence[int], sms: int, smem_optin: int) -> str:
    """What the built library's own `mlp_pick_body` answers (needs the built
    kernel, so a card's machine): held against `pick_body` on the card."""
    c_dims = (ctypes.c_int * len(dims))(*dims)
    body = _kernel_lib().fused_mlp_pick(B, len(dims) - 1, c_dims, sms, smem_optin)
    if body < 0:
        raise ValueError(f"fused_mlp kernel takes no chain of widths {tuple(dims)} at B={B}")
    return BODIES[body]


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *wb):
        dims = _check(x, wb)
        ctx.save_for_backward(x, *wb)
        if x.is_cuda:
            return _launch(x, wb, dims)
        if x.device.type != "cpu":
            raise ValueError(f"fused_mlp runs on CUDA or CPU tensors, not {x.device}")
        return fused_mlp_reference(x, wb)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [
                t.detach().requires_grad_(need)
                for t, need in zip(saved, ctx.needs_input_grad)
            ]
            y = fused_mlp_reference(leaves[0], leaves[1:])
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def fused_mlp(x: torch.Tensor, *wb: torch.Tensor) -> torch.Tensor:
    """relu-MLP chain x @ W1^T + b1 -> relu -> ... -> @ Wn^T + bn, with
    wb = (W1, b1, ..., Wn, bn) in nn.Linear layout. Differentiable."""
    with profiling.span("op.fused_mlp"):
        return _FusedMLP.apply(x, *wb)


def empty_launch() -> None:
    """Launch the library's empty kernel on the current stream: timed on the
    card, it is the floor under the time of any kernel on a small batch.
    Counts as no launch of `fused_mlp`."""
    err = _kernel_lib().fused_mlp_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def fma_probe(out: torch.Tensor, blocks: int, iters: int) -> float:
    """Launch the library's FMA probe (128 independent float32 accumulators a
    thread, operands in registers) with `blocks` blocks of 128 threads and
    `iters` trips; `out` holds blocks * 128 float32 on the card. Returns the
    floating-point operations of the launch. Timed on the card, it is what
    the FMA pipes give the tiled body at best. Counts as no launch of
    `fused_mlp`."""
    if not out.is_cuda or out.dtype != torch.float32 or out.numel() < blocks * 128:
        raise ValueError("fma_probe: out must hold blocks * 128 float32 on the card")
    err = _kernel_lib().fused_mlp_fma_probe(
        out.data_ptr(), blocks, iters, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"FMA probe launch failed: CUDA error {err}")
    return 2.0 * blocks * 128 * 128 * iters


fused_mlp.launches = 0
fused_mlp.launches_by_body = dict.fromkeys(BODIES, 0)


def fused_mlp_from_module(mlp, x: torch.Tensor) -> torch.Tensor:
    """Run a `neural_networks.common.MLP` through `fused_mlp` (the torch-side
    `fused_mlp_from_flax`; `MLP.wb()` is the torch-side `flax_mlp_wb`): the
    kernel for a CUDA tensor, the plain chain for a CPU tensor."""
    return fused_mlp(x, *mlp.wb())
