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
at 67 TFLOP/s), so it is bound by operations. The kernel keeps each row's
activations on chip for the whole chain (never written to device memory),
stages the weights once per persistent block in shared memory, and feeds 8
fma chains per thread from broadcast float4 weight loads; `csrc/fused_mlp.cu`
has the design in full.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
`fused_mlp_reference`, the plain PyTorch chain. Nothing falls back. The
backward pass recomputes through the plain chain, as the reference's
`_fused_bwd` does (the TPU kernel had no backward kernel, so none is written).
`fused_mlp.launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

MAX_LAYERS = 8
MAX_WIDTH = 256


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
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
    ]
    lib.fused_mlp_forward.restype = ctypes.c_int
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
    c_w = (ctypes.c_void_p * n_layers)(*(wb[2 * i].data_ptr() for i in range(n_layers)))
    c_b = (ctypes.c_void_p * n_layers)(*(wb[2 * i + 1].data_ptr() for i in range(n_layers)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mlp_forward(
            x.data_ptr(), out.data_ptr(), B, n_layers, c_dims, c_w, c_b, stream
        )
    if err == -1:
        raise ValueError(
            f"fused_mlp kernel: widths {dims} do not fit one block's shared memory"
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    fused_mlp.launches += 1
    return out


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
    return _FusedMLP.apply(x, *wb)


fused_mlp.launches = 0


def fused_mlp_from_module(mlp, x: torch.Tensor) -> torch.Tensor:
    """Run a `neural_networks.common.MLP` through `fused_mlp` (the torch-side
    `fused_mlp_from_flax`; `MLP.wb()` is the torch-side `flax_mlp_wb`): the
    kernel for a CUDA tensor, the plain chain for a CPU tensor."""
    return fused_mlp(x, *mlp.wb())
