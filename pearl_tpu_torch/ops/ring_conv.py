"""First convolution of the visual act path, read straight from the frame
ring: kernel B5 of the port.

Replaces the TPU kernel of `pearl_tpu/ops/ring_conv.py` with a CUDA C++
kernel written by hand for Hopper (`csrc/ring_conv.cu`, built for sm_90a by
`ops/_build.py` and bound with `ctypes`):

    ring_conv1(ring, valid, wmat, bias, H=, W=, k=, s=)
        relu(conv1(ring * valid, wmat) + bias) in one pass over the ring:
        mask, the /255 folded into the weights, conv1, bias and relu, with
        neither the masked window nor the conv's input ever written out.

Contract, the reference's: `ring` (B, T, H*W) frames in ring order, `valid`
(B, T) bool, `wmat` (T*k*k, OC) the conv1 kernel flattened in (t, ky, kx)
order, already rotated by the cursor and already divided by 255, `bias`
(OC,). The result has the ring's dtype and is (B, OC, OH, OW), contiguous:
the NCHW input of conv2 (the reference returns NHWC, its own conv layout).
The reference's `batch_block` is a TPU tiling parameter and is dropped.

Arithmetic: the masked patch is x or exactly zero; `wmat` is cast to the
ring's dtype before the product; products accumulate in float32; bias is
added in float32, then relu, then one rounding into the ring's dtype. A
float32 ring is computed in full float32. Only the order of the T*k*k-term
sum differs from the reference, and between kernel and plain version.

What bounds it on an H100 at B = 1024, T = 4, 84 x 84, k = 8, s = 4, OC = 16:
bytes in bfloat16 (57.8 MB read, 13.1 MB written: 21.2 us at 3.35 TB/s; its
3.36 GFLOP are 3.4 us on the tensor cores but 50 us on the CUDA cores),
operations in float32 (50.1 us at 67 TFLOP/s; the 2e-5 tolerance rules out
TF32). The source has two bodies, and its C entry picks one (`pick_body`
mirrors the choice here, so that it can be tested without a card):

  mma      a bfloat16 ring with k a multiple of 8, s and W multiples of 4, OC
           8, 16 or 32, frames of a multiple of 16 bytes at a 16-byte aligned
           base and room for two envs' frames in shared memory: an implicit GEMM in
           `mma.sync.m16n8k16` with the A fragments gathered from the staged
           frames (`a_fragment_offsets` is the address map), persistent
           blocks, one bulk copy per valid frame reporting to an `mbarrier`,
           two or three envs in flight, 16-byte stores of out[b];
  general  everything else: a block per (env, tile of output rows), float32
           FMAs on the CUDA cores (the first design).

`csrc/ring_conv.cu` has the designs in full.

Dispatch: a CUDA ring launches the kernel (or raises), a CPU ring runs the
plain version (`ring_conv1_reference`). Nothing falls back. On the card it is
the default act conv1 for bfloat16 rings: `CNNQValueNetwork` under its
default `ring_conv=None` calls it for every live acting window whose conv1
it takes (`q_value_networks.act_takes_ring_conv`), and `ring_conv=False`
keeps the fences and the library's conv1. The learn path's replay windows
never come here.
`ring_conv1.launches` counts kernel launches and nothing else;
`ring_conv1.mma_launches` counts those of them that took the mma body.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pearl_tpu_torch.ops._build import load_library, on_card
from pearl_tpu_torch.utils import profiling

_ELEM = {torch.float32: 0, torch.bfloat16: 1}
# Limits of `csrc/ring_conv.cu`: the output channels a thread can hold in
# registers, the frames whose flags a block keeps, and the shared memory a
# block may use (227 KB less the kernel's static part).
_KERNEL_OC = (4, 8, 16, 32)
_KERNEL_MAX_T = 32
_KERNEL_SMEM = 232448 - 1024
BODIES = ("general", "mma")  # by the number the C entry reports
_MMA_MAX_STAGES = 3


def _mma_stages(T: int, H: int, W: int, k: int, OC: int, P: int, smem: int) -> int:
    """Envs whose frames the mma body keeps in shared memory: the most of 3
    that fit beside the weights, out[b] twice, the bias, the barriers and the
    valid flags (the layout of `rc_mma_layout`)."""
    stage = T * H * W * 2
    fixed = (T * k * k * OC * 2 + 2 * (-(-(OC * P * 2) // 16) * 16) + OC * 4
             + _MMA_MAX_STAGES * 8 + _MMA_MAX_STAGES * _KERNEL_MAX_T)
    return max(0, min(_MMA_MAX_STAGES, (smem - fixed) // stage))


def pick_body(
    dtype: torch.dtype, T: int, H: int, W: int, k: int, s: int, OC: int,
    ring_aligned: bool = True, smem: int = _KERNEL_SMEM,
) -> str:
    """The body the C entry `ring_conv1` launches for a ring of `dtype`: the
    mirror of `rc_pick_body` in `csrc/ring_conv.cu`. `ring_aligned`: the
    ring's base address is a multiple of 16. Raises ValueError for a ring
    neither body takes."""
    if dtype not in _ELEM or not ring_conv_applicable(
            T, H, W, 1, k, s, 0, OC, torch.finfo(dtype).bits // 8):
        raise ValueError(
            f"ring_conv1 takes no ring of {dtype} with T={T}, {H}x{W} frames, k={k}, s={s}, "
            f"OC={OC}"
        )
    P = ((H - k) // s + 1) * ((W - k) // s + 1)
    mma = (
        dtype == torch.bfloat16 and k % 8 == 0 and s % 4 == 0 and W % 4 == 0
        and OC % 8 == 0 and OC <= 32 and (H * W * 2) % 16 == 0 and ring_aligned
        and _mma_stages(T, H, W, k, OC, P, smem) >= 2
    )
    return "mma" if mma else "general"


def a_fragment_offsets(pixel: int, kstep: int, lane: int, *, W: int, OW: int, k: int, s: int):
    """Where the mma body's lane `lane` finds its A registers for the output
    pixel `pixel` (a row of the 16 x 16 A tile: the lane's group lane // 4 or
    that plus 8) in k-step `kstep`. A k-step is two kernel rows (ky, ky + 1)
    by 8 kx (block kxb) of one frame t, and lane c = lane % 4 reads ONE
    aligned 8-byte word, 4 elements: its first register is columns (2c, 2c+1)
    of the tile, its second columns (2c+8, 2c+9). Returns (t, offset, rows):
    the frame, the element offset of the word from the start of that frame
    (H*W elements), and the 4 rows of `wmat` its elements multiply, in order.
    The model of the index algebra in `csrc/ring_conv.cu`, for the tests."""
    kxbs, kyps = k // 8, k // 2
    t, in_frame = divmod(kstep, kxbs * kyps)
    kyp, kxb = divmod(in_frame, kxbs)
    oy, ox = divmod(pixel, OW)
    c = lane % 4
    ky, kx = 2 * kyp + c // 2, kxb * 8 + 4 * (c % 2)
    offset = (oy * s + ky) * W + ox * s + kx
    rows = [(t * k + ky) * k + kx + i for i in range(4)]
    return t, offset, rows


def _one_row_smem_bytes(T: int, W: int, k: int, OC: int, elem_size: int) -> int:
    """Shared memory of the kernel's smallest block (one output row): wmat
    and bias in float32, and per frame a band of k input rows padded to 16
    bytes."""
    per16 = 16 // elem_size
    band = -(-(k * W) // per16) * per16
    return (T * k * k * OC + OC) * 4 + T * band * elem_size


def ring_conv_applicable(T, H, W, fc, k, s, p, OC, elem_size=4) -> bool:
    """Whether `ring_conv1` takes conv1 of a network: single-channel frames
    and no padding (the ring's frames are the conv's input channels as they
    lie), a kernel that fits the frame, and the limits of the CUDA kernel.
    Any batch size and any stride are taken; the reference's lane conditions
    on B and its divisibility conditions on H, W, k and s are the TPU
    kernel's and are not needed."""
    return (
        fc == 1
        and p == 0
        and 1 <= k <= min(H, W)
        and s >= 1
        and 1 <= T <= _KERNEL_MAX_T
        and OC in _KERNEL_OC
        and _one_row_smem_bytes(T, W, k, OC, elem_size) <= _KERNEL_SMEM
    )


def ring_conv1_reference(
    ring: torch.Tensor, valid: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
    *, H: int, W: int, k: int, s: int,
) -> torch.Tensor:
    """Plain PyTorch version: the masked ring as a (B, T, H, W) image, one
    `conv2d` with `wmat` as an (OC, T, k, k) kernel, bias, relu. The values
    are those of the ring's dtype (masked pixels and weights rounded to it),
    the sum, bias and relu are float32, and the result is rounded once."""
    B, T, _ = ring.shape
    OC = wmat.shape[1]
    dtype = ring.dtype
    x = (ring.to(torch.float32) * valid[..., None].to(torch.float32)).to(dtype)
    w = wmat.to(dtype).reshape(T, k, k, OC).permute(3, 0, 1, 2)
    y = F.conv2d(x.reshape(B, T, H, W).to(torch.float32), w.to(torch.float32), stride=s)
    y = F.relu(y + bias.to(torch.float32)[None, :, None, None])
    return y.to(dtype).contiguous()


def _check(ring, valid, wmat, bias, H, W, k, s) -> None:
    if ring.dim() != 3:
        raise ValueError(f"ring_conv1: ring must be (B, T, F), got shape {tuple(ring.shape)}")
    B, T, F_ = ring.shape
    if F_ != H * W:
        raise ValueError(f"ring_conv1: F = {F_} is not H*W = {H}*{W}")
    if ring.dtype not in _ELEM:
        raise TypeError(f"ring_conv1: ring is {ring.dtype}; float32 or bfloat16 required")
    if valid.shape != (B, T) or valid.dtype != torch.bool:
        raise TypeError(
            f"ring_conv1: valid must be ({B}, {T}) bool, got {tuple(valid.shape)} {valid.dtype}"
        )
    if wmat.dim() != 2 or wmat.shape[0] != T * k * k:
        raise ValueError(
            f"ring_conv1: wmat must be ({T}*{k}*{k}, OC), got shape {tuple(wmat.shape)}"
        )
    OC = wmat.shape[1]
    if bias.shape != (OC,):
        raise ValueError(f"ring_conv1: bias must be ({OC},), got shape {tuple(bias.shape)}")
    for name, t in (("valid", valid), ("wmat", wmat), ("bias", bias)):
        if t.device != ring.device:
            raise ValueError(f"ring_conv1: {name} is on {t.device}, the ring on {ring.device}")
    if not ring_conv_applicable(T, H, W, 1, k, s, 0, OC, ring.element_size()):
        raise ValueError(
            f"ring_conv1 does not take T={T}, {H}x{W} frames, k={k}, s={s}, OC={OC} in "
            f"{ring.dtype}: it needs 1 <= k <= min(H, W), T <= {_KERNEL_MAX_T}, OC in "
            f"{_KERNEL_OC} and wmat with one band of k rows per frame within "
            f"{_KERNEL_SMEM} bytes of shared memory"
        )


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = load_library("ring_conv")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ring_conv1.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, i32, ptr,
        ctypes.POINTER(i32),
    ]
    lib.ring_conv1.restype = ctypes.c_int
    lib.ring_conv1_pick.argtypes = [i32, i32, i32, i32, i32, i32, i32, i32, i64]
    lib.ring_conv1_pick.restype = ctypes.c_int
    return lib


def ring_conv1(
    ring: torch.Tensor, valid: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
    *, H: int, W: int, k: int, s: int,
) -> torch.Tensor:
    """conv1 + mask + bias + relu over the ring window.

    ring:  (B, T, H*W) frames in ring order, float32 or bfloat16, contiguous
    valid: (B, T) bool validity
    wmat:  (T*k*k, OC) kernel flattened in (t, ky, kx) order, already rotated
           by the cursor and scaled by any input normalisation
    bias:  (OC,)
    Returns (B, OC, OH, OW) in the ring's dtype."""
    with profiling.span("op.ring_conv1"):
        _check(ring, valid, wmat, bias, H, W, k, s)
        if not on_card("ring_conv1", ring):
            return ring_conv1_reference(ring, valid, wmat, bias, H=H, W=W, k=k, s=s)
        if not ring.is_contiguous() or not valid.is_contiguous():
            raise ValueError("ring_conv1: ring and valid must be contiguous")
        B, T, _ = ring.shape
        OC = wmat.shape[1]
        OH, OW = (H - k) // s + 1, (W - k) // s + 1
        out = torch.empty((B, OC, OH, OW), dtype=ring.dtype, device=ring.device)
        if B == 0:
            return out
        # The weights as the kernel multiplies them: in the ring's dtype.
        w = wmat.to(ring.dtype).contiguous()
        if w.data_ptr() % 16:  # a view into a larger buffer: the kernel reads 16-byte pieces
            w = w.clone()
        b32 = bias.to(torch.float32).contiguous()
        picked = ctypes.c_int(-1)
        with torch.cuda.device(ring.device):
            stream = torch.cuda.current_stream(ring.device).cuda_stream
            err = _kernel_lib().ring_conv1(
                ring.data_ptr(), valid.data_ptr(), w.data_ptr(), b32.data_ptr(), out.data_ptr(),
                B, T, H, W, k, s, OC, _ELEM[ring.dtype], stream, ctypes.byref(picked),
            )
        if err != 0:
            raise RuntimeError(f"ring_conv1 kernel launch failed: CUDA error {err}")
        ring_conv1.launches += 1
        ring_conv1.mma_launches += BODIES[picked.value] == "mma"
        return out


ring_conv1.launches = 0
ring_conv1.mma_launches = 0


def kernel_pick(dtype, T, H, W, k, s, OC, ring_aligned=True, smem=_KERNEL_SMEM) -> str:
    """What the built library's own `rc_pick_body` answers (needs the built
    kernel, so a card's machine): held against `pick_body` on the card."""
    body = _kernel_lib().ring_conv1_pick(
        _ELEM[dtype], T, H, W, k, s, OC, int(ring_aligned), smem)
    return BODIES[body]
