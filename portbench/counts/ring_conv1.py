"""Bytes and operations of `ring_conv1(ring, valid, wmat, bias, H=, W=, k=,
s=)` (kernel B5): the (B, T, F) ring read once, with nothing of `valid` read
on the host; the (B, T) mask, `wmat` in the ring's dtype and `bias` in
float32 read once; the (B, OC, OH, OW) output written once in the ring's
dtype. The kernel copies no frame that `valid` marks out, so the bytes are an
upper bound: with episodes of 128 steps and a window of 4, the first three
acts of an episode skip 3 + 2 + 1 frames, 6 of every 512 (1.2% of the ring's
bytes; about 1% of the total at 16 output channels)."""

import torch

_NAMES = ("ring", "valid", "wmat", "bias")


def _call(args, kwargs):
    """The call's operands by name, and (B, T, k, OC, OH, OW)."""
    given = dict(zip(_NAMES, args), **kwargs)
    B, T, _ = given["ring"].shape
    H, W, k, s = (given[n] for n in ("H", "W", "k", "s"))
    return given, (B, T, k, given["wmat"].shape[1], (H - k) // s + 1, (W - k) // s + 1)


def nbytes(args, kwargs) -> int:
    given, (B, _, _, OC, OH, OW) = _call(args, kwargs)
    ring, valid, wmat, bias = (given[n] for n in _NAMES)
    return ((ring.numel() + wmat.numel() + B * OC * OH * OW) * ring.element_size()
            + valid.numel() * valid.element_size() + bias.numel() * 4)


def flops(args, kwargs):
    """Two operations a multiply-add of the convolution, at the ring's
    precision: bfloat16 on the tensor cores, else float32."""
    given, (B, T, k, OC, OH, OW) = _call(args, kwargs)
    precision = "bfloat16" if given["ring"].dtype == torch.bfloat16 else "float32"
    return 2 * B * OH * OW * OC * T * k * k, precision
