"""Bytes of `synthetic_frames(phase, t, fresh_phase, done, H=, W=, frames=,
dtype=)`: the two (B, H*W*frames) outputs written in full in `dtype` (the
kernel stores next_obs whole, a copy of obs where the env is not done), and
the four (B,) inputs read once. The sines are not counted: the writes bound
the kernel."""

import torch

_NAMES = ("phase", "t", "fresh_phase", "done")


def nbytes(args, kwargs) -> int:
    given = dict(zip(_NAMES, args), **kwargs)
    B = given["phase"].shape[0]
    out = B * given["H"] * given["W"] * given["frames"] * (torch.finfo(given["dtype"]).bits // 8)
    return 2 * out + sum(given[n].numel() * given[n].element_size() for n in _NAMES)
