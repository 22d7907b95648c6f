"""Collectives over one axis of a mesh: the port's `jax.lax.psum` and
`jax.lax.pmean`.

A `MeshAxis` holds a `torch.distributed` process group, its size, this
process's rank in it and this rank's device; `Mesh.axis(name)` hands one out
(`parallel.data_parallel.make_mesh`). A learner's `pmean_axis` is such an
object or None: a bare axis name has no meaning outside a mesh here, so it is
a TypeError.

`psum` and `pmean` take a list of tensors, flatten it into one buffer per
dtype, issue one `all_reduce(SUM)` per buffer and split the result back;
`pmean` then divides by the group's size, as `pmean` does. Every rank must
call them with the same list layout, or the ranks deadlock or scramble each
other's buffers: `pmean_grads` therefore enters a missing gradient as zeros,
in the parameters' fixed order.

Only `all_reduce(SUM)` and `broadcast` are used, the two gloo collectives
that take CUDA tensors (gloo has no CUDA `all_gather`). A gather is an
all-reduce of a zero buffer into which each rank writes its own block
(`gather_blocks`): adding zeros is exact, so the blocks arrive bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class MeshAxis:
    """One axis of a mesh as this process sees it."""

    name: str
    group: object  # a torch.distributed ProcessGroup
    size: int
    rank: int  # this process's rank along the axis
    device: torch.device

    def __repr__(self) -> str:
        return f"MeshAxis({self.name!r}, size={self.size}, rank={self.rank}, {self.device})"


def check_pmean_axis(axis) -> Optional[MeshAxis]:
    """`axis` if it is None or a `MeshAxis`; anything else is a TypeError."""
    if axis is None or isinstance(axis, MeshAxis):
        return axis
    raise TypeError(
        f"pmean_axis must be None or a MeshAxis from pearl_tpu_torch.parallel.make_mesh "
        f"(make_mesh(n).axis('data')), got {axis!r}: an axis name means nothing outside "
        "a mesh; online_learning(mesh=make_mesh(n)) sets it for you"
    )


def _reduce(tensors: Sequence[torch.Tensor], axis: MeshAxis, mean: bool) -> List[torch.Tensor]:
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
        if mean:
            buf = buf / axis.size
        for i, piece in zip(idx, buf.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def psum(tensors: Sequence[torch.Tensor], axis: Optional[MeshAxis]) -> List[torch.Tensor]:
    """The sum of each tensor over the axis' ranks: one all-reduce per dtype.
    Without an axis, the tensors as they are."""
    return list(tensors) if axis is None else _reduce(tensors, axis, mean=False)


def pmean(tensors: Sequence[torch.Tensor], axis: Optional[MeshAxis]) -> List[torch.Tensor]:
    """The mean of each tensor over the axis' ranks (the sum / the size).
    Without an axis, the tensors as they are."""
    return list(tensors) if axis is None else _reduce(tensors, axis, mean=True)


def pmean_grads(
    params: Sequence[torch.nn.Parameter], axis: Optional[MeshAxis], extra: Sequence = (),
) -> List[torch.Tensor]:
    """Replace each parameter's `.grad` by its mean over the axis and return
    the means of the `extra` tensors (metrics), all in one all-reduce per
    dtype. A parameter without a gradient on this rank enters as zeros, so
    every rank reduces the same layout, and keeps no gradient (as it would
    alone): the ranks run the same program, so a parameter has a gradient on
    all of them or on none."""
    extra = list(extra)
    if axis is None:
        return extra
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    reduced = pmean(grads + extra, axis)
    for p, g in zip(params, reduced):
        if p.grad is not None:
            p.grad = g
    return reduced[len(params):]


def optimizer_params(optimizer: torch.optim.Optimizer) -> List[torch.nn.Parameter]:
    """Every parameter `optimizer` steps, in its groups' order."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def gather_blocks(block: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """(size, *block.shape): every rank's `block` in rank order, on every
    rank, as one all-reduce of a zero buffer holding this rank's block."""
    buf = torch.zeros((axis.size,) + tuple(block.shape), dtype=block.dtype, device=block.device)
    buf[axis.rank] = block
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
    return buf


def broadcast_bytes(tensors: Sequence[torch.Tensor], axis: MeshAxis, src: int = 0) -> List[torch.Tensor]:
    """Rank `src`'s tensors, byte for byte, on every rank of the axis: one
    broadcast of their bytes. Each rank must give tensors of the same
    shapes and dtypes."""
    flat = [t.detach().to(axis.device).contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    buf = torch.cat(flat) if flat else torch.zeros((0,), dtype=torch.uint8, device=axis.device)
    dist.broadcast(buf, dist.get_global_rank(axis.group, src), group=axis.group)
    out = []
    for t, piece in zip(tensors, buf.split([f.numel() for f in flat])):
        # A piece's offset need not suit a wider dtype: copy it out first.
        out.append(piece.clone().view(t.dtype).view(t.shape))
    return out
