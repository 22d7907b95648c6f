"""Tree utilities over dataclasses, dicts, tuples and tensors (port of
`pearl_tpu/utils/pytree.py`): per-env conditional state updates for the
asynchronous auto-reset, target-network soft updates, and the act path's
cast copy of a network."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable, *trees: Any) -> Any:
    """Apply `fn` leaf-wise over matching dataclasses or dicts of tensors.
    `None` leaves stay `None`; non-tensor leaves come from the first tree."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(
            first,
            **{
                f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                for f in dataclasses.fields(first)
                if f.init
            },
        )
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return first


def tree_select(cond: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """`torch.where` over every leaf, broadcasting `cond` (B,) from the left
    over leaves of shape (B, ...)."""

    def _sel(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)

    return tree_map(_sel, on_true, on_false)


@torch.no_grad()
def soft_update(target, source, tau: float) -> None:
    """target <- target + tau * (source - target), in place, over two
    `nn.Module`s with the same parameters. Written as the reference writes it
    (`t + tau * (s - t)`), not with `lerp_`, whose formula changes at 0.5."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.add_(s - t, alpha=tau)


def synced_cast(cast, source):
    """`cast` (a copy of the `nn.Module` `source` in a lower dtype), recast
    from `source` if that was written since the last cast: by a learn step,
    a weight load, a `load_state_dict`, or because the caller now holds
    another module. Each parameter's identity and in-place version counter
    are compared on the host, so an unchanged step costs no launch and no
    sync. (A write through `.data` bypasses the counter: write parameters
    under `torch.no_grad()` instead.)"""
    stamp = tuple((id(p), p._version) for p in source.parameters())
    if getattr(cast, "_cast_of", None) != stamp:
        with torch.no_grad():
            for c, p in zip(cast.parameters(), source.parameters()):
                c.copy_(p)
        cast._cast_of = stamp
    return cast
