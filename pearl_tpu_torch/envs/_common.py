"""Helpers the batched envs share."""

from __future__ import annotations

from typing import Sequence

import torch


def take(values: Sequence[float], index: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """`values[index]` for a short table of constants, indexed as `jnp`
    indexes: a negative index counts from the end, then the index is
    clamped into range (a torch gather raises on the CPU and asserts on the
    card instead). Written as a chain of `where`s over the constants, so no
    table is copied to the device at a step."""
    n = len(values)
    index = torch.where(index < 0, index + n, index).clamp(0, n - 1)
    out = torch.full(index.shape, values[-1], dtype=dtype, device=index.device)
    for i in range(n - 2, -1, -1):
        out = torch.where(index == i, values[i], out)
    return out


def uniform(shape, low: float, high: float, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform float32 draws on [low, high) from `generator`."""
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low
