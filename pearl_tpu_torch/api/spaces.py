"""Spaces (port of `pearl_tpu/api/spaces.py`).

Spaces hold small float32 tensors on the CPU; the learner moves a space's
`elements` to its device once, at init. Sampling draws from an explicit
`torch.Generator` (there is no global RNG) on the generator's device. Masks
are True = available.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteSpace:
    """A finite set of elements, each a 1-D vector."""

    elements: torch.Tensor  # (n, d) f32

    @classmethod
    def create(cls, elements) -> "DiscreteSpace":
        elements = torch.as_tensor(elements, dtype=torch.float32)
        if elements.dim() == 1:
            elements = elements[:, None]
        return cls(elements=elements)

    @classmethod
    def range(cls, n: int) -> "DiscreteSpace":
        """The space {0, 1, ..., n-1} as 1-D scalars (gym `Discrete(n)`)."""
        return cls.create(torch.arange(n, dtype=torch.float32))

    @property
    def n(self) -> int:
        return int(self.elements.shape[0])

    @property
    def element_dim(self) -> int:
        return int(self.elements.shape[1])

    @property
    def shape(self):
        return (self.n, self.element_dim)

    @property
    def is_continuous(self) -> bool:
        return False

    def sample_index(
        self, generator: torch.Generator, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """A 0-dim int64 index, uniform over the elements or, with `mask`
        (n,), over the available ones; on the generator's device."""
        device = generator.device
        if mask is None:
            return torch.randint(self.n, (), generator=generator, device=device)
        weights = torch.as_tensor(mask, device=device).to(torch.float32)
        return torch.multinomial(weights, 1, generator=generator)[0]

    def sample(self, generator: torch.Generator, mask: Optional[torch.Tensor] = None):
        """The element at `sample_index(generator, mask)`, (element_dim,)."""
        index = self.sample_index(generator, mask)
        return self.elements.to(index.device)[index]


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteActionSpace(DiscreteSpace):
    """Discrete action space."""

    @property
    def action_dim(self) -> int:
        return self.element_dim

    @property
    def actions_batch(self) -> torch.Tensor:
        """All actions stacked, (n, action_dim)."""
        return self.elements

    @classmethod
    def discrete(cls, n: int) -> "DiscreteActionSpace":
        return cls.range(n)


@dataclasses.dataclass(frozen=True, eq=False)
class BoxSpace:
    """Box in R^d."""

    low: torch.Tensor  # (d,)
    high: torch.Tensor  # (d,)

    @classmethod
    def create(cls, low, high) -> "BoxSpace":
        low = torch.atleast_1d(torch.as_tensor(low, dtype=torch.float32))
        high = torch.atleast_1d(torch.as_tensor(high, dtype=torch.float32))
        return cls(low=low, high=high)

    @property
    def dim(self) -> int:
        return int(self.low.shape[0])

    @property
    def shape(self):
        return (self.dim,)

    @property
    def is_continuous(self) -> bool:
        return True

    def sample(
        self, generator: torch.Generator, mask: Optional[torch.Tensor] = None, device=None
    ) -> torch.Tensor:
        """(dim,): uniform on the bounded dims, standard normal on the
        unbounded ones, on `device` (the device of `low` by default; the
        generator must live there). A mask means nothing to a box and is
        ignored, as in the reference."""
        del mask
        device = self.low.device if device is None else torch.device(device)
        low, high = self.low.to(device), self.high.to(device)
        u = torch.rand((self.dim,), generator=generator, device=device)
        normal = torch.randn((self.dim,), generator=generator, device=device)
        bounded = torch.isfinite(low) & torch.isfinite(high)
        span = torch.where(bounded, high - low, torch.zeros_like(low))
        return torch.where(bounded, low + u * span, normal)

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        """`x` clamped to [low, high]."""
        return torch.clamp(x, self.low.to(x.device), self.high.to(x.device))


@dataclasses.dataclass(frozen=True, eq=False)
class BoxActionSpace(BoxSpace):
    """Continuous action space: a box of `action_dim` = `dim` torques,
    forces, ... It has no `n`: `getattr(space, "n", 0)` is 0, as in the
    reference."""

    @property
    def action_dim(self) -> int:
        return self.dim
