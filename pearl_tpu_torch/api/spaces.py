"""Spaces (port of `pearl_tpu/api/spaces.py`).

Spaces hold small float32 tensors on the CPU; the learner moves a space's
`elements` to its device once, at init.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteActionSpace(DiscreteSpace):
    """Discrete action space."""

    @property
    def action_dim(self) -> int:
        return self.element_dim

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


@dataclasses.dataclass(frozen=True, eq=False)
class BoxActionSpace(BoxSpace):
    """Continuous action space: a box of `action_dim` = `dim` torques,
    forces, ... It has no `n`: `getattr(space, "n", 0)` is 0, as in the
    reference."""

    @property
    def action_dim(self) -> int:
        return self.dim
