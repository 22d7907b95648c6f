"""Action representation modules (port of
`pearl_tpu/action_representation_modules/modules.py`: identity, one-hot
and binary).

Both are fixed, parameterless transforms of the raw stored action vectors
(for gym-style discrete spaces, length-1 index vectors).
"""

from __future__ import annotations

import abc
import dataclasses
import math

import torch


class ActionRepresentationModule(abc.ABC):
    @abc.abstractmethod
    def apply(self, action: torch.Tensor) -> torch.Tensor:
        """(..., a) -> (..., r)."""

    @abc.abstractmethod
    def representation_dim(self, action_dim: int, max_number_actions: int) -> int:
        ...

    def resolve(self, action_dim: int, max_number_actions: int) -> "ActionRepresentationModule":
        """A copy with any space-dependent fields filled in."""
        return self


@dataclasses.dataclass(frozen=True)
class IdentityActionRepresentation(ActionRepresentationModule):
    def apply(self, action):
        return action

    def representation_dim(self, action_dim, max_number_actions):
        return action_dim


@dataclasses.dataclass(frozen=True)
class OneHotActionRepresentation(ActionRepresentationModule):
    """One-hot of the action index, as float32."""

    max_number_actions: int = 0  # resolved by the learner if left 0

    def resolve(self, action_dim, max_number_actions):
        if action_dim != 1:
            raise ValueError(
                "OneHotActionRepresentation one-hots the stored action value, "
                "which is only meaningful for index-valued action spaces "
                f"(action_dim=1); this space has action_dim={action_dim}. Use "
                "IdentityActionRepresentation instead."
            )
        if self.max_number_actions:
            return self
        return dataclasses.replace(self, max_number_actions=max_number_actions)

    def apply(self, action):
        """`jax.nn.one_hot` of the index: (..., 0) for 0 classes and a zero
        row for an index outside [0, n). A compare against `arange`: it needs
        no host sync, and `F.one_hot` rejects both cases (on the CPU by a
        check on the host, on the card by a device assert)."""
        idx = action[..., 0].to(torch.int64)
        classes = torch.arange(self.max_number_actions, device=action.device)
        return (idx[..., None] == classes).to(torch.float32)

    def representation_dim(self, action_dim, max_number_actions):
        del action_dim
        return self.max_number_actions or max_number_actions


@dataclasses.dataclass(frozen=True)
class BinaryActionRepresentation(ActionRepresentationModule):
    """The bits of the action index, least significant first, as float32:
    `bits` of them (8 when left 0 and not resolved)."""

    bits: int = 0

    def resolve(self, action_dim, max_number_actions):
        if action_dim != 1:
            raise ValueError(
                "BinaryActionRepresentation bit-encodes the stored action "
                "value, which is only meaningful for index-valued action "
                f"spaces (action_dim=1); this space has action_dim="
                f"{action_dim}. Use IdentityActionRepresentation instead."
            )
        if self.bits:
            return self
        nbits = max(1, math.ceil(math.log2(max(max_number_actions, 2))))
        return dataclasses.replace(self, bits=nbits)

    def apply(self, action):
        idx = action[..., 0].to(torch.int32)
        shifts = torch.arange(self.bits or 8, dtype=torch.int32, device=action.device)
        return ((idx[..., None] >> shifts) & 1).to(torch.float32)

    def representation_dim(self, action_dim, max_number_actions):
        del action_dim
        return self.bits or 8
