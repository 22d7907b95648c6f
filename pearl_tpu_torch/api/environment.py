"""Batched environment API (port of `pearl_tpu/api/environment.py`).

The reference writes a per-env pure function and vmaps it. Here an
environment steps a whole batch at once as tensor math:

    reset(num_envs, generator, device) -> (EnvState, obs (B, d))
    step(state, action (B, a))         -> (EnvState, ActionResult)

`EnvState` is a dataclass of (B, ...) tensors.
"""

from __future__ import annotations

import abc
from typing import Any, Tuple

import torch

from pearl_tpu_torch.api.types import ActionResult

EnvState = Any


class Environment(abc.ABC):
    """Abstract batched environment."""

    @property
    @abc.abstractmethod
    def action_space(self):
        ...

    @property
    @abc.abstractmethod
    def observation_space(self):
        ...

    @property
    def observation_dim(self) -> int:
        return int(self.observation_space.shape[-1])

    @abc.abstractmethod
    def reset(
        self, num_envs: int, generator: torch.Generator, device: torch.device
    ) -> Tuple[EnvState, torch.Tensor]:
        ...

    @abc.abstractmethod
    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, ActionResult]:
        ...

    @property
    def max_episode_steps(self) -> int:
        """Truncation horizon (0 = none)."""
        return 0
