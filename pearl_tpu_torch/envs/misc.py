"""The mean-variance bandit and the fixed-length env, batched (port of
`pearl_tpu/envs/misc.py`).

- `MeanVarBanditEnvironment`: two arms, every step a one-step episode; arm 0
  pays `safe_mean`, arm 1 `risky_mean + risky_sigma * N(0, 1)`: the testbed
  of the risk-sensitive safety modules.
- `FixedNumberOfStepsEnvironment`: the observation counts the steps of the
  episode, which truncates after `number_of_steps`; the reward is the action.

`step` takes no generator: the bandit's state keeps the one it was reset
with, and `step` draws the noise from it and calls `_transition`, which
tests feed with the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass
class StepCountState:
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None  # the step's draws, on the device


def _zeros_obs(num_envs, device):
    return torch.zeros((num_envs, 1), device=device)


@dataclasses.dataclass(frozen=True)
class MeanVarBanditEnvironment(Environment):
    safe_mean: float = 1.0
    risky_mean: float = 2.0
    risky_sigma: float = 4.0

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(2)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create([0.0], [1.0])

    def reset(self, num_envs, generator, device) -> Tuple[StepCountState, torch.Tensor]:
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return StepCountState(t=t, generator=generator), _zeros_obs(num_envs, device)

    def _transition(self, state: StepCountState, action: torch.Tensor, noise: torch.Tensor):
        """`noise` (B,): the risky arm's N(0, 1) draws."""
        idx = action[:, 0].to(torch.int32)
        reward = torch.where(idx == 0, self.safe_mean, self.risky_mean + self.risky_sigma * noise)
        result = ActionResult(
            observation=torch.zeros_like(action[:, :1], dtype=torch.float32),
            reward=reward,
            terminated=torch.ones_like(idx, dtype=torch.bool),
            truncated=torch.zeros_like(idx, dtype=torch.bool),
        )
        return state, result

    def step(self, state: StepCountState, action: torch.Tensor):
        noise = torch.randn(
            (action.shape[0],), generator=state.generator, device=action.device
        )
        return self._transition(state, action, noise)


@dataclasses.dataclass(frozen=True)
class FixedNumberOfStepsEnvironment(Environment):
    number_of_steps: int = 100

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(2)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create([0.0], [float(self.number_of_steps)])

    @property
    def max_episode_steps(self) -> int:
        return self.number_of_steps

    def reset(self, num_envs, generator, device) -> Tuple[StepCountState, torch.Tensor]:
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return StepCountState(t=t), _zeros_obs(num_envs, device)

    def step(self, state: StepCountState, action: torch.Tensor):
        t = state.t + 1
        result = ActionResult(
            observation=t.to(torch.float32)[:, None],
            reward=action[:, 0].to(torch.float32),  # the reward is the chosen action
            terminated=torch.zeros_like(t, dtype=torch.bool),
            truncated=t >= self.number_of_steps,
        )
        return StepCountState(t=t), result
