"""Sparse-reward 2-D point reach (port of `pearl_tpu/envs/sparse_reward.py`),
batched over B envs as tensor math.

Observation = [position (2), goal (2)]. The reward is -1 every step until the
agent is within `reward_distance` of the goal, then 0 and the episode
terminates; a step moves the position and clips it to [0, length]. An
episode is truncated at `max_steps` only if the goal was not reached. The
setting HER is made for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxActionSpace, BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass
class SparseRewardState:
    position: torch.Tensor  # (B, 2)
    goal: torch.Tensor  # (B, 2)
    t: torch.Tensor  # (B,) i32 step count


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteSparseRewardEnvironment(Environment):
    """`num_actions` compass directions, a fixed step size."""

    length: float = 100.0
    num_actions: int = 4
    step_size: float = 4.0
    reward_distance: float = 4.0
    max_steps: int = 50

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(self.num_actions)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create([0.0] * 4, [self.length] * 4)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    @staticmethod
    def _obs(state: SparseRewardState) -> torch.Tensor:
        return torch.cat([state.position, state.goal], dim=-1)

    def reset(
        self, num_envs: int, generator: torch.Generator, device: torch.device
    ) -> Tuple[SparseRewardState, torch.Tensor]:
        """Position and goal uniform on [0, length)^2, in one draw."""
        u = torch.rand((2, num_envs, 2), generator=generator, device=device) * self.length
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = SparseRewardState(position=u[0], goal=u[1], t=t)
        return state, self._obs(state)

    def _delta(self, action: torch.Tensor) -> torch.Tensor:
        angle = 2.0 * math.pi * action[:, 0].to(torch.int32) / self.num_actions
        return self.step_size * torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)

    def step(
        self, state: SparseRewardState, action: torch.Tensor
    ) -> Tuple[SparseRewardState, ActionResult]:
        position = torch.clamp(state.position + self._delta(action), 0.0, self.length)
        reached = torch.linalg.vector_norm(position - state.goal, dim=-1) < self.reward_distance
        t = state.t + 1
        new_state = SparseRewardState(position=position, goal=state.goal, t=t)
        result = ActionResult(
            observation=self._obs(new_state),
            reward=torch.where(reached, 0.0, -1.0),
            terminated=reached,
            truncated=(t >= self.max_steps) & ~reached,
        )
        return new_state, result


@dataclasses.dataclass(frozen=True, eq=False)
class ContinuousSparseRewardEnvironment(DiscreteSparseRewardEnvironment):
    """The action is the displacement itself, clipped to +-step_size."""

    @property
    def action_space(self) -> BoxActionSpace:
        return BoxActionSpace.create([-self.step_size] * 2, [self.step_size] * 2)

    def _delta(self, action: torch.Tensor) -> torch.Tensor:
        return torch.clamp(action.reshape(-1, 2), -self.step_size, self.step_size)
