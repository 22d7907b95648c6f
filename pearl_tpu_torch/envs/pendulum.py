"""Pendulum-v1 as batched tensor math (port of `pearl_tpu/envs/pendulum.py`,
Gymnasium's dynamics).

The reference writes one env's step and vmaps it; here the step is written
over (B,) tensors directly, operation for operation in float32. The torque is
clamped before the cost, episodes never terminate and truncate at
`max_steps`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxActionSpace, BoxSpace
from pearl_tpu_torch.api.types import ActionResult


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """Into [-pi, pi): a floor-mod (`torch.remainder`, the sign of the
    divisor, as JAX's `%`), not `torch.fmod`, which keeps the sign of x."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


@dataclasses.dataclass
class PendulumState:
    theta: torch.Tensor  # (B,)
    theta_dot: torch.Tensor  # (B,)
    t: torch.Tensor  # (B,) i32 step count


@dataclasses.dataclass(frozen=True)
class Pendulum(Environment):
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0  # noqa: E741 (the reference's name)
    max_steps: int = 200
    # When True, `cost` is the squared torque normalized to [-1, 1], the
    # reference's gym_avg_torque_cost wrapper.
    emit_torque_cost: bool = False

    @property
    def action_space(self) -> BoxActionSpace:
        return BoxActionSpace.create(-self.max_torque, self.max_torque)

    @property
    def observation_space(self) -> BoxSpace:
        high = [1.0, 1.0, self.max_speed]
        return BoxSpace.create([-h for h in high], high)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    @staticmethod
    def _obs(theta, theta_dot):
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], dim=-1)

    def reset(
        self, num_envs: int, generator: torch.Generator, device: torch.device
    ) -> Tuple[PendulumState, torch.Tensor]:
        """theta uniform on [-pi, pi), theta_dot on [-1, 1), in one draw."""
        u = torch.rand((2, num_envs), generator=generator, device=device)
        theta = u[0] * (2 * math.pi) - math.pi
        theta_dot = u[1] * 2.0 - 1.0
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return PendulumState(theta=theta, theta_dot=theta_dot, t=t), self._obs(theta, theta_dot)

    def step(
        self, state: PendulumState, action: torch.Tensor
    ) -> Tuple[PendulumState, ActionResult]:
        u = torch.clamp(action[:, 0], -self.max_torque, self.max_torque)
        th, thdot = state.theta, state.theta_dot
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3 * self.g / (2 * self.l) * torch.sin(th) + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        t = state.t + 1
        result = ActionResult(
            observation=self._obs(newth, newthdot),
            reward=-cost,
            terminated=torch.zeros_like(t, dtype=torch.bool),
            truncated=t >= self.max_steps,
            cost=(u / self.max_torque) ** 2 if self.emit_torque_cost else None,
        )
        return PendulumState(theta=newth, theta_dot=newthdot, t=t), result
