"""CartPole-v1 as batched tensor math (port of `pearl_tpu/envs/cartpole.py`).

The reference writes one env's step and vmaps it; here the step is written
over the (B, 4) physics batch directly. The explicit Euler update, the
thresholds, the reward of 1.0 and truncation at `max_steps` are the
reference's, operation for operation, in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass
class CartPoleState:
    physics: torch.Tensor  # (B, 4) = [x, x_dot, theta, theta_dot]
    t: torch.Tensor  # (B,) i32 step count


@dataclasses.dataclass(frozen=True)
class CartPole(Environment):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half pole length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * math.pi / 360
    x_threshold: float = 2.4
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(2)

    @property
    def observation_space(self) -> BoxSpace:
        inf = float("inf")
        high = [self.x_threshold * 2, inf, self.theta_threshold * 2, inf]
        return BoxSpace.create([-h for h in high], high)

    def reset(
        self, num_envs: int, generator: torch.Generator, device: torch.device
    ) -> Tuple[CartPoleState, torch.Tensor]:
        u = torch.rand((num_envs, 4), generator=generator, device=device)
        physics = u * 0.1 - 0.05  # uniform on [-0.05, 0.05)
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        return CartPoleState(physics=physics, t=t), physics

    def step(
        self, state: CartPoleState, action: torch.Tensor
    ) -> Tuple[CartPoleState, ActionResult]:
        a = action[:, 0].to(torch.int32)
        x, x_dot, theta, theta_dot = state.physics.unbind(-1)
        force = torch.where(a == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        # Euler integration (gymnasium default).
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc

        physics = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        t = state.t + 1
        terminated = (x.abs() > self.x_threshold) | (theta.abs() > self.theta_threshold)
        truncated = (t >= self.max_steps) & ~terminated
        result = ActionResult(
            observation=physics,
            reward=torch.ones_like(x),
            terminated=terminated,
            truncated=truncated,
        )
        return CartPoleState(physics=physics, t=t), result
