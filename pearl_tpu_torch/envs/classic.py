"""MountainCar (discrete and continuous) and Acrobot, batched (port of
`pearl_tpu/envs/classic.py`, Gymnasium's dynamics).

Each step is the reference's per-env step written over (B,) tensors,
operation for operation in float32: the same Python constants combined in
the same order, so that one step agrees with XLA's to an ulp of its sin and
cos. The angle wrap is a floor mod (`%`, as JAX's), never `torch.fmod`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxActionSpace, BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs._common import uniform


@dataclasses.dataclass
class MountainCarState:
    position: torch.Tensor  # (B,)
    velocity: torch.Tensor  # (B,)
    t: torch.Tensor  # (B,) i32


@dataclasses.dataclass(frozen=True)
class MountainCar(Environment):
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    force: float = 0.001
    gravity: float = 0.0025
    max_steps: int = 200

    @property
    def action_space(self):
        return DiscreteActionSpace.discrete(3)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create(
            [self.min_position, -self.max_speed], [self.max_position, self.max_speed]
        )

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    def reset(self, num_envs, generator, device) -> Tuple[MountainCarState, torch.Tensor]:
        position = uniform((num_envs,), -0.6, -0.4, generator, device)
        velocity = torch.zeros_like(position)
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = MountainCarState(position=position, velocity=velocity, t=t)
        return state, torch.stack([position, velocity], dim=-1)

    def _advance(self, state: MountainCarState, velocity: torch.Tensor, goal: float):
        velocity = velocity.clamp(-self.max_speed, self.max_speed)
        position = (state.position + velocity).clamp(self.min_position, self.max_position)
        velocity = torch.where((position <= self.min_position) & (velocity < 0), 0.0, velocity)
        t = state.t + 1
        terminated = position >= goal
        truncated = (t >= self.max_steps) & ~terminated
        new_state = MountainCarState(position=position, velocity=velocity, t=t)
        return new_state, torch.stack([position, velocity], dim=-1), terminated, truncated

    def step(self, state: MountainCarState, action: torch.Tensor):
        a = action[:, 0].to(torch.int32)
        velocity = state.velocity + (a - 1) * self.force - torch.cos(
            3 * state.position
        ) * self.gravity
        new_state, obs, terminated, truncated = self._advance(
            state, velocity, self.goal_position
        )
        result = ActionResult(
            observation=obs,
            reward=torch.full_like(obs[:, 0], -1.0),
            terminated=terminated,
            truncated=truncated,
        )
        return new_state, result


@dataclasses.dataclass(frozen=True)
class ContinuousMountainCar(MountainCar):
    power: float = 0.0015
    max_steps: int = 999

    @property
    def action_space(self) -> BoxActionSpace:
        return BoxActionSpace.create(-1.0, 1.0)

    def step(self, state: MountainCarState, action: torch.Tensor):
        force = action[:, 0].clamp(-1.0, 1.0)
        velocity = state.velocity + force * self.power - 0.0025 * torch.cos(3 * state.position)
        new_state, obs, terminated, truncated = self._advance(state, velocity, 0.45)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force**2
        result = ActionResult(
            observation=obs, reward=reward, terminated=terminated, truncated=truncated
        )
        return new_state, result


@dataclasses.dataclass
class AcrobotState:
    theta1: torch.Tensor  # (B,)
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor  # (B,) i32


@dataclasses.dataclass(frozen=True)
class Acrobot(Environment):
    """Two-link underactuated pendulum, RK4 over one `dt` (Gymnasium's
    'book' dynamics)."""

    dt: float = 0.2
    link_length_1: float = 1.0
    link_mass_1: float = 1.0
    link_mass_2: float = 1.0
    link_com_1: float = 0.5
    link_com_2: float = 0.5
    link_moi: float = 1.0
    max_vel_1: float = 4 * math.pi
    max_vel_2: float = 9 * math.pi
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(3)

    @property
    def observation_space(self) -> BoxSpace:
        high = [1.0, 1.0, 1.0, 1.0, self.max_vel_1, self.max_vel_2]
        return BoxSpace.create([-h for h in high], high)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    @staticmethod
    def _obs(s: AcrobotState) -> torch.Tensor:
        return torch.stack([
            torch.cos(s.theta1), torch.sin(s.theta1), torch.cos(s.theta2),
            torch.sin(s.theta2), s.dtheta1, s.dtheta2,
        ], dim=-1)

    def reset(self, num_envs, generator, device) -> Tuple[AcrobotState, torch.Tensor]:
        vals = uniform((num_envs, 4), -0.1, 0.1, generator, device)
        theta1, theta2, dtheta1, dtheta2 = vals.unbind(-1)
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = AcrobotState(theta1, theta2, dtheta1, dtheta2, t)
        return state, self._obs(state)

    def _dsdt(self, s, torque):
        """The reference's `_dsdt` on a tuple of four (B,) tensors."""
        m1, m2 = self.link_mass_1, self.link_mass_2
        l1 = self.link_length_1
        lc1, lc2 = self.link_com_1, self.link_com_2
        I1 = I2 = self.link_moi
        g = 9.8
        theta1, theta2, dtheta1, dtheta2 = s
        d1 = (
            m1 * lc1**2
            + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(theta2))
            + I1
            + I2
        )
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(theta2)) + I2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2**2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (
            torque
            + d2 / d1 * phi1
            - m2 * l1 * lc2 * dtheta1**2 * torch.sin(theta2)
            - phi2
        ) / (m2 * lc2**2 + I2 - d2**2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return (dtheta1, dtheta2, ddtheta1, ddtheta2)

    def step(self, state: AcrobotState, action: torch.Tensor):
        a = action[:, 0].to(torch.int32)
        torque = (a - 1).to(torch.float32)  # {-1, 0, 1}
        s0 = (state.theta1, state.theta2, state.dtheta1, state.dtheta2)

        def shifted(k, h):
            return tuple(s + h * ki for s, ki in zip(s0, k))

        k1 = self._dsdt(s0, torque)
        k2 = self._dsdt(shifted(k1, self.dt / 2), torque)
        k3 = self._dsdt(shifted(k2, self.dt / 2), torque)
        k4 = self._dsdt(shifted(k3, self.dt), torque)
        s1 = tuple(
            s + self.dt / 6.0 * (a1 + 2 * a2 + 2 * a3 + a4)
            for s, a1, a2, a3, a4 in zip(s0, k1, k2, k3, k4)
        )

        def wrap(x):
            return ((x + math.pi) % (2 * math.pi)) - math.pi

        theta1, theta2 = wrap(s1[0]), wrap(s1[1])
        dtheta1 = s1[2].clamp(-self.max_vel_1, self.max_vel_1)
        dtheta2 = s1[3].clamp(-self.max_vel_2, self.max_vel_2)
        t = state.t + 1
        terminated = -torch.cos(theta1) - torch.cos(theta2 + theta1) > 1.0
        truncated = (t >= self.max_steps) & ~terminated
        new_state = AcrobotState(theta1, theta2, dtheta1, dtheta2, t)
        result = ActionResult(
            observation=self._obs(new_state),
            reward=torch.where(terminated, 0.0, -1.0),
            terminated=terminated,
            truncated=truncated,
        )
        return new_state, result
