"""PuckWorld, batched (port of `pearl_tpu/envs/puckworld.py`, the PLE
dynamics on the unit square).

Five accelerations (0 noop, 1 left, 2 right, 3 up, 4 down) with friction; a
wall clamps the position and zeroes that velocity component; a creep pursues
the agent and penalises it inside its disc; the target relocates every
`good_relocate_steps`. Observation (B, 8): [agent x, y, velocity x, y, target
x, y, creep x, y], PLE's `getGameState` order.

`step` draws the relocation from the generator its state keeps (every step,
used where the cadence falls) and calls `_transition`, which tests feed with
the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs._common import take

# The (x, y) direction of each action.
_DIR_X = (0.0, -1.0, 1.0, 0.0, 0.0)
_DIR_Y = (0.0, 0.0, 0.0, 1.0, -1.0)


@dataclasses.dataclass
class PuckWorldState:
    pos: torch.Tensor  # (B, 2) agent position in [0, 1]^2
    vel: torch.Tensor  # (B, 2)
    good: torch.Tensor  # (B, 2) target position
    bad: torch.Tensor  # (B, 2) creep position
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None  # the relocation draws, on the device


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


@dataclasses.dataclass(frozen=True)
class PuckWorld(Environment):
    accel: float = 0.08
    friction: float = 0.95
    bad_speed: float = 0.01
    bad_radius: float = 0.3
    good_relocate_steps: int = 300
    max_steps: int = 1000

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(5)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create([-1.0] * 8, [1.0] * 8)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    @staticmethod
    def _obs(s: PuckWorldState) -> torch.Tensor:
        return torch.cat([s.pos, s.vel, s.good, s.bad], dim=-1)

    def reset(self, num_envs, generator, device) -> Tuple[PuckWorldState, torch.Tensor]:
        u = torch.rand((num_envs, 3, 2), generator=generator, device=device)
        state = PuckWorldState(
            pos=u[:, 0], vel=torch.zeros_like(u[:, 0]), good=u[:, 1], bad=u[:, 2],
            t=torch.zeros((num_envs,), dtype=torch.int32, device=device), generator=generator,
        )
        return state, self._obs(state)

    def _transition(self, state: PuckWorldState, action: torch.Tensor, new_good: torch.Tensor):
        """`new_good` (B, 2): uniform draws on [0, 1), the target's next place
        where it relocates this step."""
        a = action[:, 0].to(torch.int32)
        dirs = torch.stack([take(_DIR_X, a), take(_DIR_Y, a)], dim=-1)
        vel = state.vel * self.friction + dirs * self.accel
        pos = state.pos + vel
        hit = (pos < 0.0) | (pos > 1.0)
        pos = pos.clamp(0.0, 1.0)
        vel = torch.where(hit, 0.0, vel)

        to_agent = pos - state.bad
        dist_bad_prev = _norm(to_agent) + 1e-8
        bad = state.bad + to_agent / dist_bad_prev[:, None] * self.bad_speed

        t = state.t + 1
        relocate = (t % self.good_relocate_steps) == 0
        good = torch.where(relocate[:, None], new_good, state.good)

        dist_good = _norm(pos - good)
        dist_bad = _norm(pos - bad)
        penalty = torch.where(
            dist_bad < self.bad_radius,
            -2.0 * (self.bad_radius - dist_bad) / self.bad_radius,
            0.0,
        )
        reward = -dist_good + penalty
        new_state = dataclasses.replace(state, pos=pos, vel=vel, good=good, bad=bad, t=t)
        result = ActionResult(
            observation=self._obs(new_state),
            reward=reward,
            terminated=torch.zeros_like(relocate),
            truncated=t >= self.max_steps,
        )
        return new_state, result

    def step(self, state: PuckWorldState, action: torch.Tensor):
        new_good = torch.rand((action.shape[0], 2), generator=state.generator,
                              device=action.device)
        return self._transition(state, action, new_good)
