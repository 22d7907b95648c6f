"""FrozenLake-v1, 4x4, optionally slippery, batched (port of
`pearl_tpu/envs/frozen_lake.py`).

The observation is the one-hot of the cell (`one_hot_obs=True`) or its index
as a float (`DiscreteSpace.range(16)`). With `slippery=True` the move taken
is the intended one or one of its two neighbours, (a + {-1, 0, 1}) mod 4,
drawn uniformly: `step` draws the slip from the generator its state keeps
and calls `_transition`, which tests feed with the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace, DiscreteSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs._common import take

# 4x4 map: S=start, F=frozen, H=hole, G=goal.
_MAP_4X4 = "SFFFFHFHFFFHHFFG"
_HOLES = tuple(i for i, c in enumerate(_MAP_4X4) if c == "H")
_GOALS = tuple(i for i, c in enumerate(_MAP_4X4) if c == "G")
# Actions: 0=left, 1=down, 2=right, 3=up; the (row, col) move of each.
_DROW = (0, 1, 0, -1)
_DCOL = (-1, 0, 1, 0)


@dataclasses.dataclass
class FrozenLakeState:
    pos: torch.Tensor  # (B,) i32 cell index
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None  # the slip's draws, on the device


def _any_of(pos: torch.Tensor, cells) -> torch.Tensor:
    hit = torch.zeros_like(pos, dtype=torch.bool)
    for c in cells:
        hit = hit | (pos == c)
    return hit


@dataclasses.dataclass(frozen=True)
class FrozenLake(Environment):
    size: int = 4
    slippery: bool = True
    one_hot_obs: bool = True
    max_steps: int = 100

    @property
    def n_cells(self) -> int:
        return self.size * self.size

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(4)

    @property
    def observation_space(self):
        if self.one_hot_obs:
            return BoxSpace.create(torch.zeros(self.n_cells), torch.ones(self.n_cells))
        return DiscreteSpace.range(self.n_cells)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    def _obs(self, pos: torch.Tensor) -> torch.Tensor:
        if self.one_hot_obs:
            cells = torch.arange(self.n_cells, device=pos.device)
            return (pos[:, None] == cells).to(torch.float32)
        return pos.to(torch.float32)[:, None]

    def reset(self, num_envs, generator, device) -> Tuple[FrozenLakeState, torch.Tensor]:
        pos = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = FrozenLakeState(pos=pos, t=torch.zeros_like(pos), generator=generator)
        return state, self._obs(pos)

    def _transition(self, state: FrozenLakeState, action: torch.Tensor,
                    slip: Optional[torch.Tensor] = None):
        """`slip` (B,) i32 in {-1, 0, 1}; used only when slippery."""
        a = action[:, 0].to(torch.int32)
        if self.slippery:
            a = (a + slip.to(torch.int32)) % 4  # a floor mod, as JAX's: -1 % 4 = 3
        row, col = state.pos // self.size, state.pos % self.size
        row = (row + take(_DROW, a, torch.int32)).clamp(0, self.size - 1)
        col = (col + take(_DCOL, a, torch.int32)).clamp(0, self.size - 1)
        pos = row * self.size + col
        reached_goal, fell = _any_of(pos, _GOALS), _any_of(pos, _HOLES)
        t = state.t + 1
        terminated = reached_goal | fell
        truncated = (t >= self.max_steps) & ~terminated
        result = ActionResult(
            observation=self._obs(pos),
            reward=reached_goal.to(torch.float32),
            terminated=terminated,
            truncated=truncated,
        )
        return dataclasses.replace(state, pos=pos, t=t), result

    def step(self, state: FrozenLakeState, action: torch.Tensor):
        slip = None
        if self.slippery:
            slip = torch.randint(-1, 2, (action.shape[0],), generator=state.generator,
                                 device=action.device, dtype=torch.int32)
        return self._transition(state, action, slip)
