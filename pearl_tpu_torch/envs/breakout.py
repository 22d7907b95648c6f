"""MinAtar-style Breakout, batched (port of `pearl_tpu/envs/breakout.py`).

A 10x10 grid with 4 feature channels [paddle, ball, ball trail, bricks],
flattened HWC into (B, 400): the layout `CNNQValueNetwork(input_shape=(10,
10, 4))` reads. Actions 0 left, 1 stay, 2 right. The ball bounces off the
side walls, the ceiling, a live brick (+1, the brick goes) and the paddle; a
miss terminates; a cleared wall is rebuilt. The step draws nothing.

Positions stay int32 in the state as in the reference; the one lookup,
`bricks[brick_r, ncol]`, is a comparison with a clamped index (a JAX gather
clamps), never a gather that could leave the table.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass
class BreakoutState:
    ball: torch.Tensor  # (B, 2) i32 [row, col]
    last_ball: torch.Tensor  # (B, 2) i32
    ddir: torch.Tensor  # (B, 2) i32 in {-1, 1}^2
    paddle: torch.Tensor  # (B,) i32 column
    bricks: torch.Tensor  # (B, brick_rows, cols) bool
    t: torch.Tensor  # (B,) i32


@dataclasses.dataclass(frozen=True)
class Breakout(Environment):
    rows: int = 10
    cols: int = 10
    brick_rows: int = 3
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(3)

    @property
    def observation_space(self) -> BoxSpace:
        n = self.rows * self.cols * 4
        return BoxSpace.create(torch.zeros(n), torch.ones(n))

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    def _cell(self, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        """(B, rows, cols) float32 one-hot of each env's cell (row, col)."""
        r = torch.arange(self.rows, device=row.device)
        c = torch.arange(self.cols, device=row.device)
        return ((r[:, None] == row[:, None, None]) & (c == col[:, None, None])).to(torch.float32)

    def _obs(self, s: BreakoutState) -> torch.Tensor:
        B = s.paddle.shape[0]
        bottom = torch.full_like(s.paddle, self.rows - 1)
        brick_grid = torch.zeros((B, self.rows, self.cols), device=s.paddle.device)
        brick_grid[:, 1:1 + self.brick_rows] = s.bricks.to(torch.float32)
        grid = torch.stack([
            self._cell(bottom, s.paddle),
            self._cell(s.ball[:, 0], s.ball[:, 1]),
            self._cell(s.last_ball[:, 0], s.last_ball[:, 1]),
            brick_grid,
        ], dim=-1)  # (B, rows, cols, 4)
        return grid.reshape(B, -1)

    def reset(self, num_envs, generator, device) -> Tuple[BreakoutState, torch.Tensor]:
        col = torch.randint(0, self.cols, (num_envs,), generator=generator, device=device,
                            dtype=torch.int32)
        side = torch.randint(0, 2, (num_envs,), generator=generator, device=device,
                             dtype=torch.int32)
        ball = torch.stack([torch.full_like(col, self.brick_rows + 1), col], dim=-1)
        ddir = torch.stack([torch.ones_like(col), side * 2 - 1], dim=-1)
        state = BreakoutState(
            ball=ball,
            last_ball=ball,
            ddir=ddir,
            paddle=torch.full_like(col, self.cols // 2),
            bricks=torch.ones((num_envs, self.brick_rows, self.cols), dtype=torch.bool,
                              device=device),
            t=torch.zeros_like(col),
        )
        return state, self._obs(state)

    def step(self, state: BreakoutState, action: torch.Tensor):
        a = action[:, 0].to(torch.int32)
        paddle = (state.paddle + (a - 1)).clamp(0, self.cols - 1)

        ball, ddir = state.ball, state.ddir
        # Side walls.
        ncol = ball[:, 1] + ddir[:, 1]
        bounce_h = (ncol < 0) | (ncol >= self.cols)
        dcol = torch.where(bounce_h, -ddir[:, 1], ddir[:, 1])
        ncol = ball[:, 1] + dcol
        # Ceiling.
        nrow = ball[:, 0] + ddir[:, 0]
        bounce_top = nrow < 0
        drow = torch.where(bounce_top, -ddir[:, 0], ddir[:, 0])
        nrow = ball[:, 0] + drow

        # A live brick at the new position, inside the brick band.
        in_band = (nrow >= 1) & (nrow < 1 + self.brick_rows)
        brick_r = (nrow - 1).clamp(0, self.brick_rows - 1)
        r = torch.arange(self.brick_rows, device=a.device)
        c = torch.arange(self.cols, device=a.device)
        at = (r[:, None] == brick_r[:, None, None]) & (
            c == ncol.clamp(0, self.cols - 1)[:, None, None]
        )  # (B, brick_rows, cols): the looked-up cell
        hit = in_band & (state.bricks & at).flatten(1).any(-1)
        # The write, as a JAX scatter, drops a column out of range.
        written = hit & (ncol >= 0) & (ncol < self.cols)
        bricks = state.bricks & ~(at & written[:, None, None])
        reward = hit.to(torch.float32)
        # Down off a brick.
        drow = torch.where(hit, -drow, drow)
        nrow = torch.where(hit, ball[:, 0] + drow, nrow)

        # The paddle, on the bottom row.
        at_bottom = nrow >= self.rows - 1
        on_paddle = at_bottom & (ncol == paddle)
        drow = torch.where(on_paddle, -1, drow)
        nrow = torch.where(on_paddle, self.rows - 2, nrow)
        missed = at_bottom & ~on_paddle

        # All bricks cleared: a fresh wall (MinAtar).
        cleared = ~bricks.flatten(1).any(-1)
        bricks = bricks | cleared[:, None, None]

        new_state = BreakoutState(
            ball=torch.stack([nrow.clamp(0, self.rows - 1), ncol], dim=-1),
            last_ball=ball,
            ddir=torch.stack([drow, dcol], dim=-1),
            paddle=paddle,
            bricks=bricks,
            t=state.t + 1,
        )
        terminated = missed
        truncated = (new_state.t >= self.max_steps) & ~terminated
        result = ActionResult(
            observation=self._obs(new_state),
            reward=reward,
            terminated=terminated,
            truncated=truncated,
        )
        return new_state, result
