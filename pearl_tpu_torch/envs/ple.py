"""The PLE games Catcher, FlappyBird, Pixelcopter and Pong, batched (port of
`pearl_tpu/envs/ple.py`; PuckWorld is in `puckworld.py`).

On-device versions of the PLE dynamics on PLE's non-visual state vector,
normalised to the unit square. PLE's reward conventions: +1 for a positive
event (a catch, a pipe or gate passed, a point scored), -1 for a negative
one (a miss, a point conceded), -5 for a terminal loss (a crash, the last
life).

Each game's `step` draws what it needs (a fruit's column, new pipe gaps, a
gate, a serve's angle) from the generator its state keeps, on every step,
and calls `_transition`, which tests feed with the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs._common import take, uniform

# 0 = left / up, 1 = right / down, 2 = noop.
_DIRECTION = (-1.0, 1.0, 0.0)


def _box(high):
    return BoxSpace.create([-h for h in high], list(high))


def _int_zeros(num_envs, device):
    return torch.zeros((num_envs,), dtype=torch.int32, device=device)


def _full(num_envs, value, device):
    return torch.full((num_envs,), value, dtype=torch.float32, device=device)


# ---------------------------------------------------------------- Catcher
@dataclasses.dataclass
class CatcherState:
    player_x: torch.Tensor  # (B,) paddle centre in [0, 1]
    player_vel: torch.Tensor  # (B,)
    fruit_x: torch.Tensor  # (B,) fruit centre
    fruit_y: torch.Tensor  # (B,) fruit height, 0 = top, 1 = the paddle's line
    lives: torch.Tensor  # (B,) i32
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class Catcher(Environment):
    """Actions 0 left, 1 right, 2 noop. Observation (B, 4): [player_x,
    player_vel, fruit_x, fruit_y]. +1 a catch, -1 a miss, -5 and terminate
    when the last of `init_lives` is lost."""

    accel: float = 0.021
    friction: float = 0.9
    fruit_speed: float = 0.01
    paddle_halfwidth: float = 0.1
    init_lives: int = 3
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(3)

    @property
    def observation_space(self) -> BoxSpace:
        return _box([1.0] * 4)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    @staticmethod
    def _obs(s: CatcherState) -> torch.Tensor:
        return torch.stack([s.player_x, s.player_vel, s.fruit_x, s.fruit_y], dim=-1)

    def reset(self, num_envs, generator, device) -> Tuple[CatcherState, torch.Tensor]:
        state = CatcherState(
            player_x=_full(num_envs, 0.5, device),
            player_vel=_full(num_envs, 0.0, device),
            fruit_x=uniform((num_envs,), 0.05, 0.95, generator, device),
            fruit_y=_full(num_envs, 0.0, device),
            lives=torch.full((num_envs,), self.init_lives, dtype=torch.int32, device=device),
            t=_int_zeros(num_envs, device),
            generator=generator,
        )
        return state, self._obs(state)

    def _transition(self, state: CatcherState, action: torch.Tensor, new_fruit_x: torch.Tensor):
        """`new_fruit_x` (B,): uniform on [0.05, 0.95), the column of a fruit
        that respawns this step."""
        a = action[:, 0].to(torch.int32)
        vel = state.player_vel * self.friction + take(_DIRECTION, a) * self.accel
        x = state.player_x + vel
        hit_wall = (x < 0.0) | (x > 1.0)
        x = x.clamp(0.0, 1.0)
        vel = torch.where(hit_wall, 0.0, vel)

        fruit_y = state.fruit_y + self.fruit_speed
        landed = fruit_y >= 1.0
        caught = landed & ((state.fruit_x - x).abs() <= self.paddle_halfwidth)
        missed = landed & ~caught

        lives = state.lives - missed.to(torch.int32)
        dead = lives <= 0
        reward = torch.where(caught, 1.0, 0.0) + torch.where(
            missed, torch.where(dead, -5.0, -1.0), 0.0
        )
        fruit_x = torch.where(landed, new_fruit_x, state.fruit_x)
        fruit_y = torch.where(landed, 0.0, fruit_y)

        t = state.t + 1
        new_state = dataclasses.replace(
            state, player_x=x, player_vel=vel, fruit_x=fruit_x, fruit_y=fruit_y, lives=lives, t=t
        )
        result = ActionResult(
            observation=self._obs(new_state), reward=reward, terminated=dead,
            truncated=t >= self.max_steps,
        )
        return new_state, result

    def step(self, state: CatcherState, action: torch.Tensor):
        draws = uniform((action.shape[0],), 0.05, 0.95, state.generator, action.device)
        return self._transition(state, action, draws)


# ------------------------------------------------------------- FlappyBird
@dataclasses.dataclass
class FlappyBirdState:
    player_y: torch.Tensor  # (B,) in [0, 1], 0 = top
    player_vel: torch.Tensor  # (B,) (+ down)
    pipe_x: torch.Tensor  # (B, 2) the two pipes' positions (may be > 1)
    gap_y: torch.Tensor  # (B, 2) their gap centres
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class FlappyBird(Environment):
    """Actions 0 flap, 1 noop. Observation (B, 8): [player_y, player_vel,
    next pipe's distance, gap top, gap bottom, the same of the pipe after].
    +1 a pipe passed, -5 and terminate on a crash."""

    gravity: float = 0.004
    flap_impulse: float = -0.025
    max_vel: float = 0.05
    scroll_speed: float = 0.02
    pipe_spacing: float = 0.75
    gap_halfheight: float = 0.12
    player_x: float = 0.2
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(2)

    @property
    def observation_space(self) -> BoxSpace:
        return _box([1.0, 1.0, 2.0, 1.0, 1.0, 2.0, 1.0, 1.0])

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    def _obs(self, s: FlappyBirdState) -> torch.Tensor:
        dist = s.pipe_x - self.player_x
        # A pipe already behind the bird sorts last; the first minimum wins.
        first = torch.argmin(torch.where(dist < -0.05, math.inf, dist), dim=-1)
        order = torch.stack([first, 1 - first], dim=-1)
        px = torch.gather(s.pipe_x, 1, order)
        gy = torch.gather(s.gap_y, 1, order)
        return torch.stack([
            s.player_y, s.player_vel,
            px[:, 0] - self.player_x, gy[:, 0] - self.gap_halfheight, gy[:, 0] + self.gap_halfheight,
            px[:, 1] - self.player_x, gy[:, 1] - self.gap_halfheight, gy[:, 1] + self.gap_halfheight,
        ], dim=-1)

    def reset(self, num_envs, generator, device) -> Tuple[FlappyBirdState, torch.Tensor]:
        state = FlappyBirdState(
            player_y=_full(num_envs, 0.5, device),
            player_vel=_full(num_envs, 0.0, device),
            pipe_x=torch.stack([_full(num_envs, 1.0, device),
                                _full(num_envs, 1.0 + self.pipe_spacing, device)], dim=-1),
            gap_y=uniform((num_envs, 2), 0.25, 0.75, generator, device),
            t=_int_zeros(num_envs, device),
            generator=generator,
        )
        return state, self._obs(state)

    def _transition(self, state: FlappyBirdState, action: torch.Tensor, new_gaps: torch.Tensor):
        """`new_gaps` (B, 2): uniform on [0.25, 0.75), the gap of each pipe
        recycled this step."""
        flap = action[:, 0].to(torch.int32) == 0
        vel = torch.where(flap, self.flap_impulse, state.player_vel + self.gravity)
        vel = vel.clamp(-self.max_vel, self.max_vel)
        y = state.player_y + vel

        pipe_x = state.pipe_x - self.scroll_speed
        passed = (pipe_x < self.player_x) & (state.pipe_x >= self.player_x)
        n_passed = passed.to(torch.float32).sum(-1)

        recycle = pipe_x < -0.1
        far = pipe_x.max(dim=-1).values
        pipe_x = torch.where(recycle, (far + self.pipe_spacing)[:, None], pipe_x)
        gap_y = torch.where(recycle, new_gaps, state.gap_y)

        in_pipe = (pipe_x - self.player_x).abs() < 0.05
        outside_gap = (y[:, None] - gap_y).abs() > self.gap_halfheight
        crashed = (in_pipe & outside_gap).any(-1) | (y < 0.0) | (y > 1.0)

        reward = n_passed + torch.where(crashed, -5.0, 0.0)
        t = state.t + 1
        new_state = dataclasses.replace(
            state, player_y=y.clamp(0.0, 1.0), player_vel=vel, pipe_x=pipe_x, gap_y=gap_y, t=t
        )
        result = ActionResult(
            observation=self._obs(new_state), reward=reward, terminated=crashed,
            truncated=t >= self.max_steps,
        )
        return new_state, result

    def step(self, state: FlappyBirdState, action: torch.Tensor):
        draws = uniform((action.shape[0], 2), 0.25, 0.75, state.generator, action.device)
        return self._transition(state, action, draws)


# ------------------------------------------------------------ Pixelcopter
@dataclasses.dataclass
class PixelcopterState:
    player_y: torch.Tensor  # (B,) in [0, 1]
    player_vel: torch.Tensor  # (B,) (+ down)
    phase: torch.Tensor  # (B,) the cavern's sine phase
    gate_x: torch.Tensor  # (B,) the next gate's distance ahead
    gate_y: torch.Tensor  # (B,) its gap centre
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class Pixelcopter(Environment):
    """Actions 0 tap, 1 noop. Observation (B, 7): [player_y, player_vel,
    distance to the ceiling, to the floor, next gate's distance, its block's
    top, bottom]. +1 a gate passed, -5 and terminate on a crash."""

    gravity: float = 0.004
    tap_impulse: float = -0.02
    max_vel: float = 0.04
    scroll_speed: float = 0.02
    cavern_halfheight: float = 0.3
    cavern_amp: float = 0.15
    cavern_freq: float = 0.8
    gate_spacing: float = 1.0
    gate_halfgap: float = 0.15
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(2)

    @property
    def observation_space(self) -> BoxSpace:
        return _box([1.0, 1.0, 1.0, 1.0, 2.0, 1.0, 1.0])

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    def _walls(self, phase: torch.Tensor):
        center = 0.5 + self.cavern_amp * torch.sin(phase)
        return center - self.cavern_halfheight, center + self.cavern_halfheight

    def _obs(self, s: PixelcopterState) -> torch.Tensor:
        ceil, floor = self._walls(s.phase)
        return torch.stack([
            s.player_y, s.player_vel, s.player_y - ceil, floor - s.player_y, s.gate_x,
            s.gate_y - self.gate_halfgap, s.gate_y + self.gate_halfgap,
        ], dim=-1)

    def reset(self, num_envs, generator, device) -> Tuple[PixelcopterState, torch.Tensor]:
        u = torch.rand((num_envs, 2), generator=generator, device=device)
        state = PixelcopterState(
            player_y=_full(num_envs, 0.5, device),
            player_vel=_full(num_envs, 0.0, device),
            phase=u[:, 0] * (2.0 * math.pi),
            gate_x=_full(num_envs, self.gate_spacing, device),
            gate_y=u[:, 1] * 0.3 + 0.35,
            t=_int_zeros(num_envs, device),
            generator=generator,
        )
        return state, self._obs(state)

    def _transition(self, state: PixelcopterState, action: torch.Tensor, new_gate_y: torch.Tensor):
        """`new_gate_y` (B,): uniform on [0.35, 0.65), the gap of a gate that
        comes in this step."""
        tap = action[:, 0].to(torch.int32) == 0
        vel = torch.where(
            tap, state.player_vel + self.tap_impulse, state.player_vel + self.gravity
        )
        vel = vel.clamp(-self.max_vel, self.max_vel)
        y = state.player_y + vel

        phase = state.phase + self.cavern_freq * self.scroll_speed * 2.0 * math.pi
        gate_x = state.gate_x - self.scroll_speed
        passed = gate_x < 0.0
        in_gate = gate_x.abs() < 0.04
        hit_block = in_gate & ((y - state.gate_y).abs() > self.gate_halfgap)

        ceil, floor = self._walls(phase)
        crashed = hit_block | (y <= ceil) | (y >= floor)

        gate_y = torch.where(passed, new_gate_y, state.gate_y)
        gate_x = torch.where(passed, gate_x + self.gate_spacing, gate_x)

        reward = torch.where(passed, 1.0, 0.0) + torch.where(crashed, -5.0, 0.0)
        t = state.t + 1
        new_state = dataclasses.replace(
            state, player_y=y, player_vel=vel, phase=phase, gate_x=gate_x, gate_y=gate_y, t=t
        )
        result = ActionResult(
            observation=self._obs(new_state), reward=reward, terminated=crashed,
            truncated=t >= self.max_steps,
        )
        return new_state, result

    def step(self, state: PixelcopterState, action: torch.Tensor):
        draws = uniform((action.shape[0],), 0.35, 0.65, state.generator, action.device)
        return self._transition(state, action, draws)


# ------------------------------------------------------------------- Pong
@dataclasses.dataclass
class PongState:
    player_y: torch.Tensor  # (B,) the agent's paddle centre (left)
    player_vel: torch.Tensor  # (B,)
    cpu_y: torch.Tensor  # (B,) the CPU's paddle centre (right)
    ball: torch.Tensor  # (B, 2)
    ball_vel: torch.Tensor  # (B, 2)
    player_score: torch.Tensor  # (B,) i32
    cpu_score: torch.Tensor  # (B,) i32
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class Pong(Environment):
    """Actions 0 up, 1 down, 2 noop. Observation (B, 7): [player_y,
    player_vel, cpu_y, ball x, y, ball velocity x, y]. +1 when the agent
    scores, -1 when the CPU does; the match ends at `max_score`."""

    accel: float = 0.015
    friction: float = 0.9
    paddle_halfheight: float = 0.1
    ball_speed: float = 0.03
    cpu_speed: float = 0.012
    max_score: int = 5
    max_steps: int = 500

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(3)

    @property
    def observation_space(self) -> BoxSpace:
        return _box([1.0] * 7)

    @property
    def max_episode_steps(self) -> int:
        return self.max_steps

    @staticmethod
    def _obs(s: PongState) -> torch.Tensor:
        return torch.cat([
            torch.stack([s.player_y, s.player_vel, s.cpu_y], dim=-1), s.ball, s.ball_vel
        ], dim=-1)

    def _serve(self, ang: torch.Tensor, toward_player: torch.Tensor):
        """The ball at the centre, served at angle `ang` (uniform on
        [-0.5, 0.5)) toward the given side."""
        sign = torch.where(toward_player, -1.0, 1.0)
        vel = self.ball_speed * torch.stack([sign * torch.cos(ang), torch.sin(ang)], dim=-1)
        return torch.full_like(vel, 0.5), vel

    def reset(self, num_envs, generator, device) -> Tuple[PongState, torch.Tensor]:
        ang = uniform((num_envs,), -0.5, 0.5, generator, device)
        ball, ball_vel = self._serve(ang, torch.ones_like(ang, dtype=torch.bool))
        state = PongState(
            player_y=_full(num_envs, 0.5, device),
            player_vel=_full(num_envs, 0.0, device),
            cpu_y=_full(num_envs, 0.5, device),
            ball=ball,
            ball_vel=ball_vel,
            player_score=_int_zeros(num_envs, device),
            cpu_score=_int_zeros(num_envs, device),
            t=_int_zeros(num_envs, device),
            generator=generator,
        )
        return state, self._obs(state)

    def _paddle_bounce(self, bx, by, vx, vy, paddle_y, at_left: bool):
        """Reflect x and add english where the ball crosses a paddle's plane
        (the agent's at x = 0.05, the CPU's at 0.95) moving outward."""
        plane = 0.05 if at_left else 0.95
        crossing = (bx < plane) if at_left else (bx > plane)
        moving_out = (vx < 0) if at_left else (vx > 0)
        hit = crossing & moving_out & ((by - paddle_y).abs() <= self.paddle_halfheight)
        vx = torch.where(hit, -vx, vx)
        english = (by - paddle_y) / self.paddle_halfheight * 0.01
        vy = torch.where(hit, vy + english, vy)
        bx = torch.where(hit, plane, bx)
        return bx, vx, vy

    def _transition(self, state: PongState, action: torch.Tensor, serve_ang: torch.Tensor):
        """`serve_ang` (B,): uniform on [-0.5, 0.5), the angle of a serve
        this step."""
        a = action[:, 0].to(torch.int32)
        vel = state.player_vel * self.friction + take(_DIRECTION, a) * self.accel
        player_y = (state.player_y + vel).clamp(0.0, 1.0)

        cpu_y = state.cpu_y + (state.ball[:, 1] - state.cpu_y).clamp(
            -self.cpu_speed, self.cpu_speed
        )

        bx, by = (state.ball + state.ball_vel).unbind(-1)
        vx, vy = state.ball_vel.unbind(-1)
        bounce = (by < 0.0) | (by > 1.0)
        vy = torch.where(bounce, -vy, vy)
        by = by.clamp(0.0, 1.0)

        bx, vx, vy = self._paddle_bounce(bx, by, vx, vy, player_y, at_left=True)
        bx, vx, vy = self._paddle_bounce(bx, by, vx, vy, cpu_y, at_left=False)

        player_point = bx > 1.0
        cpu_point = bx < 0.0
        scored = (player_point | cpu_point)[:, None]
        serve_ball, serve_vel = self._serve(serve_ang, player_point)
        ball = torch.where(scored, serve_ball, torch.stack([bx, by], dim=-1))
        bvel = torch.where(scored, serve_vel, torch.stack([vx, vy], dim=-1))

        player_score = state.player_score + player_point.to(torch.int32)
        cpu_score = state.cpu_score + cpu_point.to(torch.int32)
        done = (player_score >= self.max_score) | (cpu_score >= self.max_score)

        reward = torch.where(player_point, 1.0, 0.0) + torch.where(cpu_point, -1.0, 0.0)
        t = state.t + 1
        new_state = dataclasses.replace(
            state, player_y=player_y, player_vel=vel, cpu_y=cpu_y, ball=ball, ball_vel=bvel,
            player_score=player_score, cpu_score=cpu_score, t=t,
        )
        result = ActionResult(
            observation=self._obs(new_state), reward=reward, terminated=done,
            truncated=t >= self.max_steps,
        )
        return new_state, result

    def step(self, state: PongState, action: torch.Tensor):
        draws = uniform((action.shape[0],), -0.5, 0.5, state.generator, action.device)
        return self._transition(state, action, draws)
