"""Atari-shaped synthetic frame environment (port of
`pearl_tpu/envs/synthetic_visual.py`).

Frames of the Atari shape from a cheap procedural generator, a phase-shifted
sinusoid grid, so that the CNN act and learn path can be measured at 84x84
frames without an emulator. The reward is 1 when the action matches a phase
bit readable from the frame, so a learner has a real (if trivial) signal.

The reference writes one env's step and vmaps it; here reset and step are
written over the batch directly. The grid is summed in float32 in the
reference's order, `phase + 0.11 h + 0.07 w + 0.5 f + 0.31 t`, and cast to
`obs_dtype` after the sine.

On the card, `VectorEnv.step` goes through `step_autoreset`, which makes a
step's terminal and auto-reset frames in one kernel (`ops.synthetic_frames`,
the same frames bit for bit) instead of two `_obs` grids and a `where`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.ops.synthetic_frames import synthetic_frames
from pearl_tpu_torch.utils.pytree import tree_select


@dataclasses.dataclass
class SyntheticAtariState:
    phase: torch.Tensor  # (B,) f32 frame-generator phase
    t: torch.Tensor  # (B,) i32 step count


@dataclasses.dataclass(frozen=True)
class SyntheticAtari(Environment):
    height: int = 84
    width: int = 84
    frames: int = 4
    num_actions: int = 6
    episode_len: int = 128
    # Frame emission dtype (e.g. torch.bfloat16, which the ring and the CNN
    # act path consume as it is). None keeps float32.
    obs_dtype: Optional[torch.dtype] = None

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(self.num_actions)

    @property
    def observation_space(self) -> BoxSpace:
        n = self.height * self.width * self.frames
        return BoxSpace.create(-torch.ones(n), torch.ones(n))

    @property
    def max_episode_steps(self) -> int:
        return self.episode_len

    def _obs(self, state: SyntheticAtariState) -> torch.Tensor:
        device = state.phase.device
        h = torch.arange(self.height, dtype=torch.float32, device=device)[None, :, None, None]
        w = torch.arange(self.width, dtype=torch.float32, device=device)[None, None, :, None]
        f = torch.arange(self.frames, dtype=torch.float32, device=device)[None, None, None, :]
        phase = state.phase[:, None, None, None]
        t = state.t.to(torch.float32)[:, None, None, None]
        grid = torch.sin(phase + 0.11 * h + 0.07 * w + 0.5 * f + 0.31 * t)
        if self.obs_dtype is not None:
            grid = grid.to(self.obs_dtype)
        return grid.reshape(grid.shape[0], -1)

    def reset(
        self, num_envs: int, generator: torch.Generator, device: torch.device
    ) -> Tuple[SyntheticAtariState, torch.Tensor]:
        phase = torch.rand((num_envs,), generator=generator, device=device) * 6.28
        state = SyntheticAtariState(
            phase=phase, t=torch.zeros((num_envs,), dtype=torch.int32, device=device)
        )
        return state, self._obs(state)

    def _advance(self, state: SyntheticAtariState, action: torch.Tensor):
        """The step's new state, reward, terminated and truncated."""
        a = action[:, 0].to(torch.int32)
        # The right action is a function of phase and time that the frame shows.
        target = (torch.floor(state.phase * 10.0).to(torch.int32) + state.t) % self.num_actions
        reward = torch.where(a == target, 1.0, 0.0)
        t = state.t + 1
        new_state = SyntheticAtariState(phase=state.phase, t=t)
        return new_state, reward, torch.zeros_like(t, dtype=torch.bool), t >= self.episode_len

    def step(
        self, state: SyntheticAtariState, action: torch.Tensor
    ) -> Tuple[SyntheticAtariState, ActionResult]:
        new_state, reward, terminated, truncated = self._advance(state, action)
        result = ActionResult(
            observation=self._obs(new_state), reward=reward, terminated=terminated,
            truncated=truncated,
        )
        return new_state, result

    @staticmethod
    def _frames_kernel_applies(device: torch.device, dtype: torch.dtype) -> bool:
        """Whether `step_autoreset` makes the frames with the kernel: CUDA
        tensors and a float32 or bfloat16 `obs_dtype`."""
        return device.type == "cuda" and dtype in (torch.float32, torch.bfloat16)

    def step_autoreset(
        self, state: SyntheticAtariState, action: torch.Tensor,
        generator: Optional[torch.Generator],
    ) -> Optional[Tuple[SyntheticAtariState, ActionResult, torch.Tensor]]:
        """`VectorEnv.step`'s (next_states, result, next_obs) with auto-reset,
        both frame batches from one `synthetic_frames` kernel; the same
        values and the same draw from `generator` as `step`, `reset` and a
        select. None where the kernel does not apply (CPU tensors, or an
        `obs_dtype` other than float32 and bfloat16): the caller then takes
        that path."""
        dtype = self.obs_dtype or torch.float32
        device = state.phase.device
        if not self._frames_kernel_applies(device, dtype):
            return None
        new_state, reward, terminated, truncated = self._advance(state, action)
        # `reset`'s draw, at the point where the caller would reset.
        fresh_phase = torch.rand((state.phase.shape[0],), generator=generator, device=device) * 6.28
        fresh = SyntheticAtariState(phase=fresh_phase, t=torch.zeros_like(state.t))
        done = terminated | truncated
        next_state = tree_select(done, fresh, new_state)
        obs, next_obs = synthetic_frames(
            state.phase, state.t, fresh_phase, done,
            H=self.height, W=self.width, frames=self.frames, dtype=dtype)
        result = ActionResult(
            observation=obs, reward=reward, terminated=terminated, truncated=truncated)
        return next_state, result, next_obs
