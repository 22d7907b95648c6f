"""Environment wrappers (port of part of `pearl_tpu/envs/wrappers.py`):
partial observability, the safety cost and a dynamic action space, batched
over B envs.

- `PartialObservabilityWrapper`: only `observed_indices` of the observation
  (CartPole (0, 2): positions, velocities hidden).
- `SafetyWrapper`: cost = 1 where `risky_fn(observation, action)` holds,
  into `ActionResult.cost` (and `info["risky_sa"]`); with
  `noisy_reward_sigma > 0` a risky step also adds N(mean, sigma) to the
  reward, one draw per env per step.
- `DynamicActionSpaceWrapper`: the last `num_masked` actions are unavailable
  on steps where (t // interval) is odd, from each env's own step count.

`Environment.step` takes no generator, so the safety wrapper's state holds
the generator it was reset with (the vector env resets from the step's
generator) and draws its reward noise from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace


@dataclasses.dataclass(frozen=True, eq=False)
class EnvWrapper(Environment):
    env: Environment = None

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def max_episode_steps(self):
        return self.env.max_episode_steps

    def reset(self, num_envs, generator, device):
        return self.env.reset(num_envs, generator, device)

    def step(self, state, action):
        return self.env.step(state, action)


@dataclasses.dataclass(frozen=True, eq=False)
class PartialObservabilityWrapper(EnvWrapper):
    """Expose only `observed_indices` of the observation."""

    observed_indices: Sequence[int] = (0,)

    @property
    def observation_space(self):
        base = self.env.observation_space
        idx = list(self.observed_indices)
        return BoxSpace.create(base.low[idx], base.high[idx])

    def _project(self, obs):
        # One stack of column views: an index list would be copied to the
        # card at every step, a host sync.
        return torch.stack([obs[..., i] for i in self.observed_indices], dim=-1)

    def reset(self, num_envs, generator, device):
        state, obs = self.env.reset(num_envs, generator, device)
        return state, self._project(obs)

    def step(self, state, action):
        state, result = self.env.step(state, action)
        return state, dataclasses.replace(result, observation=self._project(result.observation))


@dataclasses.dataclass
class SafetyWrapperState:
    env: Any  # the wrapped env's state
    generator: torch.Generator  # the reward noise's draws, on the device


@dataclasses.dataclass(frozen=True, eq=False)
class SafetyWrapper(EnvWrapper):
    """cost = 1{risky_fn(observation, action)} as float32 (B,); with
    `noisy_reward_sigma > 0` a risky step's reward gains
    `noisy_reward_mean + noisy_reward_sigma * N(0, 1)`."""

    risky_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = None
    noisy_reward_sigma: float = 0.0
    noisy_reward_mean: float = 0.01

    def reset(self, num_envs, generator, device):
        state, obs = self.env.reset(num_envs, generator, device)
        return SafetyWrapperState(env=state, generator=generator), obs

    def step(self, state: SafetyWrapperState, action):
        inner, result = self.env.step(state.env, action)
        risky = self.risky_fn(result.observation, action).to(torch.float32)
        reward = result.reward
        if self.noisy_reward_sigma > 0.0:
            noise = torch.randn(
                risky.shape, generator=state.generator, device=risky.device
            )
            reward = reward + risky * (self.noisy_reward_mean + self.noisy_reward_sigma * noise)
        result = dataclasses.replace(
            result, cost=risky, reward=reward, info={**result.info, "risky_sa": risky}
        )
        return dataclasses.replace(state, env=inner), result


@dataclasses.dataclass(frozen=True, eq=False)
class DynamicActionSpaceWrapper(EnvWrapper):
    """Every env's last `num_masked` actions are unavailable on its steps
    where (t // interval) is odd; the mask comes with each step's result."""

    interval: int = 4
    num_masked: int = 1

    def _mask(self, t: torch.Tensor) -> torch.Tensor:
        n = self.env.action_space.n
        shrunk = ((t // self.interval) % 2) == 1
        reduced = torch.arange(n, device=t.device) < (n - self.num_masked)
        return torch.where(shrunk[:, None], reduced, True)

    def step(self, state, action):
        new_state, result = self.env.step(state, action)
        t = getattr(new_state, "t", None)
        if t is None:
            t = torch.zeros(result.reward.shape, dtype=torch.int32, device=result.reward.device)
        return new_state, dataclasses.replace(result, available_actions_mask=self._mask(t))
