"""Environment wrappers (port of `pearl_tpu/envs/wrappers.py`), batched
over B envs.

- `PartialObservabilityWrapper`: only `observed_indices` of the observation
  (CartPole (0, 2): positions, velocities hidden).
- `SparseRewardWrapper`: reward = 1{success_fn(observation)}.
- `SafetyWrapper`: cost = 1 where `risky_fn(observation, action)` holds,
  into `ActionResult.cost` (and `info["risky_sa"]`); with
  `noisy_reward_sigma > 0` a risky step also adds N(mean, sigma) to the
  reward, one draw per env per step.
- `DynamicActionSpaceWrapper`: the last `num_masked` actions are unavailable
  on steps where (t // interval) is odd, from each env's own step count.
- `FlattenObservations`, `FlattenDictObservations`: a dict (or tuple) of
  (B, ...) observations into one (B, D) vector, in JAX's leaf order.
- `OneHotObservationsFromDiscrete`: the one-hot of a discrete observation.

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


@dataclasses.dataclass(frozen=True, eq=False)
class SparseRewardWrapper(EnvWrapper):
    """reward = 1 if success_fn(observation) else 0 (e.g. Pendulum:
    success = cos(theta) > 0.98)."""

    success_fn: Callable[[torch.Tensor], torch.Tensor] = None

    def step(self, state, action):
        state, result = self.env.step(state, action)
        success = self.success_fn(result.observation)
        return state, dataclasses.replace(result, reward=success.to(torch.float32))


def _leaves(tree):
    """The tensors of a dict / tuple / list tree in JAX's leaf order: dict
    entries by sorted key, recursively."""
    if isinstance(tree, dict):
        return [leaf for _, sub in sorted(tree.items()) for leaf in _leaves(sub)]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


@dataclasses.dataclass(frozen=True, eq=False)
class FlattenObservations(EnvWrapper):
    """Flatten a dict or tuple observation of (B, ...) leaves into one
    (B, D) vector, leaves concatenated in JAX's pytree order."""

    flat_dim: int = 0  # the flattened dim (needed for observation_space)

    @property
    def observation_space(self):
        inf = float("inf")
        return BoxSpace.create([-inf] * self.flat_dim, [inf] * self.flat_dim)

    @staticmethod
    def _flatten(obs):
        leaves = _leaves(obs)
        return torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=-1)

    def reset(self, num_envs, generator, device):
        state, obs = self.env.reset(num_envs, generator, device)
        return state, self._flatten(obs)

    def step(self, state, action):
        state, result = self.env.step(state, action)
        return state, dataclasses.replace(result, observation=self._flatten(result.observation))


@dataclasses.dataclass(frozen=True, eq=False)
class FlattenDictObservations(FlattenObservations):
    """Flatten dict observations in sorted-key order (recursively); the
    flattened space's bounds come from the sub-spaces (Box bounds
    flattened, Discrete(n) gives [0, n-1]). `flat_dim` may be left 0 when
    the wrapped env's observation_space is a dict of spaces."""

    @property
    def observation_space(self):
        if self.flat_dim:
            return super().observation_space
        space = self.env.observation_space
        if not isinstance(space, dict):
            raise ValueError(
                "FlattenDictObservations needs flat_dim when the wrapped "
                "env's observation_space is not a dict of spaces."
            )
        lows, highs = [], []

        def walk(sub):
            if isinstance(sub, dict):
                for _, s in sorted(sub.items()):
                    walk(s)
            elif hasattr(sub, "low"):  # Box
                lows.append(sub.low.reshape(-1))
                highs.append(sub.high.reshape(-1))
            elif hasattr(sub, "n"):  # Discrete: a scalar index in [0, n-1]
                lows.append(torch.zeros(1))
                highs.append(torch.tensor([float(sub.n - 1)]))
            else:
                raise NotImplementedError(f"Unsupported subspace {type(sub)}")

        walk(space)
        return BoxSpace.create(torch.cat(lows), torch.cat(highs))


@dataclasses.dataclass(frozen=True, eq=False)
class OneHotObservationsFromDiscrete(EnvWrapper):
    """One-hot a scalar discrete observation, (B, 1) or (B,), into (B, n)."""

    num_values: int = 0  # 0 = infer from a DiscreteSpace observation space

    @property
    def _n(self) -> int:
        n = self.num_values or getattr(self.env.observation_space, "n", 0)
        if not n:
            raise ValueError(
                "OneHotObservationsFromDiscrete needs `num_values` (the "
                "wrapped env's observation space is not discrete, so the "
                "number of values cannot be inferred)."
            )
        return n

    @property
    def observation_space(self):
        return BoxSpace.create(torch.zeros(self._n), torch.ones(self._n))

    def _one_hot(self, obs):
        n = self._n
        idx = obs.reshape(obs.shape[0], -1)[:, 0].to(torch.int32)
        # As JAX's `.at[idx].set(1.0)`: a negative index counts from the end,
        # one out of range sets nothing (a comparison, never a gather).
        idx = torch.where(idx < 0, idx + n, idx)
        return (idx[:, None] == torch.arange(n, device=obs.device)).to(torch.float32)

    def reset(self, num_envs, generator, device):
        state, obs = self.env.reset(num_envs, generator, device)
        return state, self._one_hot(obs)

    def step(self, state, action):
        state, result = self.env.step(state, action)
        return state, dataclasses.replace(result, observation=self._one_hot(result.observation))
