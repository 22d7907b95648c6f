"""Contextual-bandit environments, batched (port of
`pearl_tpu/envs/bandit.py`).

Every step is a one-step episode (terminated), so the vector env's
auto-reset gives the next context. A step's `info["regret"]` is the
instantaneous regret, for the benchmark.

- `LinearSyntheticBanditEnvironment`: reward = [context; arm feature] .
  mapping + sigma * N(0, 1); the arm features and the mapping come from
  `np.random.RandomState(seed)`, as in the JAX package. The stored action is
  the arm's feature row; the arm's index is recovered as the argmin of the
  squared distance to each arm's features.
- `RewardIsTenTimesActionMABEnvironment`: reward = 10 * the action.
- `ClassificationBanditEnvironment`: contexts are dataset rows, arms are
  classes, reward 1 iff the chosen class is the row's label.

An env's tables (arm features and mapping, the dataset) go to a device once,
at the first reset there, and are kept per device on the env; no step copies
from the host. `step` takes no generator: the state keeps the one it was
reset with, and `step` draws from it and calls `_transition(state, action,
draws)`, which tests feed with the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass
class CBState:
    context: torch.Tensor  # (B, obs_dim)
    generator: Optional[torch.Generator] = None  # the step's draws, on the device


@dataclasses.dataclass
class SLCBState:
    row: torch.Tensor  # (B,) int64: the dataset row each env shows
    generator: Optional[torch.Generator] = None


def _uniform(shape, generator, device, low=-1.0, high=1.0) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low


class _DeviceTables:
    """Host tensors and their copies, one per device, made on first use."""

    def __init__(self, **host: torch.Tensor):
        self.host = host
        self.copies: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self.copies:
            self.copies[device] = {k: v.to(device) for k, v in self.host.items()}
        return self.copies[device]


def _done(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.ones((n,), dtype=torch.bool, device=device),
            torch.zeros((n,), dtype=torch.bool, device=device))


@dataclasses.dataclass(frozen=True, eq=False)
class LinearSyntheticBanditEnvironment(Environment):
    observation_dim: int = 4
    arm_feature_dim: int = 4
    num_arms: int = 5
    reward_noise_sigma: float = 0.1
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        arms = rng.uniform(-1, 1, (self.num_arms, self.arm_feature_dim))
        mapping = rng.uniform(-1, 1, (self.observation_dim + self.arm_feature_dim,))
        object.__setattr__(self, "_tables", _DeviceTables(
            arm_features=torch.as_tensor(arms, dtype=torch.float32),
            linear_mapping=torch.as_tensor(mapping, dtype=torch.float32),
        ))

    @property
    def arm_features(self) -> torch.Tensor:
        return self._tables.host["arm_features"]

    @property
    def linear_mapping(self) -> torch.Tensor:
        return self._tables.host["linear_mapping"]

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.create(self.arm_features)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create(-torch.ones(self.observation_dim), torch.ones(self.observation_dim))

    def _mean_rewards(self, context: torch.Tensor) -> torch.Tensor:
        """(B, obs_dim) -> each arm's mean reward (B, A)."""
        t = self._tables.on(context.device)
        arms = t["arm_features"]
        B = context.shape[0]
        feats = torch.cat([context[:, None, :].expand(B, self.num_arms, self.observation_dim),
                           arms[None].expand(B, *arms.shape)], dim=-1)
        return feats @ t["linear_mapping"]

    def reset(self, num_envs, generator, device) -> Tuple[CBState, torch.Tensor]:
        self._tables.on(device)
        context = _uniform((num_envs, self.observation_dim), generator, device)
        return CBState(context=context, generator=generator), context

    def _transition(self, state: CBState, action: torch.Tensor, noise: torch.Tensor,
                    new_context: torch.Tensor):
        """`noise` (B,): the reward's N(0, 1) draws; `new_context` (B, obs_dim)."""
        means = self._mean_rewards(state.context)
        arms = self._tables.on(action.device)["arm_features"]
        diffs = ((arms[None] - action[:, None, :]) ** 2).sum(-1)
        idx = torch.argmin(diffs, dim=-1)
        chosen = means.gather(1, idx[:, None])[:, 0]
        terminated, truncated = _done(action.shape[0], action.device)
        result = ActionResult(
            observation=new_context,
            reward=chosen + self.reward_noise_sigma * noise,
            terminated=terminated,
            truncated=truncated,
            info={"regret": means.max(-1).values - chosen},
        )
        return dataclasses.replace(state, context=new_context), result

    def step(self, state: CBState, action: torch.Tensor):
        B, device = action.shape[0], action.device
        noise = torch.randn((B,), generator=state.generator, device=device)
        new_context = _uniform((B, self.observation_dim), state.generator, device)
        return self._transition(state, action, noise, new_context)


@dataclasses.dataclass(frozen=True, eq=False)
class RewardIsTenTimesActionMABEnvironment(Environment):
    num_arms: int = 4

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(self.num_arms)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create([0.0], [1.0])

    def reset(self, num_envs, generator, device) -> Tuple[CBState, torch.Tensor]:
        context = torch.zeros((num_envs, 1), device=device)
        return CBState(context=context), context

    def step(self, state: CBState, action: torch.Tensor):
        terminated, truncated = _done(action.shape[0], action.device)
        result = ActionResult(
            observation=torch.zeros_like(state.context),
            reward=10.0 * action[:, 0].to(torch.float32),
            terminated=terminated,
            truncated=truncated,
        )
        return state, result


@dataclasses.dataclass(frozen=True, eq=False)
class ClassificationBanditEnvironment(Environment):
    """`features` (N, d) and `labels` (N,) as numpy arrays or tensors."""

    features: object = None
    labels: object = None
    seed: int = 0

    def __post_init__(self):
        X = torch.as_tensor(np.asarray(self.features, np.float32))
        y = torch.as_tensor(np.asarray(self.labels).astype(np.int64))
        object.__setattr__(self, "_tables", _DeviceTables(X=X, y=y))
        object.__setattr__(self, "_num_classes", int(y.max()) + 1)

    @property
    def num_rows(self) -> int:
        return int(self._tables.host["X"].shape[0])

    @property
    def action_space(self) -> DiscreteActionSpace:
        return DiscreteActionSpace.discrete(self._num_classes)

    @property
    def observation_space(self) -> BoxSpace:
        d = self._tables.host["X"].shape[1]
        return BoxSpace.create(torch.full((d,), -float("inf")), torch.full((d,), float("inf")))

    def reset(self, num_envs, generator, device) -> Tuple[SLCBState, torch.Tensor]:
        X = self._tables.on(device)["X"]
        row = torch.randint(0, self.num_rows, (num_envs,), generator=generator, device=device)
        return SLCBState(row=row, generator=generator), X[row]

    def _transition(self, state: SLCBState, action: torch.Tensor, next_row: torch.Tensor):
        """`next_row` (B,): the rows drawn for the next contexts."""
        t = self._tables.on(action.device)
        chosen = action[:, 0].to(torch.int64)
        correct = (chosen == t["y"][state.row]).to(torch.float32)
        terminated, truncated = _done(action.shape[0], action.device)
        next_row = next_row.to(torch.int64)
        result = ActionResult(
            observation=t["X"][next_row],
            reward=correct,
            terminated=terminated,
            truncated=truncated,
            info={"regret": 1.0 - correct},
        )
        return dataclasses.replace(state, row=next_row), result

    def step(self, state: SLCBState, action: torch.Tensor):
        next_row = torch.randint(0, self.num_rows, (action.shape[0],), generator=state.generator,
                                 device=action.device)
        return self._transition(state, action, next_row)
