"""Host-side Gymnasium adapter (port of `pearl_tpu/envs/gym_adapter.py`).

One gymnasium env instance behind the port's env names, stepped on the
host: `reset(seed)` and `step(state, action)` take and give numpy or CPU
tensors, one env at a time, for the host loops
(`training/host_loop.py`) only. The batched on-device envs of
`pearl_tpu_torch.envs` are the production path. gymnasium is imported when
an adapter is made, so the package does not need it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pearl_tpu_torch.api.spaces import BoxActionSpace, BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass(eq=False)
class GymEnvironment:
    """`env_name` is a gymnasium id or an already constructed gymnasium env
    (e.g. one wrapped by `envs.atari.wrap_atari`)."""

    env_name: object = "CartPole-v1"
    render_mode: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.env_name, str):
            import gymnasium

            self._gym = gymnasium.make(self.env_name, render_mode=self.render_mode)
        else:
            self._gym = self.env_name

    def _discrete(self) -> bool:
        import gymnasium

        return isinstance(self._gym.action_space, gymnasium.spaces.Discrete)

    @property
    def action_space(self):
        space = self._gym.action_space
        if self._discrete():
            return DiscreteActionSpace.discrete(int(space.n))
        return BoxActionSpace.create(space.low, space.high)

    @property
    def observation_space(self) -> BoxSpace:
        space = self._gym.observation_space
        return BoxSpace.create(
            np.asarray(space.low, np.float32), np.asarray(space.high, np.float32)
        )

    @property
    def observation_dim(self) -> int:
        return int(np.prod(self._gym.observation_space.shape))

    def reset(self, seed: Optional[int] = None) -> Tuple[None, torch.Tensor]:
        obs, _ = self._gym.reset(seed=seed)
        return None, torch.as_tensor(np.asarray(obs, np.float32).reshape(-1))

    def step(self, state, action) -> Tuple[None, ActionResult]:
        a = np.asarray(action).reshape(-1)
        if self._discrete():
            a = int(a[0])
        obs, reward, terminated, truncated, info = self._gym.step(a)
        cost = info.get("cost")
        return None, ActionResult(
            observation=torch.as_tensor(np.asarray(obs, np.float32).reshape(-1)),
            reward=torch.tensor(reward, dtype=torch.float32),
            terminated=torch.tensor(bool(terminated)),
            truncated=torch.tensor(bool(truncated)),
            cost=None if cost is None else torch.tensor(cost, dtype=torch.float32),
        )

    def close(self):
        self._gym.close()
