"""Vectorized environments with auto-reset (port of `pearl_tpu/envs/vector.py`).

`step` returns the `ActionResult` batch, whose `observation` is the
*terminal* observation (what replay stores as next_state), and the
post-reset observation batch (what the agent acts on next). Envs that are
done restart from a fresh reset state; the others keep stepping.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.utils import profiling
from pearl_tpu_torch.utils.pytree import tree_select


class VectorEnv:
    def __init__(self, env: Environment, num_envs: int, device: torch.device):
        self.env = env
        self.num_envs = num_envs
        self.device = device

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def observation_dim(self):
        return self.env.observation_dim

    def reset(self, generator: torch.Generator):
        return self.env.reset(self.num_envs, generator, self.device)

    def step(
        self,
        states,
        actions: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        fresh: Optional[Tuple[object, torch.Tensor]] = None,
    ) -> Tuple[object, ActionResult, torch.Tensor]:
        """Returns (new_states, results, next_obs) with auto-reset applied to
        new_states/next_obs but NOT to results.observation. The reset states
        are drawn from `generator`, or taken from `fresh` = (states, obs).
        An env that defines `step_autoreset(states, actions, generator)` does
        the drawn case itself wherever that returns a result."""
        with profiling.span("env.step"):
            step_autoreset = getattr(self.env, "step_autoreset", None)
            if fresh is None and step_autoreset is not None:
                out = step_autoreset(states, actions, generator)
                if out is not None:
                    return out
            new_states, results = self.env.step(states, actions)
            if fresh is None:
                fresh = self.reset(generator)
            fresh_states, fresh_obs = fresh
            done = results.done
            next_states = tree_select(done, fresh_states, new_states)
            next_obs = tree_select(done, fresh_obs, results.observation)
            return next_states, results, next_obs
