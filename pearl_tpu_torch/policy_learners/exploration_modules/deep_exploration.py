"""Deep exploration through a bootstrapped ensemble (port of
`pearl_tpu/policy_learners/exploration_modules/deep_exploration.py`).

Each env holds a persistent ensemble index z, the member it acts greedily
against; z is drawn anew for an env when its episode ends (Osband et al.,
2016). z is an int64 tensor on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    ExplorationModule,
    masked_argmax,
)


@dataclasses.dataclass
class DeepExplorationState:
    z: torch.Tensor  # (B,) int64 ensemble index per env


@dataclasses.dataclass(frozen=True)
class DeepExploration(ExplorationModule):
    ensemble_size: int = 10

    def init(self, num_envs: int, device=None) -> DeepExplorationState:
        return DeepExplorationState(z=torch.zeros((num_envs,), dtype=torch.int64, device=device))

    def act(self, state, scores, exploit_index, mask, generator):
        """`scores` are the members' Q (B, K, A): the greedy action of each
        env's member z."""
        member_q = scores.gather(1, state.z[:, None, None].expand(-1, 1, scores.shape[-1]))
        return state, masked_argmax(member_q[:, 0], mask)

    def reset(self, state, done_mask, generator, fresh: Optional[torch.Tensor] = None):
        """A fresh z for every env, kept where `done_mask`: the draw does not
        depend on how many envs finished. `fresh` (B,), when given, replaces
        the draw."""
        if fresh is None:
            fresh = torch.randint(
                0, self.ensemble_size, state.z.shape, generator=generator, device=state.z.device
            )
        return DeepExplorationState(z=torch.where(done_mask, fresh.to(torch.int64), state.z))
