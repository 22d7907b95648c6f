"""Safety module base + identity (port of `pearl_tpu/safety_modules/identity.py`).

Protocol:
    init(generator, observation_dim, action_space, num_envs, device) -> SafetyState
    filter_action(state, subjective_state, mask) -> mask'       (act-time)
    learn_batch(state, batch, learner=, learner_state=)
        -> (state', metrics)                                    (train-time)

A module that shapes rewards adds `batch_transform(state) -> fn(batch)`,
which the agent hands to the learner, and `learn(state, buffer,
buffer_state, generator, learner, learner_state)`, which the agent calls after
the learner's (`reward_constrained.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class SafetyModule:
    def init(self, generator, observation_dim: int, action_space, num_envs: int, device=None):
        return ()

    def filter_action(
        self, state, subjective_state: torch.Tensor, mask: Optional[torch.Tensor]
    ) -> Optional[torch.Tensor]:
        return mask

    def learn_batch(self, state, batch, learner=None, learner_state=None):
        return state, {}


@dataclasses.dataclass(frozen=True, eq=False)
class IdentitySafetyModule(SafetyModule):
    """No-op safety module — the default for non-distributional learners."""
