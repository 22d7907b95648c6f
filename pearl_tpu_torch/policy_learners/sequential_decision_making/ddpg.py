"""DDPG (port of `pearl_tpu/policy_learners/sequential_decision_making/ddpg.py`).

A deterministic tanh actor and a twin critic, both with targets. The actor
maximises Q1(s, mu(s)); the critic regresses the clipped double-Q Bellman
target of the target actor's next action. The default exploration is
Gaussian action noise, `NormalDistributionExploration(0, 0.1)`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from pearl_tpu_torch.neural_networks.actor_networks import VanillaContinuousActorNetwork
from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    NormalDistributionExploration,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DeepDeterministicPolicyGradient(ActorCriticBase):
    actor_network: Any = VanillaContinuousActorNetwork()
    exploration: Any = NormalDistributionExploration(mean=0.0, std_dev=0.1)

    @property
    def use_actor_target(self) -> bool:
        return True

    def _next_action(self, state, next_subj, noise: Optional[torch.Tensor] = None):
        del noise
        return self.actor.action(
            state.actor_target_params, next_subj, state.low, state.high
        )

    def actor_loss(self, state, actor_params, batch, subj, noise: Dict):
        action = self.actor.action(actor_params, subj, state.low, state.high)
        q1, _ = self.critic_network.q_both(state.critic_params, subj, action)
        return -torch.mean(q1)

    def critic_loss(self, state, critic_params, batch, subj, next_subj, noise: Dict):
        with torch.no_grad():
            next_action = self._next_action(state, next_subj, noise.get("target"))
            q_target = self.critic_network.q_min(
                state.critic_target_params, next_subj, next_action
            )
            not_done = 1.0 - batch.terminated.to(torch.float32)
            y = batch.reward + self.discount_factor * not_done * q_target
        q1, q2 = self.critic_network.q_both(critic_params, subj, batch.action)
        return (torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)) / 2.0
