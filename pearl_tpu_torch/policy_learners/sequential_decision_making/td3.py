"""TD3 and TD3BC (port of `pearl_tpu/policy_learners/sequential_decision_making/td3.py`).

TD3 is DDPG with (a) the actor and its target updated every
`actor_update_freq` learn steps and (b) target-policy smoothing: Gaussian
noise, clipped in normalized units and scaled to the action range, on the
target actor's next action. TD3BC adds a behaviour-cloning MSE to the actor
loss, with the adaptive weight lambda = alpha / mean|Q1(s, mu(s))| taken
without gradient (offline RL).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from pearl_tpu_torch.neural_networks.actor_networks import noise_scaling, standard_normal
from pearl_tpu_torch.policy_learners.sequential_decision_making.ddpg import (
    DeepDeterministicPolicyGradient,
)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class TD3(DeepDeterministicPolicyGradient):
    actor_update_freq: int = 2
    actor_update_noise: float = 0.2
    actor_update_noise_clip: float = 0.5

    def _next_action(self, state, next_subj, noise: Optional[torch.Tensor] = None):
        """`noise` replaces the standard normal draw from the learner's
        generator."""
        low, high = state.low, state.high
        base = self.actor.action(state.actor_target_params, next_subj, low, high)
        noise = standard_normal(base.shape, base, state.generator, noise) * self.actor_update_noise
        clip = self.actor_update_noise_clip
        noise = noise_scaling(low, high, torch.clamp(noise, -clip, clip))
        return torch.clamp(base + noise, low, high)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class TD3BC(TD3):
    behavior_cloning_alpha: float = 2.5

    def actor_loss(self, state, actor_params, batch, subj, noise: Dict):
        action = self.actor.action(actor_params, subj, state.low, state.high)
        q1, _ = self.critic_network.q_both(state.critic_params, subj, action)
        lam = self.behavior_cloning_alpha / (torch.mean(torch.abs(q1)).detach() + 1e-8)
        bc = torch.mean(torch.sum((action - batch.action) ** 2, dim=-1))
        return -lam * torch.mean(q1) + bc
