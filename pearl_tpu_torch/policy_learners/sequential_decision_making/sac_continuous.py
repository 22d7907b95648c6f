"""Continuous-action Soft Actor-Critic (port of
`pearl_tpu/policy_learners/sequential_decision_making/sac_continuous.py`).

- Gaussian actor with tanh squash and the log-prob's Jacobian correction.
- Clipped double-Q critic: y = r + gamma (1 - d) (min Q_target(s', a') -
  alpha log pi(a'|s')), a' drawn from the old policy.
- Actor loss: E[alpha log pi(a|s) - min Q(s, a)], a reparameterised.
- The temperature is tuned toward the target entropy -action_dim when
  `entropy_autotune` (Adam on log alpha, after the actor and critic steps,
  from a fresh sample of the NEW policy); else alpha is `entropy_coef`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.actor_networks import GaussianActorNetwork
from pearl_tpu_torch.policy_learners.exploration_modules.common import NoExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
    ActorCriticState,
    apply_grads,
)
from pearl_tpu_torch.utils.collectives import pmean


@dataclasses.dataclass
class AlphaState:
    log_alpha: nn.Parameter  # 0-dim, on the device
    optimizer: torch.optim.Adam


def init_alpha(learner, device) -> Optional[AlphaState]:
    """log(entropy_coef) and its Adam (lr `alpha_learning_rate`) when the
    learner tunes its temperature, else None."""
    if not learner.entropy_autotune:
        return None
    log_alpha = nn.Parameter(
        torch.log(torch.tensor(learner.entropy_coef, dtype=torch.float32)).to(device)
    )
    return AlphaState(
        log_alpha=log_alpha,
        optimizer=torch.optim.Adam([log_alpha], lr=learner.alpha_learning_rate),
    )


def alpha_value(learner, state: ActorCriticState):
    """The temperature: exp(log alpha) without gradient, or `entropy_coef`."""
    if state.extra is None:
        return learner.entropy_coef
    return torch.exp(state.extra.log_alpha.detach())


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class ContinuousSoftActorCritic(ActorCriticBase):
    actor_network: Any = GaussianActorNetwork()
    exploration: Any = NoExploration()  # SAC explores through its stochastic policy
    entropy_coef: float = 0.2
    entropy_autotune: bool = True
    alpha_learning_rate: float = 3e-4
    actor_learning_rate: float = 3e-4
    critic_learning_rate: float = 3e-4

    def _target_entropy(self) -> float:
        return -float(self.action_space.action_dim)

    def init_extra(self, device):
        return init_alpha(self, device)

    def _alpha(self, state: ActorCriticState):
        return alpha_value(self, state)

    def actor_loss(self, state, actor_params, batch, subj, noise: Dict):
        action, log_prob = self.actor.sample_action(
            actor_params, subj, state.generator, state.low, state.high, noise.get("actor")
        )
        q = self.critic_network.q_min(state.critic_params, subj, action)
        return torch.mean(self._alpha(state) * log_prob - q)

    def critic_loss(self, state, critic_params, batch, subj, next_subj, noise: Dict):
        with torch.no_grad():
            next_action, next_log_prob = self.actor.sample_action(
                state.actor_params, next_subj, state.generator, state.low, state.high,
                noise.get("critic"),
            )
            q_target = self.critic_network.q_min(
                state.critic_target_params, next_subj, next_action
            )
            not_done = 1.0 - batch.terminated.to(torch.float32)
            y = batch.reward + self.discount_factor * not_done * (
                q_target - self._alpha(state) * next_log_prob
            )
        q1, q2 = self.critic_network.q_both(critic_params, subj, batch.action)
        # The mean of the two MSEs.
        return (torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)) / 2.0

    def post_update(self, state: ActorCriticState, batch, noise: Dict):
        if state.extra is None:
            return state, {}
        with torch.no_grad():
            subj = self.history_summarizer.forward(state.summarizer_params, batch.state)
            _, log_prob = self.actor.sample_action(
                state.actor_params, subj, state.generator, state.low, state.high,
                noise.get("alpha"),
            )
        log_alpha = state.extra.log_alpha
        loss = -torch.mean(torch.exp(log_alpha) * (log_prob + self._target_entropy()))
        grads = pmean(torch.autograd.grad(loss, [log_alpha]), self.pmean_axis)
        apply_grads(state.extra.optimizer, [log_alpha], grads)
        return state, {"alpha": torch.exp(log_alpha.detach())}
