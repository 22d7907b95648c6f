"""Implicit Q-Learning, offline RL (port of
`pearl_tpu/policy_learners/sequential_decision_making/iql.py`).

- The value net regresses Q_target(s, a) by the expectile loss
  |tau - 1(u < 0)| u^2, u = Q_target - V.
- The twin critic regresses r + gamma (1 - d) V(s').
- The actor is advantage-weighted regression: weights
  min(exp(beta (Q_target - V)), advantage_clamp) times -log pi(a|s), the
  discrete policy's probability of the stored action or the continuous
  Gaussian's log-density.

Order of the updates, as in the reference: the actor and critic losses are
taken at the old state (the actor's weights read the value net before it
moves), then actor and critic step and the critic target soft-updates in
place, and only then `post_update` steps the value net, toward the NEW
critic target. The value net has its own AdamW (lr `value_learning_rate`,
weight decay 0.01), built with the value net in `init`: `init_extra` does
not know the widths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.common import select_index_last
from pearl_tpu_torch.neural_networks.value_networks import VanillaValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
    ActorCriticState,
    _adamw,
    apply_grads,
)
from pearl_tpu_torch.utils.collectives import pmean


@dataclasses.dataclass
class IQLExtra:
    value_params: nn.Module
    value_opt: torch.optim.AdamW


def expectile_loss(q: torch.Tensor, v: torch.Tensor, expectile: float) -> torch.Tensor:
    """mean(|expectile - 1(u < 0)| u^2), u = q - v: the asymmetric L2 loss
    that makes V an upper expectile of Q."""
    u = q - v
    w = torch.abs(expectile - (u < 0.0).to(torch.float32))
    return torch.mean(w * u**2)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class ImplicitQLearning(ActorCriticBase):
    value_network: Any = VanillaValueNetwork()
    value_learning_rate: float = 1e-3
    expectile: float = 0.75
    temperature_advantage_weighted_regression: float = 3.0
    advantage_clamp: float = 100.0

    def init(self, generator, observation_dim: int, action_space, num_envs: int, device):
        state = super().init(generator, observation_dim, action_space, num_envs, device)
        subj_dim, _, _ = self.dims(observation_dim, action_space)
        value = self.value_network.init(generator, subj_dim).to(device)
        return dataclasses.replace(
            state,
            extra=IQLExtra(
                value_params=value,
                value_opt=_adamw(list(value.parameters()), self.value_learning_rate),
            ),
        )

    def _critic_action(self, state: ActorCriticState, batch) -> torch.Tensor:
        """The action as the critic takes it: the raw vector on a continuous
        space, the represented candidate at `action_index` on a discrete one
        (replay stores the raw env action; the critic's input is the
        representation)."""
        if self.is_continuous:
            return batch.action
        return state.action_reps[batch.action_index.long()]

    def _q_target_sa(self, state: ActorCriticState, subj, action) -> torch.Tensor:
        return self.critic_network.q_min(state.critic_target_params, subj, action)

    def actor_loss(self, state, actor_params, batch, subj, noise: Dict):
        with torch.no_grad():
            q = self._q_target_sa(state, subj, self._critic_action(state, batch))
            v = self.value_network.value(state.extra.value_params, subj)
            # exp may overflow to inf; the clamp takes it back, no NaN.
            weight = torch.clamp(
                torch.exp(self.temperature_advantage_weighted_regression * (q - v)),
                max=self.advantage_clamp,
            )
        if self.is_continuous:
            logp = self.actor.get_log_probability(
                actor_params, subj, batch.action, state.low, state.high
            )
        else:
            candidates = self.represented_candidates(state, subj.shape[0])
            probs = self.actor.get_policy_distribution(
                actor_params, subj, candidates, batch.curr_available_mask
            )
            logp = torch.log(torch.clamp(select_index_last(probs, batch.action_index), 1e-8, 1.0))
        return -torch.mean(weight * logp)

    def critic_loss(self, state, critic_params, batch, subj, next_subj, noise: Dict):
        with torch.no_grad():
            v_next = self.value_network.value(state.extra.value_params, next_subj)
            not_done = 1.0 - batch.terminated.to(torch.float32)
            y = batch.reward + self.discount_factor * not_done * v_next
        q1, q2 = self.critic_network.q_both(critic_params, subj, self._critic_action(state, batch))
        return (torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)) / 2.0

    def post_update(self, state: ActorCriticState, batch, noise: Dict):
        """The value net's expectile step toward the critic target as it is
        after this learn step's soft update."""
        with torch.no_grad():
            subj = self.history_summarizer.forward(state.summarizer_params, batch.state)
            q = self._q_target_sa(state, subj, self._critic_action(state, batch))
        value = state.extra.value_params
        params = list(value.parameters())
        loss = expectile_loss(q, self.value_network.value(value, subj), self.expectile)
        grads = pmean(torch.autograd.grad(loss, params), self.pmean_axis)
        apply_grads(state.extra.value_opt, params, grads)
        return state, {"value_loss": loss.detach()}
