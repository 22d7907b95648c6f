"""Discrete-action Soft Actor-Critic (port of
`pearl_tpu/policy_learners/sequential_decision_making/sac.py`).

Semantics kept from the reference:
- A twin critic over (state, action representation) pairs, or a multi-head
  one that scores every action from the state (`CNNTwinCritic`), with a
  target critic.
- Critic target y = r + gamma (1 - d) * sum_a' pi(a'|s') (min Q_target(s',
  a') - alpha log pi(a'|s')): the expected soft value, not a sampled one.
- Actor loss sum_a pi(a|s) (alpha log pi(a|s) - min Q(s, a)).
- The temperature is tuned toward the target entropy -0.89 log(1 / |A|)
  (Adam on log alpha, after the actor and critic steps, at the NEW policy)
  when `entropy_autotune`; else alpha is `entropy_coef`.
- The actor's learning rate decays by `actor_lr_decay` per finished episode:
  with B batched envs, by actor_lr_decay ** (finished episodes / B) at each
  `episode_reset`.

The agent calls `episode_reset` on every observe, so the learning rate is a
device tensor in the actor's optimizer, decayed in place: a Python float
would read the done mask back to the host on every env step. On the card
that optimizer is `capturable`, whose step reads the tensor learning rate on
the device (the plain step reads it back to the host on every step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.actor_networks import VanillaActorNetwork
from pearl_tpu_torch.neural_networks.common import select_index_last
from pearl_tpu_torch.policy_learners.exploration_modules.common import PropensityExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
    ActorCriticState,
    _adamw,
    apply_grads,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.sac_continuous import (
    alpha_value,
    init_alpha,
)
from pearl_tpu_torch.utils.collectives import pmean


def twin_q_all(critic, params, subj, candidates):
    """Both critic members' Q for every candidate action: (B, A) twice."""
    if hasattr(critic, "q_all_both"):
        # Multi-head critics score all candidates from the state alone.
        return critic.q_all_both(params, subj, candidates)
    B, A = candidates.shape[0], candidates.shape[1]
    s_flat = subj[:, None, :].expand(B, A, subj.shape[-1]).reshape(B * A, -1)
    a_flat = candidates.reshape(B * A, -1)
    q1, q2 = critic.q_both(params, s_flat, a_flat)
    return q1.reshape(B, A), q2.reshape(B, A)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class SoftActorCritic(ActorCriticBase):
    actor_network: Any = VanillaActorNetwork()
    exploration: Any = PropensityExploration()
    entropy_coef: float = 0.1
    entropy_autotune: bool = True
    alpha_learning_rate: float = 3e-4
    actor_lr_decay: float = 0.99

    def actor_optimizer(self, params: List[nn.Parameter], device) -> torch.optim.Optimizer:
        device = torch.device(device)
        lr = torch.tensor(self.actor_learning_rate, dtype=torch.float32, device=device)
        return _adamw(params, lr, capturable=device.type == "cuda")

    def _target_entropy(self) -> float:
        return -0.89 * math.log(1.0 / self.action_space.n)

    def init_extra(self, device):
        return init_alpha(self, device)

    def _alpha(self, state: ActorCriticState):
        return alpha_value(self, state)

    def _policy(self, actor_params, subj, candidates, mask):
        probs = self.actor.get_policy_distribution(actor_params, subj, candidates, mask)
        return probs, torch.log(torch.clamp(probs, 1e-8, 1.0))

    def actor_loss(self, state, actor_params, batch, subj, noise: Dict):
        candidates = self.represented_candidates(state, subj.shape[0])
        probs, log_probs = self._policy(
            actor_params, subj, candidates, batch.curr_available_mask
        )
        q1, q2 = twin_q_all(self.critic_network, state.critic_params, subj, candidates)
        per_state = torch.sum(probs * (self._alpha(state) * log_probs - torch.minimum(q1, q2)), -1)
        return torch.mean(per_state)

    def critic_loss(self, state, critic_params, batch, subj, next_subj, noise: Dict):
        candidates = self.represented_candidates(state, subj.shape[0])
        with torch.no_grad():
            next_probs, next_log_probs = self._policy(
                state.actor_params, next_subj, candidates, batch.next_available_mask
            )
            q1t, q2t = twin_q_all(
                self.critic_network, state.critic_target_params, next_subj, candidates
            )
            soft_v = torch.sum(
                next_probs * (torch.minimum(q1t, q2t) - self._alpha(state) * next_log_probs), -1
            )
            not_done = 1.0 - batch.terminated.to(torch.float32)
            y = batch.reward + self.discount_factor * not_done * soft_v
        q1_all, q2_all = twin_q_all(self.critic_network, critic_params, subj, candidates)
        q1 = select_index_last(q1_all, batch.action_index)
        q2 = select_index_last(q2_all, batch.action_index)
        return (torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)) / 2.0

    def post_update(self, state: ActorCriticState, batch, noise: Dict):
        if state.extra is None:
            return state, {}
        with torch.no_grad():
            subj = self.history_summarizer.forward(state.summarizer_params, batch.state)
            candidates = self.represented_candidates(state, subj.shape[0])
            probs, log_probs = self._policy(
                state.actor_params, subj, candidates, batch.curr_available_mask
            )
            inner = log_probs + self._target_entropy()
        log_alpha = state.extra.log_alpha
        loss = -torch.mean(torch.sum(probs * torch.exp(log_alpha) * inner, dim=-1))
        grads = pmean(torch.autograd.grad(loss, [log_alpha]), self.pmean_axis)
        apply_grads(state.extra.optimizer, [log_alpha], grads)
        return state, {"alpha": torch.exp(log_alpha.detach())}

    def episode_reset(self, state, done_mask, generator):
        """Decay the actor's learning rate, in place, by actor_lr_decay **
        (finished episodes / B)."""
        frac = done_mask.to(torch.float32).sum() / done_mask.shape[0]
        state.actor_opt.param_groups[0]["lr"].mul_(self.actor_lr_decay**frac)
        return super().episode_reset(state, done_mask, generator)
