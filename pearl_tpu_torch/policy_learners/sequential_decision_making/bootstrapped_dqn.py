"""Bootstrapped DQN with deep exploration (port of
`pearl_tpu/policy_learners/sequential_decision_making/bootstrapped_dqn.py`).

- K Q-members with additive frozen random priors (`EnsembleQValueNetwork`),
  all K evaluated as one batched product per layer.
- A per-member double-DQN loss: the next action is the argmax under the
  online member, valued under the target member; each member's squared TD
  errors are weighted by the transition's Bernoulli bootstrap mask (from
  `BootstrapReplayBuffer`; all ones when the batch has none), normalized by
  max(sum of the member's mask, 1), and summed over members. `per_sample_td`
  is the mean |TD| over members.
- Acting: the greedy action of the ensemble mean under `exploit`, else
  `DeepExploration` (each env's member z, drawn anew when its episode ends).

The prior lives in the state apart from `params`: the optimizer and the
target copy see only the trainable members, so AdamW's weight decay and the
soft target update never reach it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, ClassVar, Optional

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.q_value_networks import EnsembleQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules.deep_exploration import (
    DeepExploration,
)
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice
from pearl_tpu_torch.policy_learners.sequential_decision_making.deep_td import (
    DeepTDLearning,
    DeepTDState,
)
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch


@dataclasses.dataclass
class BootstrappedDQNState(DeepTDState):
    prior_params: Optional[nn.Module] = None  # the frozen priors, never optimized
    # The priors cast to `act_dtype` once at init (they never change); None
    # when `act_dtype` is unset.
    act_prior_params: Optional[nn.Module] = None


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class BootstrappedDQN(DeepTDLearning):
    q_network: EnsembleQValueNetwork = EnsembleQValueNetwork(ensemble_size=10)
    exploration: Any = None  # None: DeepExploration over the ensemble

    state_type: ClassVar[type] = BootstrappedDQNState

    def _exploration(self):
        return self.exploration or DeepExploration(ensemble_size=self.q_network.ensemble_size)

    def _init_q(self, generator, subj_dim: int, rep_dim: int, num_actions: int, device):
        """The trainable members; the priors (and their `act_dtype` cast,
        made once since they never change) as extra state fields."""
        full = self.q_network.init(generator, subj_dim, rep_dim, num_actions)
        params, prior = full["train"].to(device), full["prior"].to(device)
        act_prior = None if self.act_dtype is None else copy.deepcopy(prior).to(self._act_dtype())
        return params, {"prior_params": prior, "act_prior_params": act_prior}

    @staticmethod
    def _full(train: nn.Module, state: BootstrappedDQNState) -> dict:
        return {"train": train, "prior": state.prior_params}

    @torch.no_grad()
    def act(self, state, subjective_state, mask, generator, exploit: bool = False):
        params, subjective_state, candidates = self._act_inputs(state, subjective_state)
        prior = state.prior_params if state.act_params is None else state.act_prior_params
        q_ens = self.q_network.q_ensemble(
            {"train": params, "prior": prior}, subjective_state, candidates, mask
        ).to(torch.float32)  # (B, K, A)
        exploit_index = self.greedy_index(q_ens.mean(dim=1), mask, state.tie_generator)
        if exploit:
            index, explore_state = exploit_index, state.explore_state
        else:
            explore_state, index = self._exploration().act(
                state.explore_state, q_ens, exploit_index, mask, generator
            )
        action = state.action_elements[index.long()]
        return (
            dataclasses.replace(state, explore_state=explore_state),
            ActionChoice(action=action, index=index),
        )

    def member_td(self, state: BootstrappedDQNState, batch: TransitionBatch):
        """(td, mask), both (B, K): each member's TD error on each row, with
        grad to the online members, times the row's bootstrap mask."""
        gamma = self.discount_factor
        subj = self.history_summarizer.forward(state.summarizer_params, batch.state)
        B = subj.shape[0]
        K = self.q_network.ensemble_size
        boot_mask = (batch.bootstrap_mask if batch.bootstrap_mask is not None
                     else torch.ones((B, K), device=subj.device))
        candidates = self._candidates(state, B)
        full = self._full(state.params, state)
        q_ens = self.q_network.q_ensemble(full, subj, candidates, batch.curr_available_mask)
        index = batch.action_index.long()[:, None, None].expand(B, K, 1)
        q_sa = q_ens.gather(2, index)[..., 0]  # (B, K)
        with torch.no_grad():
            next_subj = self.history_summarizer.forward(state.summarizer_params, batch.next_state)
            next_online = self.q_network.q_ensemble(
                full, next_subj, candidates, batch.next_available_mask
            )
            if batch.next_available_mask is not None:
                next_online = torch.where(
                    batch.next_available_mask[:, None, :], next_online, float("-inf")
                )
            a_star = next_online.argmax(dim=2, keepdim=True)  # (B, K, 1)
            next_target = self.q_network.q_ensemble(
                self._full(state.target_params, state), next_subj, candidates,
                batch.next_available_mask,
            )
            next_v = next_target.gather(2, a_star)[..., 0]  # (B, K)
            not_term = 1.0 - batch.terminated.to(torch.float32)
            target = batch.reward[:, None] + gamma * not_term[:, None] * next_v
        return (q_sa - target) * boot_mask, boot_mask

    def td_loss(self, state: BootstrappedDQNState, batch: TransitionBatch):
        td, boot_mask = self.member_td(state, batch)
        per_member = (td**2).sum(dim=0) / torch.clamp(boot_mask.sum(dim=0), min=1.0)
        abs_td = td.detach().abs()
        return per_member.sum(), {"loss": abs_td.mean(), "per_sample_td": abs_td.mean(dim=1)}
