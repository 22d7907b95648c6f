"""Contextual-bandit learner base (port of
`pearl_tpu/policy_learners/contextual_bandits/base.py`).

A bandit learner scores every arm with (mu, sigma) from its model and lets a
`BanditExplorationModule` pick; `learn_batch` fits the model on (feature,
reward, weight) triples. An arm's features are concat(subjective state,
action representation), or the state alone with `state_features_only`.

Every bandit state keeps `explore_state`, the action elements (A, a) and
their representations (A, r) on the device (made once at `init`, so acting
copies nothing from the host) and the protocol's `summarizer_params`.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

from pearl_tpu_torch.policy_learners.exploration_modules.contextual_bandits import (
    BanditExplorationModule,
    UCBExploration,
)
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice, PolicyLearner


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class ContextualBanditBase(PolicyLearner):
    exploration: BanditExplorationModule = UCBExploration(alpha=1.0)
    training_rounds: int = 1
    batch_size: int = 128
    # The model sees only the state's features (one vector shared by the arms).
    state_features_only: bool = False

    def arm_features(self, state, subjective_state: torch.Tensor) -> torch.Tensor:
        """(B, s) -> (B, A, f): each arm's [s ; a_repr], or s alone."""
        B = subjective_state.shape[0]
        reps = state.action_reps  # (A, r)
        s_rep = subjective_state[:, None, :].expand(B, reps.shape[0], subjective_state.shape[-1])
        if self.state_features_only:
            return s_rep
        return torch.cat([s_rep, reps[None].expand(B, *reps.shape)], dim=-1)

    def feature_dim(self, observation_dim: int) -> int:
        subj_dim, rep_dim, _ = self.dims(observation_dim, self.action_space)
        if self.state_features_only:
            return subj_dim
        return subj_dim + rep_dim

    @abc.abstractmethod
    def mu_sigma(self, state, features: torch.Tensor):
        """(B, A, f) -> (mu (B, A), sigma (B, A))."""

    @torch.no_grad()
    def get_scores(self, state, subjective_state: torch.Tensor) -> torch.Tensor:
        """Exploration-aware scores of every arm (the exploration module's
        `scores`, else mu)."""
        mu, sigma = self.mu_sigma(state, self.arm_features(state, subjective_state))
        if hasattr(self.exploration, "scores"):
            return self.exploration.scores(mu, sigma)
        return mu

    @torch.no_grad()
    def act(self, state, subjective_state, mask, generator, exploit: bool = False, noise=None):
        """The greedy arm of mu (`exploit`), else the exploration module's
        pick; `noise` goes to the module's draw."""
        mu, sigma = self.mu_sigma(state, self.arm_features(state, subjective_state))
        if exploit:
            index = self.greedy_index(mu, mask, generator)
            explore_state = state.explore_state
        else:
            explore_state, index = self.exploration.act_scores(
                state.explore_state, mu, sigma, mask, generator, noise=noise
            )
        action = state.action_elements[index.long()]
        return (
            dataclasses.replace(state, explore_state=explore_state),
            ActionChoice(action=action, index=index),
        )

    def batch_features(self, batch) -> torch.Tensor:
        """Features of the TAKEN action of each row of a batch: (B, f)."""
        if self.state_features_only:
            return batch.state
        rep = self.resolved_action_representation(self.action_space)
        return torch.cat([batch.state, rep.apply(batch.action)], dim=-1)

    def _base_state_fields(self, num_envs: int, device) -> dict:
        elements, reps = self.action_tensors(device)
        return {
            "explore_state": self.exploration.init(num_envs, device),
            "action_elements": elements,
            "action_reps": reps,
        }


def whole_storage_batch(buffer_state, indices, batch_transform):
    """The buffer's whole storage as one batch, the rows beyond `size`
    weighted 0: what a learner with sufficient statistics folds in once per
    `learn`. Resampled rows (`indices`) or reshaped rewards
    (`batch_transform`) would count data twice in the statistics, so either
    is a ValueError."""
    if indices is not None:
        raise ValueError(
            "a closed-form bandit's learn folds the whole buffer in once: resampled "
            "`indices` would count rows twice in its sufficient statistics"
        )
    if batch_transform is not None:
        raise ValueError(
            "a closed-form bandit's learn takes no `batch_transform`: a reweighted "
            "batch would count its rows again in the sufficient statistics"
        )
    batch = buffer_state.storage
    n = batch.batch_size
    valid = (torch.arange(n, device=batch.reward.device) < buffer_state.size).to(torch.float32)
    weight = batch.weight if batch.weight is not None else torch.ones_like(valid)
    return dataclasses.replace(batch, weight=weight * valid)
