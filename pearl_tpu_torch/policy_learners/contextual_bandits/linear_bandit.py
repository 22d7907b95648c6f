"""LinUCB / LinTS (port of
`pearl_tpu/policy_learners/contextual_bandits/linear_bandit.py`).

Closed-form weighted least squares on [state; action representation]
features; the exploration module scores every arm from (mu, sigma): UCB's
mu + alpha * sigma, Thompson's sampled scores, SquareCB's and FastCB's
probabilities. Discounting of the statistics every
`apply_discounting_interval` of accumulated weight lives in
`LinearRegression`.

`learn` folds the whole buffer in once, each slot weighted by whether it was
written, and samples nothing: the agent clears an on-policy learner's buffer
after every learn, so each observation enters the statistics exactly once
(size the buffer to the envs and learn every step).

The arm protocol of `DisjointBanditContainer` works on a stack of arms, the
statistics with a leading arm axis:

    arms_init(generator, feature_dim, num_arms, device) -> arms state
    arms_mu_sigma(arms, feats (arms, B, f)) -> (mu, sigma), each (arms, B)
    arms_update(arms, feats (arms, N, f) or (N, f), reward (N,), weight (arms, N))
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pearl_tpu_torch.neural_networks.contextual_bandit import (
    LinearRegression,
    LinearRegressionState,
)
from pearl_tpu_torch.policy_learners.contextual_bandits.base import (
    ContextualBanditBase,
    whole_storage_batch,
)
from pearl_tpu_torch.utils.collectives import check_pmean_axis


@dataclasses.dataclass
class LinearBanditState:
    model: LinearRegressionState
    explore_state: Any
    action_elements: torch.Tensor  # (A, a) on the device
    action_reps: torch.Tensor  # (A, r) on the device
    summarizer_params: Any = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class LinearBandit(ContextualBanditBase):
    l2_reg_lambda: float = 1.0
    gamma: float = 1.0
    apply_discounting_interval: float = 0.0
    pmean_axis: Any = None  # a `MeshAxis` over which the statistics are summed

    def __post_init__(self):
        check_pmean_axis(self.pmean_axis)

    @property
    def on_policy(self) -> bool:
        return True

    def _model(self, feature_dim: int) -> LinearRegression:
        return LinearRegression(
            feature_dim=feature_dim,
            l2_reg_lambda=self.l2_reg_lambda,
            gamma=self.gamma,
            apply_discounting_interval=self.apply_discounting_interval,
            pmean_axis=self.pmean_axis,
        )

    def model_def_for(self, model_state: LinearRegressionState) -> LinearRegression:
        """The regression config of a state, from its own width."""
        return self._model(int(model_state.A.shape[-1]) - 1)

    def init(self, generator, observation_dim, action_space, num_envs, device):
        model = self._model(self.feature_dim(observation_dim)).init(device)
        return LinearBanditState(model=model, **self._base_state_fields(num_envs, device))

    def mu_sigma(self, state: LinearBanditState, features):
        return self.model_def_for(state.model).mu_sigma(state.model, features)

    def learn_batch(self, state: LinearBanditState, batch):
        feats = self.batch_features(batch)
        model = self.model_def_for(state.model)
        new_model = model.update(state.model, feats, batch.reward, batch.weight)
        mse = torch.mean((model.predict(new_model, feats) - batch.reward) ** 2)
        return dataclasses.replace(state, model=new_model), {"mse": mse}

    def learn(self, state, buffer, buffer_state, generator, indices=None, batch_transform=None):
        """One `learn_batch` over the whole storage, unwritten slots weighted
        0 (`whole_storage_batch`)."""
        batch = whole_storage_batch(buffer_state, indices, batch_transform)
        state, metrics = self.learn_batch(state, batch)
        return state, buffer_state, metrics

    # --- the arm protocol of DisjointBanditContainer -----------------------
    def arms_init(self, generator, feature_dim: int, num_arms: int, device):
        del generator  # closed form: nothing is drawn
        return self._model(feature_dim).init(device, batch_shape=(num_arms,))

    def arms_mu_sigma(self, arms: LinearRegressionState, feats):
        return self.model_def_for(arms).mu_sigma(arms, feats)

    def arms_update(self, arms: LinearRegressionState, feats, reward, weight):
        return self.model_def_for(arms).update(arms, feats, reward, weight)
