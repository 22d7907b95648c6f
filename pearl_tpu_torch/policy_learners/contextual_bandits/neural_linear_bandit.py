"""Neural LinUCB / Neural LinTS (port of
`pearl_tpu/policy_learners/contextual_bandits/neural_linear_bandit.py`).

An MLP feature extractor with an end-to-end linear head and LinUCB
statistics over the learned features. Each `learn_batch` takes one AdamW step
on the weighted squared error of the ACTIVATED head (output_activation of
the head's output), then folds the rows into the statistics over the
features the updated MLP gives, with no gradient through them.

`output_activation` and `separate_uncertainty` place the activation around
the UCB bonus:
- joint (False): score = activation(mu + alpha * sigma); `mu_sigma` returns
  mu before the activation and `get_scores` activates the combined score
  (the argmax of `act` is the same either way: the activation is monotone);
- separate (True): score = activation(mu) + alpha * sigma; `mu_sigma`
  activates mu.
With the default "linear" activation the two coincide.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pearl_tpu_torch.neural_networks.common import resolve_activation
from pearl_tpu_torch.neural_networks.contextual_bandit import (
    LinearRegressionState,
    NeuralLinearParams,
    NeuralLinearRegression,
)
from pearl_tpu_torch.policy_learners.contextual_bandits.base import ContextualBanditBase
from pearl_tpu_torch.policy_learners.contextual_bandits.neural_bandit import adamw
from pearl_tpu_torch.utils.collectives import check_pmean_axis, optimizer_params, pmean_grads


@dataclasses.dataclass
class NeuralLinearBanditState:
    mlp_params: torch.nn.Module
    head_params: torch.nn.Module
    linreg: LinearRegressionState
    optimizer: torch.optim.Optimizer  # over the MLP's and the head's parameters
    explore_state: Any
    action_elements: torch.Tensor  # (A, a) on the device
    action_reps: torch.Tensor  # (A, r) on the device
    summarizer_params: Any = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> NeuralLinearParams:
        return NeuralLinearParams(mlp=self.mlp_params, head=self.head_params, linreg=self.linreg)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class NeuralLinearBandit(ContextualBanditBase):
    hidden_dims: tuple = (64, 64)
    linear_feature_dim: int = 16
    learning_rate: float = 1e-3
    nn_e2e: bool = True
    l2_reg_lambda: float = 1.0
    pmean_axis: Any = None  # a `MeshAxis`: gradients averaged, statistics summed
    training_rounds: int = 10
    batch_size: int = 128
    output_activation: str = "linear"
    separate_uncertainty: bool = False

    def __post_init__(self):
        check_pmean_axis(self.pmean_axis)

    def _nlr(self, feature_dim: int) -> NeuralLinearRegression:
        return NeuralLinearRegression(
            feature_dim=feature_dim,
            hidden_dims=tuple(self.hidden_dims),
            linear_feature_dim=self.linear_feature_dim,
            nn_e2e=self.nn_e2e,
            output_activation=self.output_activation,
        )

    def init(self, generator, observation_dim, action_space, num_envs, device):
        params = self._nlr(self.feature_dim(observation_dim)).init(generator, device)
        trainable = [*params.mlp.parameters(), *params.head.parameters()]
        return NeuralLinearBanditState(
            mlp_params=params.mlp,
            head_params=params.head,
            linreg=params.linreg,
            optimizer=adamw(trainable, self.learning_rate),
            **self._base_state_fields(num_envs, device),
        )

    def mu_sigma(self, state, features):
        """(mu, sigma) per arm; mu activated here with `separate_uncertainty`."""
        B, A, f = features.shape
        nlr = self._nlr(f)
        mu, sigma, _ = nlr.forward_with_intermediate_values(
            state.params, features.reshape(B * A, f)
        )
        if self.separate_uncertainty:
            mu = nlr.apply_output_activation(mu)
        return mu.reshape(B, A), sigma.reshape(B, A)

    def get_scores(self, state, subjective_state):
        scores = super().get_scores(state, subjective_state)
        if not self.separate_uncertainty:
            scores = resolve_activation(self.output_activation)(scores)
        return scores

    def learn_batch(self, state: NeuralLinearBanditState, batch):
        feats_in = self.batch_features(batch)
        nlr = self._nlr(int(feats_in.shape[-1]))
        weight = batch.weight if batch.weight is not None else torch.ones_like(batch.reward)
        pred = nlr.apply_output_activation(state.head_params(state.mlp_params(feats_in))[..., 0])
        per = (pred - batch.reward) ** 2
        loss = (per * weight).sum() / torch.clamp(weight.sum(), min=1e-8)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        pmean_grads(optimizer_params(state.optimizer), self.pmean_axis)
        state.optimizer.step()
        with torch.no_grad():
            learned = state.mlp_params(feats_in)
        linreg = nlr.linear_regression(pmean_axis=self.pmean_axis).update(
            state.linreg, learned, batch.reward, weight
        )
        return dataclasses.replace(state, linreg=linreg), {"loss": loss.detach()}
