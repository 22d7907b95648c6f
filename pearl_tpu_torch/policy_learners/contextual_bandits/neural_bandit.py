"""Neural bandit (port of
`pearl_tpu/policy_learners/contextual_bandits/neural_bandit.py`).

An MLP reward regressor on [state; action representation] with a weighted
mse, mae or cross-entropy loss (sigmoid, then a log with 1e-8 inside, as the
reference writes it); sigma is zero (the neural-linear bandit is the one with
uncertainty). AdamW as optax.adamw(lr, weight_decay=0.01): torch's AdamW is
the same decoupled update. `learn` is the base class's training_rounds x
(sample -> learn_batch).

For `DisjointBanditContainer` the arms are one `StackedMLP` (kernels
(arms, in, out)) under one AdamW: AdamW is elementwise, so one optimizer over
the stacked parameters is each arm's own, and an arm with no data in a step
still takes its weight decay and moment decay, as each arm's optax step does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP
from pearl_tpu_torch.neural_networks.twin_critic import StackedMLP
from pearl_tpu_torch.policy_learners.contextual_bandits.base import ContextualBanditBase


@dataclasses.dataclass
class NeuralBanditState:
    params: nn.Module
    optimizer: torch.optim.Optimizer
    explore_state: Any
    action_elements: torch.Tensor  # (A, a) on the device
    action_reps: torch.Tensor  # (A, r) on the device
    summarizer_params: Any = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NeuralArms:
    """A stack of neural arms: one `StackedMLP` and its AdamW."""

    params: StackedMLP
    optimizer: torch.optim.Optimizer


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """optax.adamw(learning_rate, weight_decay=0.01)."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class NeuralBandit(ContextualBanditBase):
    hidden_dims: tuple = (64, 64)
    learning_rate: float = 1e-3
    loss_type: str = "mse"  # mse | mae | cross_entropy
    training_rounds: int = 10
    batch_size: int = 128

    def init(self, generator, observation_dim, action_space, num_envs, device):
        net = MLP(self.feature_dim(observation_dim), tuple(self.hidden_dims), 1,
                  generator=generator).to(device)
        return NeuralBanditState(params=net, optimizer=adamw(net.parameters(), self.learning_rate),
                                 **self._base_state_fields(num_envs, device))

    def mu_sigma(self, state, features):
        B, A, f = features.shape
        mu = state.params(features.reshape(B * A, f))[..., 0].reshape(B, A)
        return mu, torch.zeros_like(mu)

    def _loss(self, pred, target, weight):
        """The weighted mean of the per-row loss over the last axis."""
        if self.loss_type == "mse":
            per = (pred - target) ** 2
        elif self.loss_type == "mae":
            per = torch.abs(pred - target)
        elif self.loss_type == "cross_entropy":
            p = torch.sigmoid(pred)
            per = -(target * torch.log(p + 1e-8) + (1 - target) * torch.log(1 - p + 1e-8))
        else:
            raise ValueError(f"unknown loss_type {self.loss_type}")
        return (per * weight).sum(-1) / torch.clamp(weight.sum(-1), min=1e-8)

    @staticmethod
    def _step(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()

    def learn_batch(self, state: NeuralBanditState, batch):
        feats = self.batch_features(batch)
        weight = batch.weight if batch.weight is not None else torch.ones_like(batch.reward)
        loss = self._loss(state.params(feats)[..., 0], batch.reward, weight)
        self._step(state.optimizer, loss)
        return state, {"loss": loss.detach()}

    # --- the arm protocol of DisjointBanditContainer (see linear_bandit.py) --
    def arms_init(self, generator, feature_dim: int, num_arms: int, device) -> NeuralArms:
        net = StackedMLP(num_arms, feature_dim, tuple(self.hidden_dims), 1, generator).to(device)
        return NeuralArms(params=net, optimizer=adamw(net.parameters(), self.learning_rate))

    def arms_mu_sigma(self, arms: NeuralArms, feats):
        mu = arms.params(feats)[..., 0]
        return mu, torch.zeros_like(mu)

    def arms_update(self, arms: NeuralArms, feats, reward, weight) -> NeuralArms:
        """One AdamW step of every arm on its weighted loss (the arms'
        parameters are disjoint, so the gradient of the sum is each arm's)."""
        loss = self._loss(arms.params(feats)[..., 0], reward, weight).sum()
        self._step(arms.optimizer, loss)
        return arms
