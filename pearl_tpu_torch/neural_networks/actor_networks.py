"""Actor networks (port of `pearl_tpu/neural_networks/actor_networks.py`).

Each network is a frozen-dataclass adapter over an `nn.Module`, with the
reference's protocol. The discrete actors (`VanillaActorNetwork`,
`DynamicActionActorNetwork`, `CNNActorNetwork`):

    init(generator, state_dim, action_dim, num_actions) -> nn.Module (params)
    logits(params, state, actions (B, A, a), mask) -> (B, A)  (unavailable -> -inf)
    get_policy_distribution(params, state, actions, mask) -> probs (B, A)

The continuous actors (`VanillaContinuousActorNetwork`, `GaussianActorNetwork`):

    init(generator, state_dim, action_dim) -> nn.Module (params)
    sample_action(params, state, generator, low, high, noise=None)
        -> (action (B, d), log_prob (B,))
    (deterministic actors return log_prob = zeros)

`generator` in `init` is a CPU `torch.Generator` for the weight init; in
`sample_action` it is on the device. `noise`, when given, is the standard
normal draw (B, d) the generator would have made: the tests hand both
packages the same numbers. `low` and `high` are (d,) tensors on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP, dense, nchw_images, promoted_linear
from pearl_tpu_torch.neural_networks.q_value_networks import _CNNQNet

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0
_EPS = 1e-6


def action_scaling(low, high, normalized_action):
    """Map [-1, 1]^d -> [low, high]^d."""
    return low + (normalized_action + 1.0) * 0.5 * (high - low)


def action_unscaling(low, high, action):
    return (action - low) / (high - low) * 2.0 - 1.0


def noise_scaling(low, high, noise):
    """Scale noise in [-1, 1] units to action-range units."""
    return noise * (high - low) / 2.0


def standard_normal(shape, like: torch.Tensor, generator, noise=None) -> torch.Tensor:
    """`noise` if given, else a float32 standard normal draw of `shape` on
    `like`'s device from `generator`."""
    if noise is not None:
        return noise
    return torch.randn(shape, generator=generator, device=like.device)


def _masked(raw: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return raw if mask is None else torch.where(mask, raw, float("-inf"))


class _LogitsNet(nn.Module):
    """state -> one logit per action (flax `_LogitsNet`: `MLP_0`)."""

    def __init__(self, state_dim, hidden_dims, num_actions, generator=None):
        super().__init__()
        self.MLP_0 = MLP(state_dim, hidden_dims, num_actions, generator)

    def forward(self, state):
        return self.MLP_0(state)


@dataclasses.dataclass(frozen=True)
class VanillaActorNetwork:
    """Softmax policy over a fixed action set: an MLP with one logit per
    action."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int) -> nn.Module:
        del action_dim
        return _LogitsNet(state_dim, tuple(self.hidden_dims), num_actions, generator)

    def logits(self, params, state, actions, mask=None):
        return _masked(params(state), mask)

    def get_policy_distribution(self, params, state, actions, mask=None):
        return torch.softmax(self.logits(params, state, actions, mask), dim=-1)


class _PairScoreNet(nn.Module):
    """concat(state, action) -> one score (flax `_PairScoreNet`: `MLP_0`)."""

    def __init__(self, input_dim, hidden_dims, generator=None):
        super().__init__()
        self.MLP_0 = MLP(input_dim, hidden_dims, 1, generator)

    def forward(self, x):
        return self.MLP_0(x)


@dataclasses.dataclass(frozen=True)
class DynamicActionActorNetwork:
    """Scores each (state, action representation) pair and takes the softmax
    over the available actions: the logits come from action features, not
    fixed heads, so the action set may change."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int) -> nn.Module:
        del num_actions
        return _PairScoreNet(state_dim + action_dim, tuple(self.hidden_dims), generator)

    def logits(self, params, state, actions, mask=None):
        B, A = actions.shape[0], actions.shape[1]
        s_rep = state[:, None, :].expand(B, A, state.shape[-1])
        x = torch.cat([s_rep, actions.to(state.dtype)], dim=-1).reshape(B * A, -1)
        return _masked(params(x).reshape(B, A), mask)

    def get_policy_distribution(self, params, state, actions, mask=None):
        return torch.softmax(self.logits(params, state, actions, mask), dim=-1)


@dataclasses.dataclass(frozen=True)
class CNNActorNetwork:
    """Softmax policy over image observations: flat (H, W, C) states are
    reshaped to images, scaled by 1/255 and run through the conv stack and
    an MLP with one logit per action (the module of `CNNQValueNetwork`)."""

    input_shape: Tuple[int, int, int] = (84, 84, 4)  # (H, W, C)
    out_channels: Sequence[int] = (16, 32)
    kernel_sizes: Sequence[int] = (8, 4)
    strides: Sequence[int] = (4, 2)
    paddings: Sequence[int] = (0, 0)
    hidden_dims: Sequence[int] = (128,)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int) -> nn.Module:
        del state_dim, action_dim
        return _CNNQNet(
            tuple(self.input_shape), tuple(self.out_channels), tuple(self.kernel_sizes),
            tuple(self.strides), tuple(self.paddings), tuple(self.hidden_dims), num_actions,
            generator,
        )

    def logits(self, params, state, actions, mask=None):
        return _masked(params(nchw_images(state, self.input_shape)), mask)

    def get_policy_distribution(self, params, state, actions, mask=None):
        return torch.softmax(self.logits(params, state, actions, mask), dim=-1)


class _DeterministicNet(nn.Module):
    """state -> tanh(MLP) in [-1, 1]^d (flax `_DeterministicNet`: `MLP_0`)."""

    def __init__(self, state_dim, hidden_dims, action_dim, generator=None):
        super().__init__()
        self.MLP_0 = MLP(state_dim, hidden_dims, action_dim, generator, last_activation="tanh")

    def forward(self, state):
        return self.MLP_0(state)


@dataclasses.dataclass(frozen=True)
class VanillaContinuousActorNetwork:
    """Deterministic tanh actor scaled into the action box."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int) -> nn.Module:
        return _DeterministicNet(state_dim, tuple(self.hidden_dims), action_dim, generator)

    def action(self, params, state, low, high):
        return action_scaling(low, high, params(state))

    def sample_action(self, params, state, generator, low, high, noise=None):
        del generator, noise
        a = self.action(params, state, low, high)
        return a, torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)


class _GaussianHeads(nn.Module):
    """MLP trunk with a relu on its last layer, then the `mu` and `log_std`
    heads (flax `_GaussianHeads`: `MLP_0`, `mu`, `log_std`). The heads are
    bare flax `Dense` layers: lecun-normal weights, zero bias."""

    def __init__(self, state_dim, hidden_dims, action_dim, generator=None):
        super().__init__()
        self.MLP_0 = MLP(
            state_dim, hidden_dims[:-1], hidden_dims[-1], generator, last_activation="relu"
        )
        self.mu = dense(hidden_dims[-1], action_dim, generator, xavier=False)
        self.log_std = dense(hidden_dims[-1], action_dim, generator, xavier=False)

    def forward(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.MLP_0(state)
        mu = promoted_linear(feat, self.mu)
        log_std = promoted_linear(feat, self.log_std)
        # Smoothly clamp log-std into [LOG_STD_MIN, LOG_STD_MAX].
        log_std = LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (torch.tanh(log_std) + 1.0)
        return mu, log_std


@dataclasses.dataclass(frozen=True)
class GaussianActorNetwork:
    """Tanh-squashed Gaussian actor with the log-prob's Jacobian correction."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int) -> nn.Module:
        return _GaussianHeads(state_dim, tuple(self.hidden_dims), action_dim, generator)

    def sample_action(
        self, params, state, generator, low, high, noise: Optional[torch.Tensor] = None
    ):
        """A reparameterised draw: grads flow to `params` through mu and std."""
        mu, log_std = params(state)
        std = torch.exp(log_std)
        eps = standard_normal(mu.shape, mu, generator, noise)
        pre_tanh = mu + std * eps
        action = action_scaling(low, high, torch.tanh(pre_tanh))
        log_prob = self._log_prob_from_pre_tanh(mu, log_std, pre_tanh, low, high)
        return action, log_prob

    def mean_action(self, params, state, low, high):
        mu, _ = params(state)
        return action_scaling(low, high, torch.tanh(mu))

    def get_log_probability(self, params, state, action, low, high):
        """log pi(a|s), the pre-tanh value recovered by atanh."""
        mu, log_std = params(state)
        squashed = torch.clamp(action_unscaling(low, high, action), -1 + _EPS, 1 - _EPS)
        pre_tanh = torch.atanh(squashed)
        return self._log_prob_from_pre_tanh(mu, log_std, pre_tanh, low, high)

    @staticmethod
    def _log_prob_from_pre_tanh(mu, log_std, pre_tanh, low, high):
        std = torch.exp(log_std)
        normal_lp = -0.5 * ((pre_tanh - mu) / std) ** 2 - log_std - 0.5 * math.log(2.0 * math.pi)
        squashed = torch.tanh(pre_tanh)
        # d/dx tanh correction + the affine scaling into [low, high].
        correction = torch.log(1.0 - squashed**2 + _EPS) + torch.log((high - low) / 2.0)
        return torch.sum(normal_lp - correction, dim=-1)
