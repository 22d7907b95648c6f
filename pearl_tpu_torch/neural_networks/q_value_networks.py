"""Q-value networks (port of `pearl_tpu/neural_networks/q_value_networks.py`,
`VanillaQValueNetwork` and `MultiHeadQValueNetwork` only).

Each network is a frozen-dataclass adapter over an `nn.Module`, with the
reference's protocol:

    init(generator, state_dim, action_dim, num_actions) -> nn.Module (params)
    q_all(params, state (B, s), actions (B, A, a), mask) -> (B, A)

`generator` is a CPU `torch.Generator` for the weight init; move the module
to its device afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP
from pearl_tpu_torch.ops.fused_mlp import fused_mlp_from_module


class _PairQNet(nn.Module):
    """MLP over concat(state, action) -> (N, 1) (flax `_PairQNet`)."""

    def __init__(self, state_dim, action_dim, hidden_dims, generator=None):
        super().__init__()
        self.MLP_0 = MLP(state_dim + action_dim, hidden_dims, 1, generator=generator)

    def forward(self, state, action):
        return self.MLP_0(torch.cat([state, action], dim=-1))


class _MultiHeadNet(nn.Module):
    """state -> one Q head per action (flax `_MultiHeadNet`)."""

    def __init__(self, state_dim, hidden_dims, num_actions, generator=None):
        super().__init__()
        self.MLP_0 = MLP(state_dim, hidden_dims, num_actions, generator=generator)

    def forward(self, state):
        return self.MLP_0(state)


@dataclasses.dataclass(frozen=True)
class VanillaQValueNetwork:
    """Q(s, a) via a concat-MLP evaluated over every candidate action."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del num_actions
        return _PairQNet(state_dim, action_dim, tuple(self.hidden_dims), generator)

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        B, A = actions.shape[0], actions.shape[1]
        state_rep = state[:, None, :].expand(B, A, state.shape[-1])
        q = params(state_rep.reshape(B * A, -1), actions.reshape(B * A, -1))
        return q.reshape(B, A)


@dataclasses.dataclass(frozen=True)
class MultiHeadQValueNetwork:
    """state -> one Q head per action. Ignores the action representation;
    candidate order is head order.

    `q_all` always runs the MLP through `ops.fused_mlp`: the hand-written
    kernel for a CUDA tensor, the plain chain for a CPU tensor. (The
    reference's environment-variable gate rests on a TPU measurement and is
    not carried over.)"""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del action_dim
        return _MultiHeadNet(state_dim, tuple(self.hidden_dims), num_actions, generator)

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        return fused_mlp_from_module(params.MLP_0, state)
