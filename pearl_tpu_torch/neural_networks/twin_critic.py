"""Twin critic (port of `pearl_tpu/neural_networks/twin_critic.py`,
`TwinCritic`; `CNNTwinCritic` waits for ROADMAP Queue A, item 13).

The reference holds the two critics as ONE set of stacked params (leading
axis 2) evaluated under `vmap`. The port keeps that layout: each layer is one
(2, in, out) kernel and one (2, out) bias, flax's own layout with the leading
2, and both members come out of one batched product per layer
(`torch.baddbmm`). Both members read the same concat(state, action) rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class _StackedDense(nn.Module):
    """`members` dense layers as kernel (members, in, out) and bias
    (members, out), each member's kernel xavier-uniform, biases zero."""

    def __init__(self, members: int, d_in: int, d_out: int, generator=None):
        super().__init__()
        kernel = torch.empty((members, d_in, d_out))
        bound = (6.0 / (d_in + d_out)) ** 0.5
        for m in range(members):
            # xavier-uniform of an (in, out) kernel: the same bound either way round.
            nn.init.uniform_(kernel[m], -bound, bound, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros((members, d_out)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (members, N, in) -> (members, N, out)."""
        return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class StackedMLP(nn.Module):
    """`members` relu MLPs with stacked params (`dense_0 ... dense_out`, the
    flax `MLP` names). `forward` takes (N, in) rows shared by every member,
    or (members, N, in), and returns (members, N, out)."""

    def __init__(
        self, members: int, input_dim: int, hidden_dims: Sequence[int], output_dim: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.members = members
        self.layer_names: List[str] = [f"dense_{i}" for i in range(len(hidden_dims))]
        self.layer_names.append("dense_out")
        dims = [input_dim, *hidden_dims, output_dim]
        for name, d_in, d_out in zip(self.layer_names, dims[:-1], dims[1:]):
            self.add_module(name, _StackedDense(members, d_in, d_out, generator))

    def layers(self) -> List[_StackedDense]:
        return [getattr(self, n) for n in self.layer_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand((self.members,) + tuple(x.shape))
        layers = self.layers()
        for layer in layers[:-1]:
            x = F.relu(layer(x))
        return layers[-1](x)


class _TwinPairQNet(nn.Module):
    """Two `_PairQNet`s, stacked: concat(state, action) -> (2, N)."""

    def __init__(self, state_dim, action_dim, hidden_dims, generator=None):
        super().__init__()
        self.MLP_0 = StackedMLP(2, state_dim + action_dim, hidden_dims, 1, generator)

    def forward(self, state, action):
        return self.MLP_0(torch.cat([state, action], dim=-1))[..., 0]


@dataclasses.dataclass(frozen=True)
class TwinCritic:
    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int) -> nn.Module:
        return _TwinPairQNet(state_dim, action_dim, tuple(self.hidden_dims), generator)

    def q_both(self, params, state, action) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q1, q2), each (B,)."""
        q = params(state, action)
        return q[0], q[1]

    def q_min(self, params, state, action) -> torch.Tensor:
        q1, q2 = self.q_both(params, state, action)
        return torch.minimum(q1, q2)
