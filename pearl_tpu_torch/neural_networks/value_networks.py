"""State-value networks (port of `pearl_tpu/neural_networks/value_networks.py`).

Each network is a frozen-dataclass adapter over an `nn.Module`:

    init(generator, state_dim) -> nn.Module (params)
    value(params, state (B, s)) -> (B,)

`generator` is a CPU `torch.Generator` for the weight init.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP, nchw_images
from pearl_tpu_torch.neural_networks.q_value_networks import _CNNQNet


class _ValueNet(nn.Module):
    """state -> V(s) (flax `_ValueNet`: `MLP_0` with one output)."""

    def __init__(self, state_dim, hidden_dims, generator=None):
        super().__init__()
        self.MLP_0 = MLP(state_dim, hidden_dims, 1, generator)

    def forward(self, state):
        return self.MLP_0(state)[..., 0]


@dataclasses.dataclass(frozen=True)
class VanillaValueNetwork:
    """MLP V(s)."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int) -> nn.Module:
        return _ValueNet(state_dim, tuple(self.hidden_dims), generator)

    def value(self, params, state):
        return params(state)


@dataclasses.dataclass(frozen=True)
class CNNValueNetwork:
    """Conv stack, flatten, MLP V(s) over flat (H, W, C) image states scaled
    by 1/255 (the module of `CNNQValueNetwork` with one head)."""

    input_shape: Tuple[int, int, int] = (84, 84, 4)  # (H, W, C)
    out_channels: Sequence[int] = (16, 32)
    kernel_sizes: Sequence[int] = (8, 4)
    strides: Sequence[int] = (4, 2)
    paddings: Sequence[int] = (0, 0)
    hidden_dims: Sequence[int] = (128,)

    def init(self, generator, state_dim: int) -> nn.Module:
        del state_dim  # the flat state is reshaped to input_shape
        return _CNNQNet(
            tuple(self.input_shape), tuple(self.out_channels), tuple(self.kernel_sizes),
            tuple(self.strides), tuple(self.paddings), tuple(self.hidden_dims), 1, generator,
        )

    def value(self, params, state):
        return params(nchw_images(state, self.input_shape))[..., 0]
