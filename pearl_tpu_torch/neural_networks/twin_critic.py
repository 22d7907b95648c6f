"""Twin critics (port of `pearl_tpu/neural_networks/twin_critic.py`:
`TwinCritic` and `CNNTwinCritic`).

The reference holds the two critics as ONE set of stacked params (leading
axis 2) evaluated under `vmap`. The port keeps that layout: each layer is one
(2, ...) kernel and one (2, out) bias, flax's own layout with the leading 2.
`TwinCritic`'s members come out of one batched product per layer
(`torch.baddbmm`) over the same concat(state, action) rows; `CNNTwinCritic`
runs both members' convolutions as one grouped `conv2d` per layer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pearl_tpu_torch.neural_networks.common import lecun_normal_, nchw_images


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


class StackedPairQNet(nn.Module):
    """`members` `_PairQNet`s, stacked: concat(state, action) -> (members, N).
    The twin critic's two members and the ensemble Q-network's K."""

    def __init__(self, members, state_dim, action_dim, hidden_dims, generator=None):
        super().__init__()
        self.MLP_0 = StackedMLP(members, state_dim + action_dim, hidden_dims, 1, generator)

    def forward(self, state, action):
        return self.MLP_0(torch.cat([state, action], dim=-1))[..., 0]


@dataclasses.dataclass(frozen=True)
class TwinCritic:
    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int) -> nn.Module:
        return StackedPairQNet(2, state_dim, action_dim, tuple(self.hidden_dims), generator)

    def q_both(self, params, state, action) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q1, q2), each (B,)."""
        q = params(state, action)
        return q[0], q[1]

    def q_min(self, params, state, action) -> torch.Tensor:
        q1, q2 = self.q_both(params, state, action)
        return torch.minimum(q1, q2)


class _StackedConv(nn.Module):
    """`members` conv layers as weight (members, out, in, k, k) and bias
    (members, out), each member's weight lecun-normal, biases zero (flax
    `nn.Conv` under `vmap`)."""

    def __init__(self, members, c_in, c_out, k, stride, padding, generator=None):
        super().__init__()
        weight = torch.empty((members, c_out, c_in, k, k))
        for m in range(members):
            lecun_normal_(weight[m], c_in * k * k, generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros((members, c_out)))
        self.stride, self.padding = stride, padding


class StackedConvNet(nn.Module):
    """`members` relu conv stacks `conv_0 ... conv_{n-1}` with stacked
    params, over NCHW images in [0, 255] that every member reads (scaled by
    1/255 first, as `ConvNet`). The first layer runs every member's filters
    at once and the later ones as a grouped conv (group m = member m), so a
    layer is one `conv2d` for all members. Returns (members, N, features),
    each member's features flattened in (C, H, W) order."""

    def __init__(self, members, in_channels, out_channels, kernel_sizes, strides, paddings,
                 generator=None):
        super().__init__()
        self.members = members
        self.layer_names: List[str] = [f"conv_{i}" for i in range(len(out_channels))]
        channels = [in_channels, *out_channels]
        for name, c_in, c_out, k, s, p in zip(
            self.layer_names, channels[:-1], channels[1:], kernel_sizes, strides, paddings
        ):
            self.add_module(name, _StackedConv(members, c_in, c_out, k, s, p, generator))

    def layers(self) -> List[_StackedConv]:
        return [getattr(self, n) for n in self.layer_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32) / 255.0
        for i, layer in enumerate(self.layers()):
            weight = layer.weight.reshape((-1,) + tuple(layer.weight.shape[2:]))
            x = F.relu(F.conv2d(
                x, weight, layer.bias.reshape(-1), stride=layer.stride, padding=layer.padding,
                groups=1 if i == 0 else self.members,
            ))
        return x.reshape(x.shape[0], self.members, -1).transpose(0, 1)


class _CNNTwinNet(nn.Module):
    """Two `_CNNQNet`s, stacked (flax's `conv` with `conv_i`, then `MLP_0`,
    every leaf with a leading 2): images -> (2, N, num_actions)."""

    def __init__(self, input_shape, out_channels, kernel_sizes, strides, paddings, hidden_dims,
                 num_actions, generator=None):
        super().__init__()
        H, W, C = input_shape
        self.conv = StackedConvNet(2, C, out_channels, kernel_sizes, strides, paddings, generator)
        for k, s, p in zip(kernel_sizes, strides, paddings):
            H, W = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        self.feature_shape = (out_channels[-1], H, W)  # (C, H, W), the flatten's order
        self.MLP_0 = StackedMLP(2, out_channels[-1] * H * W, hidden_dims, num_actions, generator)

    def forward(self, images):
        return self.MLP_0(self.conv(images))


@dataclasses.dataclass(frozen=True)
class CNNTwinCritic:
    """Twin multi-head CNN Q critics over image states: each member scores
    every action from the state alone, so the convolutions run once per
    state, not once per (state, candidate action) pair. `state` arrives
    flat, the (H, W, C) image flattened, and is reshaped to `input_shape`."""

    input_shape: Tuple[int, int, int] = (84, 84, 4)  # (H, W, C)
    out_channels: Sequence[int] = (16, 32)
    kernel_sizes: Sequence[int] = (8, 4)
    strides: Sequence[int] = (4, 2)
    paddings: Sequence[int] = (0, 0)
    hidden_dims: Sequence[int] = (128,)

    def init(self, generator, state_dim: int, action_dim: int) -> nn.Module:
        # Discrete SAC passes one-hot action representations, so action_dim
        # is the number of actions (= the number of Q heads).
        del state_dim
        return _CNNTwinNet(
            tuple(self.input_shape), tuple(self.out_channels), tuple(self.kernel_sizes),
            tuple(self.strides), tuple(self.paddings), tuple(self.hidden_dims), action_dim,
            generator,
        )

    def q_all_both(self, params, state, candidates) -> Tuple[torch.Tensor, torch.Tensor]:
        """((B, A), (B, A)): every candidate action's Q under both members."""
        q = params(nchw_images(state, self.input_shape))
        return q[0], q[1]

    def q_both(self, params, state, action) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q1, q2), each (B,), for one-hot `action` rows."""
        q1, q2 = self.q_all_both(params, state, None)
        return torch.sum(q1 * action, dim=-1), torch.sum(q2 * action, dim=-1)

    def q_min(self, params, state, action) -> torch.Tensor:
        q1, q2 = self.q_both(params, state, action)
        return torch.minimum(q1, q2)
