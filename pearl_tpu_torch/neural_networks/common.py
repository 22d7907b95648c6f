"""Common NN building blocks (port of `pearl_tpu/neural_networks/common.py`).

Only what the ported paths use: the activation table with
`resolve_activation`, the relu MLP with an optional last activation (no
layer norm, dropout or skip connections), the conv feature
stack `ConvNet`, `nchw_images`, `select_index_last`, and the two
initializers of flax's `Dense` and `Conv` layers.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _normalized_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) / log(2), which is 1 at x = 0."""
    return F.softplus(x) / math.log(2.0)


# The JAX package's table, by name: flax's `gelu` is the tanh approximation
# and its `leaky_relu` has slope 0.01.
ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "linear": lambda x: x,
    "normalized_softplus": _normalized_softplus,
}


def resolve_activation(act) -> Callable[[torch.Tensor], torch.Tensor]:
    """An activation given by its name in `ACTIVATIONS` or as a callable."""
    if callable(act):
        return act
    return ACTIVATIONS[act]


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's default kernel init, in place: a normal truncated to [-2, 2]
    sigma, rescaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def dense(d_in: int, d_out: int, generator=None, xavier: bool = True) -> nn.Linear:
    """An `nn.Linear` initialised as flax's `Dense`: xavier-uniform (the
    reference `MLP`'s choice) or lecun-normal (a bare `nn.Dense`) weights,
    zero bias. Made on "meta" so that nn.Linear's own init draws nothing from
    the global RNG; the weights come from `generator`."""
    layer = nn.Linear(d_in, d_out, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        if xavier:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
        else:
            lecun_normal_(layer.weight, d_in, generator)
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """relu hiddens `dense_0 ... dense_{n-1}`, linear `dense_out` followed by
    `last_activation` (a name of `ACTIVATIONS` or None), xavier-uniform
    weights and zero biases — the reference `MLP`'s defaults. Layer names
    match the flax param dict so weights carry across by name."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int],
        output_dim: int = 1,
        generator: Optional[torch.Generator] = None,
        last_activation: Optional[str] = None,
    ):
        super().__init__()
        self.last_activation = last_activation
        self.layer_names: List[str] = [f"dense_{i}" for i in range(len(hidden_dims))]
        self.layer_names.append("dense_out")
        dims = [input_dim, *hidden_dims, output_dim]
        for name, d_in, d_out in zip(self.layer_names, dims[:-1], dims[1:]):
            self.add_module(name, dense(d_in, d_out, generator))

    def layers(self) -> List[nn.Linear]:
        return [getattr(self, n) for n in self.layer_names]

    def wb(self) -> Tuple[torch.Tensor, ...]:
        """(W1, b1, ..., Wn, bn) in layer order, W in nn.Linear's (out, in)
        layout — the argument list of `ops.fused_mlp.fused_mlp`."""
        out: List[torch.Tensor] = []
        for layer in self.layers():
            out += [layer.weight, layer.bias]
        return tuple(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers()
        for layer in layers[:-1]:
            x = F.relu(promoted_linear(x, layer))
        x = promoted_linear(x, layers[-1])
        if self.last_activation is not None:
            x = ACTIVATIONS[self.last_activation](x)
        return x


def promoted_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer(x)` in the promoted dtype of input and weights, as flax layers
    compute (float32 for a bfloat16 input under float32 weights). A no-op
    promotion when the dtypes agree."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class ConvNet(nn.Module):
    """Conv feature stack `conv_0 ... conv_{n-1}` with relu after each, then a
    flatten (the reference `ConvNet`). `forward` takes NCHW images in
    [0, 255] and applies the reference's float32 `/ 255` first; weights are
    OIHW (`nn.Conv2d`), lecun-normal with zero biases as flax's `nn.Conv`.
    The flatten is PyTorch's (C, H, W) order; `utils.jax_params` permutes the
    next layer's columns when weights are carried over from the reference's
    (H, W, C) flatten."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Sequence[int] = (16, 32),
        kernel_sizes: Sequence[int] = (8, 4),
        strides: Sequence[int] = (4, 2),
        paddings: Sequence[int] = (0, 0),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.layer_names: List[str] = [f"conv_{i}" for i in range(len(out_channels))]
        channels = [in_channels, *out_channels]
        for name, c_in, c_out, k, s, p in zip(
            self.layer_names, channels[:-1], channels[1:], kernel_sizes, strides, paddings
        ):
            layer = nn.Conv2d(c_in, c_out, k, stride=s, padding=p, device="meta").to_empty(
                device="cpu"
            )
            with torch.no_grad():
                lecun_normal_(layer.weight, c_in * k * k, generator)
                layer.bias.zero_()
            self.add_module(name, layer)

    def layers(self) -> List[nn.Conv2d]:
        return [getattr(self, n) for n in self.layer_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32) / 255.0
        for layer in self.layers():
            # float32 throughout, as flax promotes under lower-precision weights.
            weight, bias = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
            x = F.relu(F.conv2d(x, weight, bias, stride=layer.stride, padding=layer.padding))
        return x.flatten(1)


def nchw_images(state: torch.Tensor, input_shape: Sequence[int]) -> torch.Tensor:
    """Flat (B, H*W*C) states, the reference's NHWC images flattened, as an
    NCHW view for `conv2d`."""
    H, W, C = input_shape
    return state.reshape(state.shape[0], H, W, C).permute(0, 3, 1, 2)


def select_index_last(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[i, index[i]] as a one-hot multiply-sum, as the reference writes
    it (bit-identical to a gather: x*1 + 0*y is exact).

    values: (N, A); index: (N,) int; returns (N,)."""
    one_hot = F.one_hot(index.long(), values.shape[-1]).to(values.dtype)
    return (values * one_hot).sum(-1)
