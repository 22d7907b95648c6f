"""Common NN building blocks (port of `pearl_tpu/neural_networks/common.py`).

The activation table with `resolve_activation` and `normalized_softplus`,
the MLP with every option of the reference's (activation, layer norm,
dropout, skip connections, the initializer, a last activation), flax's
`LayerNorm`, `ResidualWrapper`, the conv feature stack `ConvNet` with its
activation and normalisation, `nchw_images`, `select_index_last`,
`over_actions`, and the two initializers of flax's `Dense` and `Conv`
layers.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pearl_tpu_torch.utils.pytree import tree_map


def normalized_softplus(x: torch.Tensor) -> torch.Tensor:
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
    "normalized_softplus": normalized_softplus,
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


class LayerNorm(nn.Module):
    """flax's `LayerNorm`: eps 1e-6, the variance as E[x^2] - E[x]^2."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `Dropout` when not deterministic: each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), drawn from
    `generator` (there is no global RNG)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout with deterministic=False draws from a generator: pass one")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class MLP(nn.Module):
    """Hidden layers `dense_0 ... dense_{n-1}`, then a linear `dense_out`
    followed by `last_activation` (the reference `MLP`). Each hidden layer
    is, in the reference's order: dense, layer norm `ln_{i}` (with
    `use_layer_norm`), dropout (with `dropout_rate` > 0, only when `forward`
    is called with `deterministic=False`, as flax), `activation`, and then
    the input added back where `use_skip_connections` and the widths agree.
    Weights are xavier-uniform (lecun-normal without `use_xavier_init`),
    biases zero; activations are names of `ACTIVATIONS` or callables. Layer
    names match the flax param dict so weights carry across by name. The
    defaults are the plain relu chain, the only one `wb()` hands to
    `ops.fused_mlp`."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int],
        output_dim: int = 1,
        generator: Optional[torch.Generator] = None,
        last_activation=None,
        *,
        activation="relu",
        use_layer_norm: bool = False,
        use_skip_connections: bool = False,
        dropout_rate: float = 0.0,
        use_xavier_init: bool = True,
    ):
        super().__init__()
        self.activation = activation
        self.last_activation = last_activation
        self.use_layer_norm = use_layer_norm
        self.use_skip_connections = use_skip_connections
        self.dropout_rate = dropout_rate
        self.layer_names: List[str] = [f"dense_{i}" for i in range(len(hidden_dims))]
        self.layer_names.append("dense_out")
        self.norm_names: List[str] = (
            [f"ln_{i}" for i in range(len(hidden_dims))] if use_layer_norm else []
        )
        dims = [input_dim, *hidden_dims, output_dim]
        for name, d_in, d_out in zip(self.layer_names, dims[:-1], dims[1:]):
            self.add_module(name, dense(d_in, d_out, generator, xavier=use_xavier_init))
        for name, width in zip(self.norm_names, hidden_dims):
            self.add_module(name, LayerNorm(width))

    def layers(self) -> List[nn.Linear]:
        return [getattr(self, n) for n in self.layer_names]

    @property
    def is_plain_relu_chain(self) -> bool:
        """relu hiddens, a linear output, nothing else: what `fused_mlp`
        computes."""
        return (
            resolve_activation(self.activation) is F.relu
            and self.last_activation is None
            and not (self.use_layer_norm or self.use_skip_connections or self.dropout_rate > 0)
        )

    def wb(self) -> Tuple[torch.Tensor, ...]:
        """(W1, b1, ..., Wn, bn) in layer order, W in nn.Linear's (out, in)
        layout — the argument list of `ops.fused_mlp.fused_mlp`. Only a plain
        relu chain has one: the kernel computes nothing else."""
        if not self.is_plain_relu_chain:
            raise ValueError(
                "ops.fused_mlp computes the plain relu chain; this MLP has options "
                f"(activation={self.activation!r}, last_activation={self.last_activation!r}, "
                f"use_layer_norm={self.use_layer_norm}, use_skip_connections="
                f"{self.use_skip_connections}, dropout_rate={self.dropout_rate})"
            )
        out: List[torch.Tensor] = []
        for layer in self.layers():
            out += [layer.weight, layer.bias]
        return tuple(out)

    def forward(
        self, x: torch.Tensor, *, deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """`generator` is dropout's, used only with `deterministic=False`."""
        act = resolve_activation(self.activation)
        layers = self.layers()
        for i, layer in enumerate(layers[:-1]):
            y = promoted_linear(x, layer)
            if self.use_layer_norm:
                y = getattr(self, self.norm_names[i])(y)
            if self.dropout_rate > 0.0 and not deterministic:
                y = dropout(y, self.dropout_rate, generator)
            y = act(y)
            if self.use_skip_connections and x.shape[-1] == y.shape[-1]:
                y = y + x
            x = y
        x = promoted_linear(x, layers[-1])
        if self.last_activation is not None:
            x = resolve_activation(self.last_activation)(x)
        return x


class ResidualWrapper(nn.Module):
    """x + inner(x) (the reference's `ResidualWrapper`)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.inner(x)


def promoted_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer(x)` in the promoted dtype of input and weights, as flax layers
    compute (float32 for a bfloat16 input under float32 weights). A no-op
    promotion when the dtypes agree."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class ConvNet(nn.Module):
    """Conv feature stack `conv_0 ... conv_{n-1}`, each followed by
    `activation` (a name of `ACTIVATIONS` or a callable), then a flatten (the
    reference `ConvNet`). `forward` takes NCHW images; with `normalize` (the
    default) they are in [0, 255] and the reference's float32 `/ 255` comes
    first, without it they go in as they are, in the promoted dtype of input
    and weights. Weights are OIHW (`nn.Conv2d`), lecun-normal with zero
    biases as flax's `nn.Conv`. The flatten is PyTorch's (C, H, W) order;
    `utils.jax_params` permutes the next layer's columns when weights are
    carried over from the reference's (H, W, C) flatten. The frame kernels
    fold the `/ 255` and relu of the defaults into conv1: a kernel path asks
    `check_plain_relu_stack()` first."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Sequence[int] = (16, 32),
        kernel_sizes: Sequence[int] = (8, 4),
        strides: Sequence[int] = (4, 2),
        paddings: Sequence[int] = (0, 0),
        activation="relu",
        normalize: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.normalize = normalize
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

    def check_plain_relu_stack(self) -> None:
        """Raise unless this is the stack the frame kernels compute: `/ 255`
        inputs and relu after every conv (`MLP.wb()`'s rule for `fused_mlp`)."""
        if not self.normalize or resolve_activation(self.activation) is not F.relu:
            raise ValueError(
                "the frame kernels fold the / 255 and relu into conv1; this ConvNet has "
                f"activation={self.activation!r}, normalize={self.normalize}"
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = resolve_activation(self.activation)
        if self.normalize:
            x = x.to(torch.float32) / 255.0
        else:
            x = x.to(torch.promote_types(x.dtype, self.conv_0.weight.dtype))
        for layer in self.layers():
            # In x's dtype (float32 after `/ 255`), as flax promotes under
            # lower-precision weights.
            weight, bias = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
            x = act(F.conv2d(x, weight, bias, stride=layer.stride, padding=layer.padding))
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


def over_actions(fn, state: torch.Tensor, actions: torch.Tensor, *args):
    """`fn(state, action, *args)` for every candidate action: state (B, s)
    and actions (B, A, a) -> (B, A, ...). The state is broadcast across the
    action axis and (B, A) folded into one batch of B * A rows, so the
    network sees one product per layer. `fn` returns a tensor or a dict or
    dataclass of tensors, each reshaped."""
    B, A = actions.shape[0], actions.shape[1]
    state_rep = state[:, None, :].expand(B, A, state.shape[-1])
    out = fn(state_rep.reshape(B * A, -1), actions.reshape(B * A, -1), *args)
    return tree_map(lambda o: o.reshape((B, A) + o.shape[1:]), out)
