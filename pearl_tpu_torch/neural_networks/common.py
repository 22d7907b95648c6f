"""Common NN building blocks (port of `pearl_tpu/neural_networks/common.py`).

Only what the DQN path uses is ported: the plain relu MLP (no layer norm,
dropout or skip connections) and `select_index_last`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    """relu hiddens `dense_0 ... dense_{n-1}`, linear `dense_out`, xavier-
    uniform weights and zero biases — the reference `MLP`'s defaults. Layer
    names match the flax param dict so weights carry across by name."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int],
        output_dim: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.layer_names: List[str] = [f"dense_{i}" for i in range(len(hidden_dims))]
        self.layer_names.append("dense_out")
        dims = [input_dim, *hidden_dims, output_dim]
        for name, d_in, d_out in zip(self.layer_names, dims[:-1], dims[1:]):
            # Made on "meta" so that nn.Linear's own init draws nothing from
            # the global RNG; the weights come from `generator` below.
            layer = nn.Linear(d_in, d_out, device="meta").to_empty(device="cpu")
            with torch.no_grad():
                nn.init.xavier_uniform_(layer.weight, generator=generator)
                layer.bias.zero_()
            self.add_module(name, layer)

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
            x = F.relu(layer(x))
        return layers[-1](x)


def select_index_last(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[i, index[i]] as a one-hot multiply-sum, as the reference writes
    it (bit-identical to a gather: x*1 + 0*y is exact).

    values: (N, A); index: (N,) int; returns (N,)."""
    one_hot = F.one_hot(index.long(), values.shape[-1]).to(values.dtype)
    return (values * one_hot).sum(-1)
