"""Carry the JAX package's Q-network weights into the port's networks.

The JAX params arrive as a nested dict of numpy arrays with the flax tree's
names, e.g. for `MultiHeadQValueNetwork` and for `VanillaQValueNetwork`
(`_PairQNet`) alike:

    {"MLP_0": {"dense_0": {"kernel", "bias"}, ..., "dense_out": {...}}}

Flax `Dense.kernel` is (in, out); `nn.Linear.weight`, and therefore the
`fused_mlp` kernel's W, is (out, in): each kernel is transposed on the way in.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def load_flax_mlp(mlp: nn.Module, params: Mapping) -> None:
    """Copy a flax `MLP` param dict into a `neural_networks.common.MLP`."""
    names = set(params)
    if names != set(mlp.layer_names):
        raise ValueError(f"flax MLP layers {sorted(names)} != port layers {mlp.layer_names}")
    for name, layer in zip(mlp.layer_names, mlp.layers()):
        kernel = torch.from_numpy(np.array(params[name]["kernel"], dtype=np.float32))
        bias = torch.from_numpy(np.array(params[name]["bias"], dtype=np.float32))
        if kernel.T.shape != layer.weight.shape or bias.shape != layer.bias.shape:
            raise ValueError(
                f"{name}: flax kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
                f"do not fit nn.Linear weight {tuple(layer.weight.shape)}"
            )
        layer.weight.copy_(kernel.T)
        layer.bias.copy_(bias)


def load_flax_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a Q-network's flax params (`{"MLP_0": {...}}`) into the port's
    `_MultiHeadNet` or `_PairQNet`; returns `net`."""
    if set(params) != {"MLP_0"}:
        raise ValueError(f"expected a {{'MLP_0': ...}} param tree, got keys {sorted(params)}")
    load_flax_mlp(net.MLP_0, params["MLP_0"])
    return net
