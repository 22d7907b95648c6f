"""Carry the JAX package's Q-network weights into the port's networks.

The JAX params arrive as a nested dict of numpy arrays with the flax tree's
names, e.g. for `MultiHeadQValueNetwork` and for `VanillaQValueNetwork`
(`_PairQNet`) alike:

    {"MLP_0": {"dense_0": {"kernel", "bias"}, ..., "dense_out": {...}}}

`QuantileQValueNetwork` has the same `_PairQNet` tree with N outputs, and
`DuelingQValueNetwork` three MLPs, `{"state_arch", "value_arch",
"advantage_arch"}` (`load_flax_dueling_q_params`).

Flax `Dense.kernel` is (in, out); `nn.Linear.weight`, and therefore the
`fused_mlp` kernel's W, is (out, in): each kernel is transposed on the way in.
`CNNQValueNetwork`'s tree adds `{"conv": {"conv_0": {"kernel", "bias"}, ...}}`
with HWIO kernels (`load_flax_cnn_q_params`).

`frame_ring_view_from_numpy` carries the frame-ring state across: a JAX
`FrameRingView`'s ring, validity mask, cursor and conv1 cache.

The continuous-control networks: `GaussianActorNetwork`'s tree is
`{"MLP_0": {...}, "mu": {kernel, bias}, "log_std": {kernel, bias}}`,
`VanillaContinuousActorNetwork`'s `{"MLP_0": {...}}`, and `TwinCritic`'s
`{"MLP_0": {...}}` with a leading 2 on every leaf (the two members'
stacked params), which the port keeps as they are.

The discrete actors and the value networks: `VanillaActorNetwork`,
`DynamicActionActorNetwork` and `VanillaValueNetwork` have `{"MLP_0":
{...}}`, `CNNActorNetwork` and `CNNValueNetwork` the CNN Q-network's tree
(`load_flax_discrete_actor_params`, `load_flax_value_params`);
`CNNTwinCritic` has the CNN tree with a leading 2 on every leaf
(`load_flax_cnn_twin_critic_params`).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

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
        load_flax_dense(layer, params[name], name)


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


@torch.no_grad()
def load_flax_dense(layer: nn.Linear, params: Mapping, name: str) -> None:
    """Copy a flax `Dense` ({kernel (in, out), bias}) into an `nn.Linear`."""
    kernel, bias = _np(params["kernel"]), _np(params["bias"])
    if kernel.T.shape != layer.weight.shape or bias.shape != layer.bias.shape:
        raise ValueError(
            f"{name}: flax kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
            f"do not fit nn.Linear weight {tuple(layer.weight.shape)}"
        )
    layer.weight.copy_(kernel.T)
    layer.bias.copy_(bias)


def _check_keys(params: Mapping, keys) -> None:
    if set(params) != set(keys):
        raise ValueError(f"expected a param tree with keys {sorted(keys)}, got {sorted(params)}")


def load_flax_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a Q-network's flax params (`{"MLP_0": {...}}`) into the port's
    `_MultiHeadNet` or `_PairQNet` (the Vanilla and the Quantile network);
    returns `net`."""
    if set(params) != {"MLP_0"}:
        raise ValueError(f"expected a {{'MLP_0': ...}} param tree, got keys {sorted(params)}")
    load_flax_mlp(net.MLP_0, params["MLP_0"])
    return net


def load_flax_dueling_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `DuelingQValueNetwork`'s flax params into the port's
    `_DuelingNet`; returns `net`."""
    names = ("state_arch", "value_arch", "advantage_arch")
    _check_keys(params, names)
    for name in names:
        load_flax_mlp(getattr(net, name), params[name])
    return net


def load_flax_gaussian_actor_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `GaussianActorNetwork`'s flax params into the port's
    `_GaussianHeads`; returns `net`."""
    _check_keys(params, ("MLP_0", "mu", "log_std"))
    load_flax_mlp(net.MLP_0, params["MLP_0"])
    load_flax_dense(net.mu, params["mu"], "mu")
    load_flax_dense(net.log_std, params["log_std"], "log_std")
    return net


def load_flax_deterministic_actor_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `VanillaContinuousActorNetwork`'s flax params into the port's
    `_DeterministicNet`; returns `net`."""
    _check_keys(params, ("MLP_0",))
    load_flax_mlp(net.MLP_0, params["MLP_0"])
    return net


@torch.no_grad()
def load_flax_twin_critic_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `TwinCritic`'s stacked flax params, every leaf with its leading
    2, into the port's `_TwinPairQNet` (the same layout); returns `net`."""
    _check_keys(params, ("MLP_0",))
    mlp = net.MLP_0
    if set(params["MLP_0"]) != set(mlp.layer_names):
        raise ValueError(
            f"flax MLP layers {sorted(params['MLP_0'])} != port layers {mlp.layer_names}"
        )
    for name, layer in zip(mlp.layer_names, mlp.layers()):
        for leaf in ("kernel", "bias"):
            value, target = _np(params["MLP_0"][name][leaf]), getattr(layer, leaf)
            if value.shape != target.shape:
                raise ValueError(
                    f"{name}.{leaf}: flax {tuple(value.shape)} != port {tuple(target.shape)}"
                )
            target.copy_(value)
    return net


@torch.no_grad()
def load_flax_cnn_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `CNNQValueNetwork`'s flax params,
    `{"conv": {"conv_i": {kernel, bias}}, "MLP_0": {...}}`, into the port's
    `_CNNQNet`; returns `net`.

    Flax conv kernels are HWIO and `nn.Conv2d` weights OIHW: each is
    transposed (3, 2, 0, 1). The reference flattens its NHWC features as
    (H, W, C) and the port flattens NCHW as (C, H, W), so the rows of the
    first MLP kernel are permuted to the port's order on the way in."""
    if set(params) != {"conv", "MLP_0"}:
        raise ValueError(f"expected a {{'conv', 'MLP_0'}} param tree, got keys {sorted(params)}")
    if set(params["conv"]) != set(net.conv.layer_names):
        raise ValueError(
            f"flax conv layers {sorted(params['conv'])} != port layers {net.conv.layer_names}"
        )
    for name, layer in zip(net.conv.layer_names, net.conv.layers()):
        kernel = torch.from_numpy(np.array(params["conv"][name]["kernel"], dtype=np.float32))
        bias = torch.from_numpy(np.array(params["conv"][name]["bias"], dtype=np.float32))
        weight = kernel.permute(3, 2, 0, 1)
        if weight.shape != layer.weight.shape or bias.shape != layer.bias.shape:
            raise ValueError(
                f"{name}: flax kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
                f"do not fit nn.Conv2d weight {tuple(layer.weight.shape)}"
            )
        layer.weight.copy_(weight)
        layer.bias.copy_(bias)
    mlp = {name: dict(layer) for name, layer in params["MLP_0"].items()}
    first = net.MLP_0.layer_names[0]
    mlp[first]["kernel"] = _hwc_rows_to_chw(
        np.array(mlp[first]["kernel"], dtype=np.float32), net.feature_shape
    )
    load_flax_mlp(net.MLP_0, mlp)
    return net


def load_flax_discrete_actor_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a discrete actor's flax params (`{"MLP_0"}`, or the CNN's
    `{"conv", "MLP_0"}`) into the port's module; returns `net`."""
    return load_flax_cnn_q_params(net, params) if "conv" in params else load_flax_q_params(
        net, params
    )


def load_flax_value_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a value network's flax params (`{"MLP_0"}`, or the CNN's
    `{"conv", "MLP_0"}`) into the port's module; returns `net`."""
    return load_flax_discrete_actor_params(net, params)


def _hwc_rows_to_chw(kernel: np.ndarray, feature_shape) -> np.ndarray:
    """The rows of an (..., H*W*C, out) kernel, in the reference's (H, W, C)
    flatten order, permuted to the port's (C, H, W) order."""
    C, H, W = feature_shape
    lead = kernel.shape[:-2]
    if kernel.shape[-2] != H * W * C:
        raise ValueError(f"kernel {kernel.shape} does not take {H}x{W}x{C} features")
    k = kernel.reshape(lead + (H, W, C, kernel.shape[-1]))
    n = len(lead)
    order = tuple(range(n)) + (n + 2, n, n + 1, n + 3)
    return k.transpose(order).reshape(lead + (H * W * C, kernel.shape[-1]))


@torch.no_grad()
def load_flax_cnn_twin_critic_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `CNNTwinCritic`'s stacked flax params (the CNN tree, every leaf
    with its leading 2) into the port's `_CNNTwinNet`; returns `net`. Conv
    kernels (2, k, k, I, O) become (2, O, I, k, k), and the first MLP
    kernel's rows move to the port's flatten order."""
    _check_keys(params, ("conv", "MLP_0"))
    _check_keys(params["conv"], net.conv.layer_names)
    _check_keys(params["MLP_0"], net.MLP_0.layer_names)
    leaves = []
    for name, layer in zip(net.conv.layer_names, net.conv.layers()):
        kernel = np.array(params["conv"][name]["kernel"], dtype=np.float32)
        leaves += [(f"conv.{name}.weight", kernel.transpose(0, 4, 3, 1, 2), layer.weight),
                   (f"conv.{name}.bias", params["conv"][name]["bias"], layer.bias)]
    first = net.MLP_0.layer_names[0]
    for name, layer in zip(net.MLP_0.layer_names, net.MLP_0.layers()):
        kernel = np.array(params["MLP_0"][name]["kernel"], dtype=np.float32)
        if name == first:
            kernel = _hwc_rows_to_chw(kernel, net.feature_shape)
        leaves += [(f"MLP_0.{name}.kernel", kernel, layer.kernel),
                   (f"MLP_0.{name}.bias", params["MLP_0"][name]["bias"], layer.bias)]
    for name, value, target in leaves:
        value = _np(value)
        if value.shape != target.shape:
            raise ValueError(f"{name}: flax {tuple(value.shape)} != port {tuple(target.shape)}")
        target.copy_(value)
    return net


def conv1_cache_from_numpy(cache: np.ndarray, conv1_out: Tuple[int, int, int]) -> torch.Tensor:
    """The JAX package's conv1 cache, (T, P, D, B) with D in (OH, OW, OC)
    order, as the port's (T, P, B, D') with D' in (OC, OH, OW) order
    (`ops/conv_cache.py`). `conv1_out` is conv1's (OH, OW, OC)."""
    OH, OW, OC = conv1_out
    T, P, D, B = cache.shape
    if D != OH * OW * OC:
        raise ValueError(f"cache D = {D} is not OH*OW*OC = {OH}*{OW}*{OC}")
    moved = cache.reshape(T, P, OH, OW, OC, B).transpose(0, 1, 5, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(moved).reshape(T, P, B, D))


def frame_ring_view_from_numpy(
    ring: np.ndarray,
    valid: np.ndarray,
    cursor: int,
    cache: Optional[np.ndarray] = None,
    conv1_out: Optional[Tuple[int, int, int]] = None,
    dtype: Optional[torch.dtype] = None,
):
    """A JAX `FrameRingView`'s leaves, as numpy arrays (a bfloat16 leaf
    converted to float32 first), into the port's `FrameRingView` on the CPU:
    ring (B, T, F) and valid (B, T) as they are, the cursor as a host
    integer, and the conv1 cache (with conv1's `conv1_out` = (OH, OW, OC))
    in the port's layout. `dtype` casts ring and cache (exact for values
    that came from that dtype)."""
    from pearl_tpu_torch.history_summarization_modules.frame_ring import FrameRingView

    view = FrameRingView(
        ring=torch.from_numpy(np.array(ring)),
        valid=torch.from_numpy(np.array(valid, dtype=bool)),
        cursor=int(cursor),
    )
    if cache is not None:
        if conv1_out is None:
            raise ValueError("a cache needs conv1_out = (OH, OW, OC) to be laid out")
        view.cache = conv1_cache_from_numpy(np.array(cache), conv1_out)
    if dtype is not None:
        view.ring = view.ring.to(dtype)
        if view.cache is not None:
            view.cache = view.cache.to(dtype)
    return view
