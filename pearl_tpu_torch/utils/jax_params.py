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
with HWIO kernels (`load_flax_cnn_q_params`); a standalone `ConvNet`'s tree
is that `conv` part (`load_flax_conv_net`).

`frame_ring_view_from_numpy` carries the frame-ring state across: a JAX
`FrameRingView`'s ring, validity mask, cursor and conv1 cache.

The continuous-control networks: `GaussianActorNetwork`'s tree is
`{"MLP_0": {...}, "mu": {kernel, bias}, "log_std": {kernel, bias}}`,
`VanillaContinuousActorNetwork`'s `{"MLP_0": {...}}`, and `TwinCritic`'s
`{"MLP_0": {...}}` with a leading 2 on every leaf (the two members'
stacked params), which the port keeps as they are.

The ensemble and epistemic networks: `EnsembleQValueNetwork`'s tree is
`{"train", "prior"}`, each `{"MLP_0": {...}}` with a leading K on every leaf
(`load_flax_ensemble_q_params`); `TwoTowerQValueNetwork`'s `{"state_tower",
"action_tower", "interaction"}`; `MLPWithPrior`'s `{"train", "prior"}` of
bare MLP trees and `Epinet`'s `{"train": {"MLP_0"}, "prior": {"MLP_0"}}`
with the prior stacked (`load_flax_mlp_with_prior_params`,
`load_flax_epinet_params`).

The discrete actors and the value networks: `VanillaActorNetwork`,
`DynamicActionActorNetwork` and `VanillaValueNetwork` have `{"MLP_0":
{...}}`, `CNNActorNetwork` and `CNNValueNetwork` the CNN Q-network's tree
(`load_flax_discrete_actor_params`, `load_flax_value_params`);
`CNNTwinCritic` has the CNN tree with a leading 2 on every leaf
(`load_flax_cnn_twin_critic_params`). `load_flax_iql_state` composes the
actor, twin critic and value loaders over an IQL learner's state.

The learned history summarizers: the LSTM's tree is one flax `LSTMCell`
per layer, `{"LSTMCell_k": {"ii", "if", "ig", "io": {kernel (in, H)},
"hi", "hf", "hg", "ho": {kernel (H, H), bias (H,)}}}`, in torch's gate order
(i, f, g, o) (`load_flax_lstm_params`); the transformer's `{"embed",
"pos_embedding" (1, T, d) when learned, "ln1_i", "attn_i": {"query", "key",
"value": {kernel (d, heads, d/heads), bias (heads, d/heads)}, "out": {kernel
(heads, d/heads, d), bias (d,)}}, "ln2_i", "mlp1_i", "mlp2_i", "ln_f"}`
(`load_flax_transformer_params`).

`recommender_env_from_jax` builds the port's recommender env from a JAX
env's catalog and user-model arrays.

The contextual bandits: `load_flax_linreg_state` (A, b, sum_weight,
weight_since_discount), a `NeuralBandit`'s MLP through `load_flax_mlp`,
`load_flax_neural_linear_state` (`{"mlp", "head", "linreg"}`) and
`load_flax_disjoint_models` (the container's stacked arm states; neural arms
through `load_flax_stacked_mlp`).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def load_flax_mlp(mlp: nn.Module, params: Mapping) -> None:
    """Copy a flax `MLP` param dict (its `dense_{i}`, `dense_out` and, with
    layer norm, `ln_{i}`) into a `neural_networks.common.MLP`."""
    names = set(params)
    norms = getattr(mlp, "norm_names", [])
    if names != set(mlp.layer_names) | set(norms):
        raise ValueError(
            f"flax MLP layers {sorted(names)} != port layers {mlp.layer_names + norms}"
        )
    for name, layer in zip(mlp.layer_names, mlp.layers()):
        load_flax_dense(layer, params[name], name)
    for name in norms:
        _load_flax_layer_norm(getattr(mlp, name), params[name], name)


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
def load_flax_stacked_mlp(mlp: nn.Module, params: Mapping) -> None:
    """Copy a flax `MLP` under `vmap` (every leaf with a leading members
    axis, kernels (members, in, out)) into a `twin_critic.StackedMLP`, which
    keeps that layout."""
    if set(params) != set(mlp.layer_names):
        raise ValueError(f"flax MLP layers {sorted(params)} != port layers {mlp.layer_names}")
    for name, layer in zip(mlp.layer_names, mlp.layers()):
        for leaf in ("kernel", "bias"):
            value, target = _np(params[name][leaf]), getattr(layer, leaf)
            if value.shape != target.shape:
                raise ValueError(
                    f"{name}.{leaf}: flax {tuple(value.shape)} != port {tuple(target.shape)}"
                )
            target.copy_(value)


def load_flax_twin_critic_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load stacked `_PairQNet` params, `{"MLP_0": ...}` with a leading
    members axis on every leaf (a `TwinCritic`'s 2, an ensemble's K), into
    the port's `StackedPairQNet` (the same layout); returns `net`."""
    _check_keys(params, ("MLP_0",))
    load_flax_stacked_mlp(net.MLP_0, params["MLP_0"])
    return net


def load_flax_ensemble_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load an `EnsembleQValueNetwork`'s flax params, `{"train", "prior"}`,
    each the stacked `_PriorQNet` tree `{"MLP_0": ...}` with a leading K,
    into the port's dict of two `StackedPairQNet`s; returns `net`.
    `BootstrappedDQN` keeps the two apart: load its `state.params` (and
    `target_params`) from `params["train"]` and its `state.prior_params`
    from `params["prior"]` with `load_flax_twin_critic_params`."""
    _check_keys(params, ("train", "prior"))
    for name in ("train", "prior"):
        load_flax_twin_critic_params(net[name], params[name])
    return net


def load_flax_two_tower_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `TwoTowerQValueNetwork`'s flax params, `{"state_tower",
    "action_tower", "interaction"}`, into the port's `_TwoTowerNet`; returns
    `net`."""
    names = ("state_tower", "action_tower", "interaction")
    _check_keys(params, names)
    for name in names:
        load_flax_mlp(getattr(net, name), params[name])
    return net


def load_flax_mlp_with_prior_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load an `MLPWithPrior`'s flax params, `{"train", "prior"}`, each a
    bare `MLP` tree, into the port's dict of two `MLP`s; returns `net`."""
    _check_keys(params, ("train", "prior"))
    for name in ("train", "prior"):
        load_flax_mlp(net[name], params[name])
    return net


def load_flax_epinet_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load an `Epinet`'s flax params, `{"train": {"MLP_0": ...}, "prior":
    {"MLP_0": ...}}` (the prior stacked over index_dim nets), into the
    port's dict of two modules; returns `net`."""
    _check_keys(params, ("train", "prior"))
    _check_keys(params["train"], ("MLP_0",))
    _check_keys(params["prior"], ("MLP_0",))
    load_flax_mlp(net["train"].MLP_0, params["train"]["MLP_0"])
    load_flax_stacked_mlp(net["prior"].MLP_0, params["prior"]["MLP_0"])
    return net


@torch.no_grad()
def load_flax_conv_net(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax `ConvNet`'s params, `{"conv_i": {kernel, bias}}`, into a
    `neural_networks.common.ConvNet`; returns `net`. Flax conv kernels are
    HWIO and `nn.Conv2d` weights OIHW: each is transposed (3, 2, 0, 1). The
    two flatten their features in other orders ((H, W, C) against (C, H,
    W)): a layer after the stack takes `_hwc_rows_to_chw`'s permutation."""
    if set(params) != set(net.layer_names):
        raise ValueError(f"flax conv layers {sorted(params)} != port layers {net.layer_names}")
    for name, layer in zip(net.layer_names, net.layers()):
        kernel = _np(params[name]["kernel"])
        bias = _np(params[name]["bias"])
        weight = kernel.permute(3, 2, 0, 1)
        if weight.shape != layer.weight.shape or bias.shape != layer.bias.shape:
            raise ValueError(
                f"{name}: flax kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
                f"do not fit nn.Conv2d weight {tuple(layer.weight.shape)}"
            )
        layer.weight.copy_(weight)
        layer.bias.copy_(bias)
    return net


@torch.no_grad()
def load_flax_cnn_q_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a `CNNQValueNetwork`'s flax params,
    `{"conv": {"conv_i": {kernel, bias}}, "MLP_0": {...}}`, into the port's
    `_CNNQNet`; returns `net`: the conv stack through `load_flax_conv_net`,
    and the rows of the first MLP kernel permuted from the reference's
    (H, W, C) flatten of its NHWC features to the port's (C, H, W)."""
    if set(params) != {"conv", "MLP_0"}:
        raise ValueError(f"expected a {{'conv', 'MLP_0'}} param tree, got keys {sorted(params)}")
    load_flax_conv_net(net.conv, params["conv"])
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


_GATES = ("i", "f", "g", "o")  # flax's LSTMCell and torch's LSTM agree


@torch.no_grad()
def load_flax_lstm_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load an LSTM summarizer's flax params into the port's `LSTMNet`:
    `weight_ih_lk` is the four input kernels side by side, transposed;
    `weight_hh_lk` and `bias_hh_lk` the recurrent kernels and biases;
    `bias_ih_lk` stays zero. Returns `net`, its weights re-flattened for
    cuDNN."""
    _check_keys(params, [f"LSTMCell_{k}" for k in range(net.num_layers)])
    for k in range(net.num_layers):
        cell = params[f"LSTMCell_{k}"]
        _check_keys(cell, [p + g for p in "ih" for g in _GATES])
        pairs = (
            (net.weight_ih(k), torch.cat([_np(cell["i" + g]["kernel"]).T for g in _GATES])),
            (net.weight_hh(k), torch.cat([_np(cell["h" + g]["kernel"]).T for g in _GATES])),
            (net.bias_hh(k), torch.cat([_np(cell["h" + g]["bias"]) for g in _GATES])),
        )
        for target, value in pairs:
            if value.shape != target.shape:
                raise ValueError(
                    f"LSTMCell_{k}: flax {tuple(value.shape)} != port {tuple(target.shape)}"
                )
            target.copy_(value)
        net.bias_ih(k).zero_()
    net.lstm.flatten_parameters()
    return net


@torch.no_grad()
def _load_flax_layer_norm(ln: nn.Module, params: Mapping, name: str) -> None:
    _check_keys(params, ("scale", "bias"))
    for leaf in ("scale", "bias"):
        value = _np(params[leaf])
        if value.shape != getattr(ln, leaf).shape:
            raise ValueError(f"{name}.{leaf}: flax {tuple(value.shape)} does not fit")
        getattr(ln, leaf).copy_(value)


@torch.no_grad()
def load_flax_transformer_params(net: nn.Module, params: Mapping) -> nn.Module:
    """Load a transformer summarizer's flax params into the port's
    `TransformerNet`; returns `net`."""
    learned = hasattr(net, "pos_embedding")
    names = ["embed", "ln_f"] + (["pos_embedding"] if learned else [])
    for i in range(net.num_layers):
        names += [f"ln1_{i}", f"attn_{i}", f"ln2_{i}", f"mlp1_{i}", f"mlp2_{i}"]
    _check_keys(params, names)
    load_flax_dense(net.embed, params["embed"], "embed")
    if learned:
        net.pos_embedding.copy_(_np(params["pos_embedding"]))
    _load_flax_layer_norm(net.ln_f, params["ln_f"], "ln_f")
    for i in range(net.num_layers):
        for ln in (f"ln1_{i}", f"ln2_{i}"):
            _load_flax_layer_norm(getattr(net, ln), params[ln], ln)
        for mlp in (f"mlp1_{i}", f"mlp2_{i}"):
            load_flax_dense(getattr(net, mlp), params[mlp], mlp)
        attn, flax_attn = getattr(net, f"attn_{i}"), params[f"attn_{i}"]
        _check_keys(flax_attn, ("query", "key", "value", "out"))
        for proj in ("query", "key", "value", "out"):
            kernel = np.asarray(flax_attn[proj]["kernel"])
            d = kernel.shape[-1] if proj == "out" else kernel.shape[0]
            load_flax_dense(
                getattr(attn, proj),
                {"kernel": kernel.reshape(-1, d) if proj == "out" else kernel.reshape(d, -1),
                 "bias": np.asarray(flax_attn[proj]["bias"]).reshape(-1)},
                f"attn_{i}.{proj}",
            )
    return net


def load_flax_iql_state(state, params: Mapping):
    """Load an `ImplicitQLearning` state's weights, given as `{"actor_params",
    "critic_params", "critic_target_params", "value_params"}` numpy trees of
    the JAX learner's state (the value net's from `state.extra`), into the
    port's `ActorCriticState` in place: the Gaussian actor (`{"MLP_0", "mu",
    "log_std"}`) or a discrete one, the twin critic and its target, and the
    value net. Returns `state`."""
    _check_keys(params, ("actor_params", "critic_params", "critic_target_params", "value_params"))
    actor = params["actor_params"]
    if "mu" in actor:
        load_flax_gaussian_actor_params(state.actor_params, actor)
    else:
        load_flax_discrete_actor_params(state.actor_params, actor)
    load_flax_twin_critic_params(state.critic_params, params["critic_params"])
    load_flax_twin_critic_params(state.critic_target_params, params["critic_target_params"])
    load_flax_value_params(state.extra.value_params, params["value_params"])
    return state


def recommender_env_from_jax(jax_env, device) -> "RecommenderEnvironment":
    """The port's `RecommenderEnvironment` with a JAX env's catalog and user
    model: its `items`, `w1`, `b1` and `w2` (anything numpy reads) on
    `device`, and its scalar fields. The arrays play the part of weights:
    both packages then compute the same click probabilities."""
    from pearl_tpu_torch.envs.recsys import RecommenderEnvironment

    def tensor(name):
        return torch.as_tensor(np.array(getattr(jax_env, name), np.float32), device=device)

    return RecommenderEnvironment(
        items=tensor("items"), w1=tensor("w1"), b1=tensor("b1"), w2=tensor("w2"),
        slate_size=int(jax_env.slate_size), episode_length=int(jax_env.episode_length),
        history_length=int(jax_env.history_length), logit_scale=float(jax_env.logit_scale),
    )


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def load_flax_linreg_state(params, device=None) -> "LinearRegressionState":
    """The port's `LinearRegressionState` from a JAX one (a struct or a
    mapping with A, b, sum_weight and weight_since_discount; leading arm
    axes kept), on `device`, in the port's float64."""
    from pearl_tpu_torch.neural_networks.contextual_bandit import (
        STATS_DTYPE,
        LinearRegressionState,
    )

    return LinearRegressionState(**{
        name: _np(_field(params, name)).to(device, STATS_DTYPE)
        for name in ("A", "b", "sum_weight", "weight_since_discount")
    })


def load_flax_neural_linear_state(state, params: Mapping):
    """Load a `NeuralLinearBandit` state's weights and statistics, given as
    `{"mlp", "head", "linreg"}` (the JAX state's `mlp_params`,
    `head_params` and `linreg`), into the port's state: the MLP and head in
    place, the statistics replaced. Returns the state."""
    import dataclasses

    _check_keys(params, ("mlp", "head", "linreg"))
    load_flax_mlp(state.mlp_params, params["mlp"])
    load_flax_mlp(state.head_params, params["head"])
    linreg = load_flax_linreg_state(params["linreg"], state.linreg.A.device)
    return dataclasses.replace(state, linreg=linreg)


def load_flax_disjoint_models(learner, state, models):
    """Load a `DisjointBanditContainer`'s stacked arm states from the JAX
    container's `state.models`: a linear stack's statistics (leading arm
    axis), a neural stack's `{"params": <MLP tree with a leading arm axis>,
    ...}` into its `StackedMLP` (`load_flax_stacked_mlp`; the optimizer
    stays fresh); with heterogeneous arms a tuple, one entry a group, in the
    container's group order. Returns the state."""
    import dataclasses

    from pearl_tpu_torch.policy_learners.contextual_bandits import NeuralBandit

    def load_group(arm_learner, ours, theirs):
        if isinstance(arm_learner, NeuralBandit):
            load_flax_stacked_mlp(ours.params, theirs["params"])
            return ours
        return load_flax_linreg_state(theirs, ours.A.device)

    if learner._heterogeneous:
        groups = [arm_learner for arm_learner, _ in learner._groups()]
        loaded = tuple(load_group(g, ours, theirs)
                       for g, ours, theirs in zip(groups, state.models, models))
    else:
        loaded = load_group(learner.arm_learner, state.models, models)
    return dataclasses.replace(state, models=loaded)
