"""The network helpers' last options on the port
(`pearl_tpu/neural_networks/common.py:75-137`, `epistemic.py:63`):
`ConvNet(activation=..., normalize=...)` against flax's `ConvNet` at
(2, 84, 84, 4) with the weights carried by `load_flax_conv_net`, the
public `normalized_softplus`, `Epinet(num_prior_nets=...)`, and the frame
kernels' paths, which compute only the default stack, raising on any
other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.neural_networks.common import ConvNet as JaxConvNet
from pearl_tpu.neural_networks.common import normalized_softplus as jax_normalized_softplus
from pearl_tpu.neural_networks.epistemic import Epinet as JaxEpinet
from pearl_tpu_torch.history_summarization_modules import FrameRingView
from pearl_tpu_torch.neural_networks import ACTIVATIONS, CNNQValueNetwork, ConvNet, Epinet
from pearl_tpu_torch.neural_networks.common import normalized_softplus
from pearl_tpu_torch.utils.jax_params import load_flax_conv_net

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (2, 84, 84, 4)  # NHWC, the Atari stack


def _carried(activation, normalize, seed=0):
    """(flax net, its params with non-zero biases, the port's net with the
    same weights)."""
    kw = dict(activation=activation, normalize=normalize)
    jnet = JaxConvNet(**kw)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros(SHAPE))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: x if x.ndim > 1 else jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32)),
        params,
    )
    net = ConvNet(SHAPE[-1], **kw)
    load_flax_conv_net(net, jax.tree.map(np.asarray, params))
    return jnet, params, net


def _inputs(normalize, seed=1):
    rng = np.random.default_rng(seed)
    if normalize:
        return rng.integers(0, 256, SHAPE).astype(np.float32)  # pixels
    return rng.standard_normal(SHAPE).astype(np.float32)


@pytest.mark.parametrize(
    "activation,normalize",
    [("relu", True), ("tanh", True), ("normalized_softplus", True), ("relu", False)],
)
def test_conv_net_matches_flax(activation, normalize):
    jnet, params, net = _carried(activation, normalize)
    x = _inputs(normalize)
    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))  # NHWC -> NCHW
    # The port flattens (C, H, W), flax (H, W, C): bring the port's to flax's.
    C, H, W = 32, 9, 9
    out = out.reshape(SHAPE[0], C, H, W).permute(0, 2, 3, 1).reshape(SHAPE[0], -1)
    assert out.shape == ref.shape == (SHAPE[0], C * H * W)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_conv_net_takes_a_callable_activation_and_keeps_the_default_stack():
    net = ConvNet(4, activation=normalized_softplus, generator=torch.Generator().manual_seed(0))
    by_name = ConvNet(4, activation="normalized_softplus",
                      generator=torch.Generator().manual_seed(0))
    x = torch.rand((2, 4, 84, 84)) * 255
    assert torch.equal(net(x), by_name(x))
    plain = ConvNet(4, generator=torch.Generator().manual_seed(0))
    assert plain.activation == "relu" and plain.normalize
    plain.check_plain_relu_stack()
    with pytest.raises(ValueError, match="param tree|conv layers"):
        load_flax_conv_net(plain, {"conv_0": {}})


def test_normalized_softplus_is_public_and_matches_jax():
    x = np.linspace(-30.0, 30.0, 601, dtype=np.float32)
    ours = normalized_softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_normalized_softplus(jnp.asarray(x))), **TOL)
    assert ACTIVATIONS["normalized_softplus"] is normalized_softplus
    assert normalized_softplus(torch.zeros(())).item() == pytest.approx(1.0, abs=1e-7)


def test_epinet_accepts_num_prior_nets_and_does_not_read_it():
    assert [f.name for f in dataclasses.fields(Epinet)] == [
        f.name for f in dataclasses.fields(JaxEpinet)]
    assert Epinet().num_prior_nets == JaxEpinet().num_prior_nets == 8
    feats = torch.randn((5, 6), generator=torch.Generator().manual_seed(1))
    z = torch.randn((8,), generator=torch.Generator().manual_seed(2))
    outs = []
    for net in (Epinet(num_prior_nets=3), Epinet()):
        params = net.init(torch.Generator().manual_seed(0), 6)
        with torch.no_grad():
            outs.append(net.apply(params, feats, z))
    assert outs[0].shape == (5, 1)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("conv", [dict(normalize=False), dict(activation="tanh")])
def test_frame_kernel_paths_raise_on_a_conv_net_they_do_not_compute(conv):
    """A ring-aware CNN whose conv stack is not the default one: the fence
    path, the ring conv and the conv1 cache fold the / 255 and relu into
    conv1 and raise; the flat path runs the stack as it is."""
    T, H, W, A, B = 4, 20, 20, 3, 2
    shape = dict(input_shape=(H, W, T), time_major_stack=True, hidden_dims=(8,))
    ring = torch.randint(0, 256, (B, T, H * W)).to(torch.float32)
    view = FrameRingView(ring, torch.ones((B, T), dtype=torch.bool), 1)
    actions = torch.zeros((B, A, A))
    for net in (CNNQValueNetwork(**shape), CNNQValueNetwork(ring_conv=True, **shape),
                CNNQValueNetwork(conv1_cache=True, **shape)):
        module = net.init(torch.Generator().manual_seed(0), 0, 0, A)
        if net.cache_enabled:  # the live carry with its cache: the cached act path
            view = dataclasses.replace(view, cache=net.refresh_cache(module, view))
        net.q_all(module, view, actions)  # the default stack takes every path
        module.conv = ConvNet(T, kernel_sizes=(8, 4), strides=(4, 2), **conv)
        with pytest.raises(ValueError, match="fold the / 255 and relu"):
            net.q_all(module, view, actions)
        if net.cache_enabled:
            with pytest.raises(ValueError, match="fold the / 255 and relu"):
                net.refresh_cache(module, view)
            with pytest.raises(ValueError, match="fold the / 255 and relu"):
                net.cache_contrib_y(module, ring[:, 0])
        with torch.no_grad():  # a flat time-major window: (T, H, W) per row
            q = net.q_all(module, ring.reshape(B, -1), actions)
            assert torch.equal(q, module.MLP_0(module.conv(ring.reshape(B, T, H, W))))
