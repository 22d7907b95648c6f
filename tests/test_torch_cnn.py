"""`CNNQValueNetwork` of the PyTorch port (pearl_tpu_torch/neural_networks)
against the JAX network (pearl_tpu/neural_networks/q_value_networks.py) on
weights carried across by `load_flax_cnn_q_params`: the flat `q_all` in its
layouts, `_q_all_ring` on a `FrameRingView` at every cursor, the bfloat16 act
path, and the gradients of the flat path. Small frames (20 x 20: conv1 gives
4 x 4, conv2 1 x 1; 24 x 20 where the flatten order must show).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.history_summarization_modules.frame_ring import FrameRingView as JaxView
from pearl_tpu.neural_networks.q_value_networks import CNNQValueNetwork as JaxCNN
from pearl_tpu_torch.history_summarization_modules import FrameRingView
from pearl_tpu_torch.neural_networks import CNNQValueNetwork, ConvNet
from pearl_tpu_torch.utils.jax_params import load_flax_cnn_q_params

torch.set_num_threads(1)

# float32 convolutions and matrix products summed in other orders.
TOL = dict(rtol=1e-5, atol=1e-5)
A = 5  # actions


def _nets(input_shape, seed=0, **kw):
    """(jax net, its params with non-zero biases, the port's net, its
    module carrying the same weights)."""
    jnet = JaxCNN(input_shape=input_shape, hidden_dims=(24,), **kw)
    tnet = CNNQValueNetwork(input_shape=input_shape, hidden_dims=(24,), **kw)
    params = jnet.init(jax.random.PRNGKey(seed), 0, 0, A)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: x if x.ndim > 1 else jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32)),
        params,
    )
    module = tnet.init(torch.Generator().manual_seed(seed), 0, 0, A)
    load_flax_cnn_q_params(module, jax.tree.map(np.asarray, params))
    return jnet, params, tnet, module


def _actions(B):
    return jnp.zeros((B, A, A)), torch.zeros((B, A, A))


@pytest.mark.parametrize(
    "input_shape,kw",
    [
        ((20, 20, 4), dict(time_major_stack=True)),
        ((24, 20, 4), dict(time_major_stack=True)),  # not square: conv1 gives 5 x 4
        ((20, 20, 6), dict(time_major_stack=True, frame_channels=2)),
        ((20, 20, 3), dict()),
        ((28, 24, 4), dict(time_major_stack=True)),  # conv2 leaves 2 x 1: the flatten order shows
    ],
)
def test_flat_q_all_matches_jax(input_shape, kw):
    jnet, params, tnet, module = _nets(input_shape, **kw)
    B = 6
    state = np.random.default_rng(1).uniform(0, 255, (B, int(np.prod(input_shape)))).astype(np.float32)
    ja, ta = _actions(B)
    want = np.asarray(jnet.q_all(params, jnp.asarray(state), ja))
    with torch.no_grad():
        got = tnet.q_all(module, torch.from_numpy(state), ta)
    assert got.shape == (B, A)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _views(ring, valid, cursor, jdtype=jnp.float32, tdtype=torch.float32):
    jview = JaxView(
        ring=jnp.asarray(ring).astype(jdtype), valid=jnp.asarray(valid),
        cursor=jnp.asarray(cursor, jnp.int32),
    )
    tview = FrameRingView(
        ring=torch.from_numpy(ring).to(tdtype), valid=torch.from_numpy(valid), cursor=cursor
    )
    return jview, tview


@pytest.mark.parametrize("input_shape,fc", [((20, 20, 4), 1), ((28, 24, 3), 1), ((20, 20, 6), 2)])
def test_q_all_ring_matches_jax_at_every_cursor(input_shape, fc):
    H, W, C = input_shape
    T = C // fc
    jnet, params, tnet, module = _nets(input_shape, time_major_stack=True, frame_channels=fc)
    B = 5
    rng = np.random.default_rng(2)
    ring = rng.uniform(0, 255, (B, T, H * W * fc)).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    ja, ta = _actions(B)
    for cursor in range(T):
        jview, tview = _views(ring, valid, cursor)
        want = np.asarray(jnet.q_all(params, jview, ja))
        with torch.no_grad():
            got = tnet.q_all(module, tview, ta)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # The ring path equals the flat path on the materialised window.
        with torch.no_grad():
            flat = tnet.q_all(module, tview.materialize(), ta)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), **TOL)


def test_q_all_ring_bfloat16_act_path_matches_jax():
    # The act path under act_dtype="bfloat16": a bfloat16 ring and weights
    # cast to bfloat16. Both packages round every conv and layer output to
    # bfloat16 (2^-8 relative) but sum and round inside each op differently;
    # over four layers with |Q| below 1 that stays within 3e-2.
    input_shape = (20, 20, 4)
    jnet, params, tnet, module = _nets(input_shape, time_major_stack=True)
    B, T = 6, 4
    rng = np.random.default_rng(3)
    ring = rng.uniform(0, 255, (B, T, 400)).astype(np.float32)
    valid = rng.random((B, T)) < 0.8
    ja, ta = _actions(B)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    tmodule = module.to(torch.bfloat16)
    for cursor in (0, 3):
        jview, tview = _views(ring, valid, cursor, jnp.bfloat16, torch.bfloat16)
        want = np.asarray(jnet.q_all(jparams, jview, ja.astype(jnp.bfloat16)).astype(jnp.float32))
        with torch.no_grad():
            got = tnet.q_all(tmodule, tview, ta.to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert np.abs(want).max() < 1.0
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=3e-2)


def test_q_all_ring_of_a_bfloat16_ring_under_float32_weights():
    # No act_dtype: conv weights are cast to the ring's dtype, the MLP runs in
    # the promoted dtype (float32), as flax promotes.
    jnet, params, tnet, module = _nets((20, 20, 4), time_major_stack=True)
    rng = np.random.default_rng(4)
    ring = rng.uniform(0, 255, (4, 4, 400)).astype(np.float32)
    valid = np.ones((4, 4), bool)
    ja, ta = _actions(4)
    jview, tview = _views(ring, valid, 1, jnp.bfloat16, torch.bfloat16)
    want = jnet.q_all(params, jview, ja)
    with torch.no_grad():
        got = tnet.q_all(module, tview, ta)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-2)


def _flax_grads_as_torch(grads, module):
    """Flax gradient tree -> {port parameter name: numpy array}."""
    C, H, W = module.feature_shape
    out = {}
    for name in module.conv.layer_names:
        out[f"conv.{name}.weight"] = np.asarray(grads["conv"][name]["kernel"]).transpose(3, 2, 0, 1)
        out[f"conv.{name}.bias"] = np.asarray(grads["conv"][name]["bias"])
    for i, name in enumerate(module.MLP_0.layer_names):
        kernel = np.asarray(grads["MLP_0"][name]["kernel"])
        if i == 0:
            kernel = kernel.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(H * W * C, -1)
        out[f"MLP_0.{name}.weight"] = kernel.T
        out[f"MLP_0.{name}.bias"] = np.asarray(grads["MLP_0"][name]["bias"])
    return out


@pytest.mark.parametrize("ring_path", [False, True])
def test_gradients_match_jax(ring_path):
    input_shape = (28, 24, 4)
    jnet, params, tnet, module = _nets(input_shape, time_major_stack=True)
    B = 4
    rng = np.random.default_rng(5)
    state = rng.uniform(0, 255, (B, 28 * 24 * 4)).astype(np.float32)
    ja, ta = _actions(B)

    def jinput():
        if not ring_path:
            return jnp.asarray(state)
        return JaxView(
            ring=jnp.asarray(state).reshape(B, 4, -1), valid=jnp.ones((B, 4), bool),
            cursor=jnp.zeros((), jnp.int32), from_replay=True,
        )

    grads = jax.grad(lambda p: jnp.sum(jnet.q_all(p, jinput(), ja) ** 2))(params)
    tinput = torch.from_numpy(state)
    if ring_path:
        tinput = FrameRingView(
            ring=tinput.reshape(B, 4, -1), valid=torch.ones((B, 4), dtype=torch.bool), cursor=0,
            from_replay=True,
        )
    (tnet.q_all(module, tinput, ta) ** 2).sum().backward()
    want = _flax_grads_as_torch(grads, module)
    named = dict(module.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        # Gradients of sum(Q^2) scale with Q's own differences: 1e-4.
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4, atol=1e-5, err_msg=name)


def test_options_and_errors():
    # The conv1 cache needs single-channel frames and an unpadded conv1; off a
    # time-major stack the option is inert, as in the reference.
    assert not CNNQValueNetwork(conv1_cache=True).cache_enabled
    assert CNNQValueNetwork(time_major_stack=True, conv1_cache=True).cache_enabled
    with pytest.raises(ValueError, match="conv1_cache requires"):
        CNNQValueNetwork(
            input_shape=(20, 20, 16), time_major_stack=True, frame_channels=4, conv1_cache=True
        )
    with pytest.raises(ValueError, match="conv1_cache requires"):
        CNNQValueNetwork(time_major_stack=True, conv1_cache=True, paddings=(2, 0))
    assert CNNQValueNetwork(time_major_stack=True).supports_frame_ring
    assert not CNNQValueNetwork().supports_frame_ring
    net = CNNQValueNetwork(input_shape=(20, 20, 4))
    module = net.init(torch.Generator().manual_seed(0), 0, 0, A)
    view = FrameRingView(torch.zeros((2, 4, 400)), torch.ones((2, 4), dtype=torch.bool), 0)
    with pytest.raises(ValueError, match="time_major_stack=True"):
        net.q_all(module, view, None)
    with pytest.raises(ValueError, match="param tree"):
        load_flax_cnn_q_params(module, {"MLP_0": {}})


def test_init_is_seeded_and_shaped_like_the_reference():
    jnet, params, tnet, _ = _nets((84, 84, 4), time_major_stack=True)
    module = tnet.init(torch.Generator().manual_seed(7), 0, 0, A)
    again = tnet.init(torch.Generator().manual_seed(7), 0, 0, A)
    for a, b in zip(module.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert module.feature_shape == (32, 9, 9)
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in module.parameters()) == n_params
    # lecun-normal conv weights (std 1/sqrt(fan_in), cut at 2 sigma), zero biases.
    w = module.conv.conv_1.weight
    assert abs(w.std().item() * (16 * 4 * 4) ** 0.5 - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / (16 * 4 * 4) ** 0.5 + 1e-6
    assert all((layer.bias == 0).all() for layer in module.conv.layers())
    assert isinstance(module.conv, ConvNet)
