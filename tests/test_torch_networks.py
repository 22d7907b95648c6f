"""Q-networks of the PyTorch port against the JAX package's: flax params
carried across with `pearl_tpu_torch.utils.jax_params` give the same `q_all`
for `MultiHeadQValueNetwork` and `VanillaQValueNetwork`, and the MLP's
init and `select_index_last` follow the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.neural_networks.common import select_index_last as jax_select
from pearl_tpu.neural_networks.q_value_networks import (
    MultiHeadQValueNetwork as JaxMultiHead,
    VanillaQValueNetwork as JaxVanilla,
)
from pearl_tpu_torch.neural_networks import (
    MLP,
    MultiHeadQValueNetwork,
    VanillaQValueNetwork,
    select_index_last,
)
from pearl_tpu_torch.utils.jax_params import load_flax_q_params

torch.set_num_threads(1)

# float32 matmuls by XLA and by PyTorch on the CPU: the same products summed
# in another order; atol covers Q-values near zero.
Q_TOL = dict(rtol=1e-6, atol=1e-6)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _inputs(B=33, state_dim=4, num_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((B, state_dim)).astype(np.float32)
    cand = np.eye(num_actions, dtype=np.float32)  # one-hot candidates
    actions = np.broadcast_to(cand, (B, num_actions, num_actions)).copy()
    return state, actions


@pytest.mark.parametrize(
    "jax_net,net,hidden",
    [
        (JaxMultiHead, MultiHeadQValueNetwork, (64, 64)),
        (JaxMultiHead, MultiHeadQValueNetwork, (32, 16, 8)),
        (JaxVanilla, VanillaQValueNetwork, (64, 64)),
    ],
)
def test_q_all_with_carried_weights_matches_jax(jax_net, net, hidden):
    state, actions = _inputs()
    jnet = jax_net(hidden_dims=hidden)
    params = jnet.init(jax.random.PRNGKey(3), 4, 3, 3)
    ref = np.asarray(jnet.q_all(params, jnp.asarray(state), jnp.asarray(actions)))

    tnet = net(hidden_dims=hidden)
    module = tnet.init(torch.Generator().manual_seed(0), 4, 3, 3)
    load_flax_q_params(module, _np_tree(params))
    with torch.no_grad():
        q = tnet.q_all(module, torch.from_numpy(state), torch.from_numpy(actions)).numpy()
    assert q.shape == ref.shape == (33, 3)
    np.testing.assert_allclose(q, ref, **Q_TOL)


def test_weight_carry_transposes_kernels_and_checks_the_tree():
    params = JaxMultiHead().init(jax.random.PRNGKey(0), 4, 2, 2)
    module = MultiHeadQValueNetwork().init(torch.Generator().manual_seed(0), 4, 2, 2)
    load_flax_q_params(module, _np_tree(params))
    for name, layer in zip(module.MLP_0.layer_names, module.MLP_0.layers()):
        kernel = np.asarray(params["MLP_0"][name]["kernel"])
        np.testing.assert_array_equal(layer.weight.detach().numpy(), kernel.T)
        np.testing.assert_array_equal(
            layer.bias.detach().numpy(), np.asarray(params["MLP_0"][name]["bias"])
        )
    with pytest.raises(ValueError):  # layer-name mismatch
        load_flax_q_params(module, {"MLP_0": {"dense_0": params["MLP_0"]["dense_0"]}})
    wrong = MultiHeadQValueNetwork(hidden_dims=(32, 32)).init(None, 4, 2, 2)
    with pytest.raises(ValueError):  # shape mismatch
        load_flax_q_params(wrong, _np_tree(params))
    with pytest.raises(ValueError):  # not a Q-network tree
        load_flax_q_params(module, {"params": {}})


def test_mlp_init_is_xavier_uniform_with_zero_bias():
    global_rng = torch.get_rng_state()
    mlp = MLP(4, (64, 64), 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), global_rng)  # draws only from `generator`
    assert mlp.layer_names == ["dense_0", "dense_1", "dense_out"]
    for layer in mlp.layers():
        d_out, d_in = layer.weight.shape
        bound = np.sqrt(6.0 / (d_in + d_out))
        assert layer.weight.abs().max() <= bound
        assert layer.weight.abs().max() > 0.8 * bound  # spans the range
        assert (layer.bias == 0).all()
    again = MLP(4, (64, 64), 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(mlp.dense_0.weight, again.dense_0.weight, rtol=0, atol=0)


def test_select_index_last_matches_jax():
    rng = np.random.default_rng(4)
    values = rng.standard_normal((50, 5)).astype(np.float32)
    index = rng.integers(0, 5, 50).astype(np.int32)
    ours = select_index_last(torch.from_numpy(values), torch.from_numpy(index)).numpy()
    ref = np.asarray(jax_select(jnp.asarray(values), jnp.asarray(index)))
    np.testing.assert_array_equal(ours, ref)  # x*1 + 0*y is exact
    np.testing.assert_array_equal(ours, values[np.arange(50), index])
