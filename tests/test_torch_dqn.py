"""The DQN learn step of the PyTorch port against the JAX package's
(`DeepQLearning.learn_batch`, `DoubleDQN`, the CQL flag): on fixed batches,
with the JAX init weights carried across, the gradients, the optimized
loss, the reported mean |TD|, three AdamW steps and the soft target update
agree. The target network must be a copy, never an alias of the online one.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.neural_networks.common import select_index_last as jax_select
from pearl_tpu.neural_networks.q_value_networks import (
    MultiHeadQValueNetwork as JaxMultiHead,
    VanillaQValueNetwork as JaxVanilla,
)
from pearl_tpu.policy_learners.sequential_decision_making import (
    DeepQLearning as JaxDQN,
    DoubleDQN as JaxDoubleDQN,
)
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork, VanillaQValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    DeepQLearning,
    DoubleDQN,
)
from pearl_tpu_torch.replay_buffers import TransitionBatch
from pearl_tpu_torch.utils.jax_params import load_flax_q_params

torch.set_num_threads(1)

# float32 throughout; XLA and PyTorch sum in other orders, and Adam's
# m / sqrt(v) passes those differences on: rtol 1e-5, atol 1e-6 for values
# near zero.
TOL = dict(rtol=1e-5, atol=1e-6)

CONFIGS = {
    "dqn_multihead": (JaxDQN, DeepQLearning, JaxMultiHead, MultiHeadQValueNetwork, {}),
    "dqn_vanilla": (JaxDQN, DeepQLearning, JaxVanilla, VanillaQValueNetwork, {}),
    "double_multihead": (JaxDoubleDQN, DoubleDQN, JaxMultiHead, MultiHeadQValueNetwork, {}),
    "cql_multihead": (
        JaxDQN, DeepQLearning, JaxMultiHead, MultiHeadQValueNetwork,
        {"is_conservative": True},
    ),
    # The learners of the Double DQN and online CQL anchors
    # (test_convergence.py:82-83, 112-121): the default Q-network, alpha 1.
    "double_vanilla": (JaxDoubleDQN, DoubleDQN, JaxVanilla, VanillaQValueNetwork, {}),
    "cql_vanilla_alpha_1": (
        JaxDQN, DeepQLearning, JaxVanilla, VanillaQValueNetwork,
        {"is_conservative": True, "conservative_alpha": 1.0},
    ),
    # The default Q-network with layer norm in its hidden layers.
    "cql_vanilla_layer_norm": (
        JaxDQN, DeepQLearning, functools.partial(JaxVanilla, use_layer_norm=True),
        functools.partial(VanillaQValueNetwork, use_layer_norm=True),
        {"is_conservative": True},
    ),
}


# Layer norm turns the params' float32 differences after an AdamW step
# (each within TOL, as the test holds) into gradient differences of a few
# 1e-6 at the next step. In these cases the gradient is held at JAX's own
# params, carried into a copy of the port's state, and the trajectory by
# the params, loss and |TD| after every step; the |TD| of rows near zero
# moves by up to 1.6e-6 (measured), so its atol is 4e-6 there.
GRADS_AT_JAX_PARAMS = {"cql_vanilla_layer_norm"}
TD_TOL = {"cql_vanilla_layer_norm": dict(rtol=1e-5, atol=4e-6)}


def _flax_layout(module):
    """The port's Q-network weights as a flax-shaped tree of numpy arrays
    (its dense layers and, with layer norm, its `ln_{i}`)."""
    mlp = module.MLP_0
    tree = {
        name: {"kernel": layer.weight.detach().numpy().T, "bias": layer.bias.detach().numpy()}
        for name, layer in zip(mlp.layer_names, mlp.layers())
    }
    for name in mlp.norm_names:
        ln = getattr(mlp, name)
        tree[name] = {"scale": ln.scale.detach().numpy(), "bias": ln.bias.detach().numpy()}
    return {"MLP_0": tree}


def _port_leaf(layer, leaf):
    """The port's parameter name of a flax leaf of `MLP_0`."""
    return f"MLP_0.{layer}.{ {'kernel': 'weight'}.get(leaf, leaf) }"


def _assert_tree_close(ours, ref):
    ref = jax.tree.map(np.asarray, ref)
    assert set(ours["MLP_0"]) == set(ref["MLP_0"])
    for layer, leaves in ref["MLP_0"].items():
        for leaf in leaves:
            np.testing.assert_allclose(
                ours["MLP_0"][layer][leaf], ref["MLP_0"][layer][leaf], **TOL
            )


def _batch_data(B, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2, B).astype(np.int32)
    return dict(
        state=rng.standard_normal((B, 4)).astype(np.float32) * 0.5,
        action=idx[:, None].astype(np.float32),
        reward=rng.standard_normal(B).astype(np.float32),
        next_state=rng.standard_normal((B, 4)).astype(np.float32) * 0.5,
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.05,
        action_index=idx,
    )


def _learners(name, **overrides):
    jax_cls, cls, jax_net, net, extra = CONFIGS[name]
    kw = {"training_rounds": 1, "batch_size": 64, "target_update_freq": 2, **extra, **overrides}
    jl = jax_cls(q_network=jax_net(), **kw).bind(JaxCartPole().action_space)
    tl = cls(q_network=net(), **kw).bind(CartPole().action_space)
    jstate = jl.init(jax.random.PRNGKey(0), 4, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), 4, tl.action_space, 1, torch.device("cpu"))
    weights = jax.tree.map(np.asarray, jstate.params)
    load_flax_q_params(tstate.params, weights)
    load_flax_q_params(tstate.target_params, weights)
    return jl, jstate, tl, tstate


def _jax_loss(jl, jstate, jbatch):
    """The JAX learner's loss (deep_td.py:167-198) through its own pieces."""

    def loss_fn(params):
        B = jbatch.state.shape[0]
        cands = jl.represented_candidates(B)
        q_all = jl.q_network.q_all(params, jbatch.state, cands, None)
        q_sa = jax_select(q_all, jbatch.action_index)
        next_v = jax.lax.stop_gradient(
            jl._next_state_values(params, jstate.target_params, {}, jbatch)
        )
        target = jbatch.reward + jl.discount_factor * (
            1.0 - jbatch.terminated.astype(jnp.float32)
        ) * next_v
        td = q_sa - target
        loss = jnp.mean(td**2)
        if jl.is_conservative:
            cql = jnp.mean(jax.scipy.special.logsumexp(q_all, axis=-1) - q_sa)
            loss = loss + jl.conservative_alpha * cql
        return loss

    return jax.value_and_grad(loss_fn)(jstate.params)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_learn_batch_matches_jax_over_three_adamw_steps(name):
    jl, jstate, tl, tstate = _learners(name)
    for step in range(3):
        data = _batch_data(64, seed=step)
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
        tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})

        jloss, jgrads = _jax_loss(jl, jstate, jbatch)
        probe = tstate
        if name in GRADS_AT_JAX_PARAMS:
            probe = copy.deepcopy(tstate)
            load_flax_q_params(probe.params, jax.tree.map(np.asarray, jstate.params))
            load_flax_q_params(probe.target_params, jax.tree.map(np.asarray, jstate.target_params))
        tloss, _ = tl.td_loss(probe, tbatch)
        grads = torch.autograd.grad(tloss, list(probe.params.parameters()))
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        named = dict(zip([n for n, _ in probe.params.named_parameters()], grads))
        for layer, leaves in jgrads["MLP_0"].items():
            for leaf, g in leaves.items():
                ours = named[_port_leaf(layer, leaf)].numpy()
                np.testing.assert_allclose(ours.T if leaf == "kernel" else ours, np.asarray(g),
                                           **TOL)

        jstate, jaux = jl.learn_batch(jstate, jbatch)
        tstate, taux = tl.learn_batch(tstate, tbatch)
        assert tstate.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), **TOL)
        np.testing.assert_allclose(
            taux["per_sample_td"].numpy(), np.asarray(jaux["per_sample_td"]),
            **TD_TOL.get(name, TOL),
        )
        _assert_tree_close(_flax_layout(tstate.params), jstate.params)
        _assert_tree_close(_flax_layout(tstate.target_params), jstate.target_params)


def test_target_is_a_copy_and_soft_updates_on_the_post_increment_step():
    jl, jstate, tl, tstate = _learners("dqn_multihead", target_update_freq=3)
    online = list(tstate.params.parameters())
    target = list(tstate.target_params.parameters())
    assert all(o.data_ptr() != t.data_ptr() for o, t in zip(online, target))
    assert not any(t.requires_grad for t in target)
    start = [t.detach().clone() for t in target]
    for step in range(3):
        data = _batch_data(64, seed=10 + step)
        jstate, _ = jl.learn_batch(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}))
        tstate, _ = tl.learn_batch(tstate, TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}))
        moved = [not torch.equal(s, t) for s, t in zip(start, tstate.target_params.parameters())]
        # Steps 1 and 2 leave the target alone although the online net moved
        # in place; step 3 (3 % 3 == 0) soft-updates it with tau = 0.75.
        assert any(moved) == (step == 2)
        _assert_tree_close(_flax_layout(tstate.target_params), jstate.target_params)
    for s, t, o in zip(start, tstate.target_params.parameters(), tstate.params.parameters()):
        torch.testing.assert_close(t, s + 0.75 * (o.detach() - s), **TOL)


def test_adamw_hyperparameters_are_the_references():
    _, _, tl, tstate = _learners("dqn_multihead")
    group = tstate.optimizer.param_groups[0]
    assert isinstance(tstate.optimizer, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 0.01,
    )
    assert isinstance(DeepQLearning().q_network, VanillaQValueNetwork)  # the default
