"""Bootstrapped DQN and the networks of the DQN family's second half in the
PyTorch port against the JAX package: the ensemble Q-network (forwards,
members and gradients, none through the prior), the two-tower Q-network,
`MLPWithPrior` and `Epinet` (gradients to the parameters and to the
features), deep exploration on given member indices and JAX's redraw,
`BootstrappedDQN`'s acting and three `learn_batch` steps against optax with
the prior untouched, tabular Q-learning with repeated (state, action) pairs
and on JAX's tie-break noise, the host dict learner, and the agent's runner
with a bootstrap buffer at a tiny size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.neural_networks.epistemic import Epinet as JaxEpinet
from pearl_tpu.neural_networks.epistemic import MLPWithPrior as JaxMLPWithPrior
from pearl_tpu.neural_networks.q_value_networks import (
    EnsembleQValueNetwork as JaxEnsemble,
    TwoTowerQValueNetwork as JaxTwoTower,
)
from pearl_tpu.policy_learners.exploration_modules import NoExploration as JaxNoExploration
from pearl_tpu.policy_learners.exploration_modules.deep_exploration import (
    DeepExploration as JaxDeepExploration,
    DeepExplorationState as JaxDeepExplorationState,
)
from pearl_tpu.policy_learners.sequential_decision_making.bootstrapped_dqn import (
    BootstrappedDQN as JaxBootstrappedDQN,
)
from pearl_tpu.policy_learners.sequential_decision_making.tabular_q import (
    DictTabularQLearning as JaxDictTabular,
    TabularQLearning as JaxTabular,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole, VectorEnv
from pearl_tpu_torch.neural_networks import (
    EnsembleQValueNetwork,
    Epinet,
    MLPWithPrior,
    TwoTowerQValueNetwork,
)
from pearl_tpu_torch.policy_learners.exploration_modules import (
    DeepExploration,
    DeepExplorationState,
    NoExploration,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    BootstrappedDQN,
    DictTabularQLearning,
    TabularQLearning,
)
from pearl_tpu_torch.replay_buffers import (
    BasicReplayBuffer,
    BootstrapReplayBuffer,
    TransitionBatch,
)
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import (
    load_flax_ensemble_q_params,
    load_flax_epinet_params,
    load_flax_mlp_with_prior_params,
    load_flax_twin_critic_params,
    load_flax_two_tower_q_params,
)

from test_torch_dqn_family import (
    STEP_TOL,
    TOL,
    _batch_data,
    _jax_loss_and_grads,
    _module_tree,
    _net_inputs,
    _np_tree,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 4


def _init(module, key, *dims):
    """`module.init(key, *dims)`, jitted: eager flax init dispatches op by op."""
    return jax.jit(lambda k: module.init(k, *dims))(key)


def _value_and_grad(objective, *args, argnums=0):
    return jax.jit(jax.value_and_grad(objective, argnums=argnums, has_aux=True))(*args)


def _flat(tree, prefix=()):
    """A nested dict of arrays as {path: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _stacked_tree(net, grad=False):
    """A `StackedPairQNet` as the flax tree {"MLP_0": {layer: {kernel, bias}}}."""
    mlp = net.MLP_0
    return {"MLP_0": {
        name: {leaf: (getattr(layer, leaf).grad if grad else getattr(layer, leaf)).detach()
               .numpy() for leaf in ("kernel", "bias")}
        for name, layer in zip(mlp.layer_names, mlp.layers())
    }}


def _assert_flat_close(ours, ref, tol=TOL):
    ours, ref = _flat(ours), _flat(_np_tree(ref))
    assert ours.keys() == ref.keys()
    for path in ref:
        np.testing.assert_allclose(ours[path], ref[path], err_msg=str(path), **tol)


# ---------------------------------------------------------------- networks


def _ensemble_pair(state_dim=4, A=3):
    jnet = JaxEnsemble(hidden_dims=(16, 12), ensemble_size=K, prior_scale=0.5)
    net = EnsembleQValueNetwork(hidden_dims=(16, 12), ensemble_size=K, prior_scale=0.5)
    jparams = _init(jnet, jax.random.PRNGKey(1), state_dim, A, A)
    params = net.init(torch.Generator().manual_seed(0), state_dim, A, A)
    load_flax_ensemble_q_params(params, _np_tree(jparams))
    return jnet, jparams, net, params


@pytest.mark.parametrize("masked", [False, True])
def test_ensemble_forward_and_gradients_match_jax(masked):
    jnet, jparams, net, params = _ensemble_pair()
    assert not any(p.requires_grad for p in params["prior"].parameters())
    state, actions, mask, _ = _net_inputs(masked=masked)
    weights = np.random.default_rng(3).standard_normal((17, K, 3)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    def objective(p):
        q = jnet.q_ensemble(p, jnp.asarray(state), jnp.asarray(actions), jmask)
        return jnp.sum(q * weights), q

    (_, jq), jgrads = _value_and_grad(objective, jparams)
    s, a = torch.from_numpy(state), torch.from_numpy(actions)
    q = net.q_ensemble(params, s, a, tmask)
    assert q.shape == (17, K, 3)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), **TOL)
    (q * torch.from_numpy(weights)).sum().backward()
    _assert_flat_close(_stacked_tree(params["train"], grad=True), jgrads["train"])
    assert np.abs(np.concatenate([g.ravel() for g in _flat(_np_tree(jgrads["prior"])).values()])
                  ).max() == 0.0
    assert all(p.grad is None for p in params["prior"].parameters())

    z = np.random.default_rng(4).integers(0, K, 17)
    jmember, jmean = jax.jit(lambda p, zz: (
        jnet.q_member(p, jnp.asarray(state), jnp.asarray(actions), zz),
        jnet.q_all(p, jnp.asarray(state), jnp.asarray(actions), jmask)))(
            jparams, jnp.asarray(z, jnp.int32))
    np.testing.assert_allclose(
        net.q_member(params, s, a, torch.from_numpy(z)).detach().numpy(), np.asarray(jmember),
        **TOL)
    np.testing.assert_allclose(net.q_all(params, s, a, tmask).detach().numpy(),
                               np.asarray(jmean), **TOL)


def test_two_tower_forward_and_gradients_match_jax():
    kw = dict(state_hidden_dims=(8,), action_hidden_dims=(10,), hidden_dims=(16, 12),
              state_output_dim=6, action_output_dim=5)
    jnet, net = JaxTwoTower(**kw), TwoTowerQValueNetwork(**kw)
    jparams = _init(jnet, jax.random.PRNGKey(2), 4, 3, 3)
    module = net.init(torch.Generator().manual_seed(0), 4, 3, 3)
    load_flax_two_tower_q_params(module, _np_tree(jparams))
    state, actions, _, weights = _net_inputs()

    def objective(p):
        q = jnet.q_all(p, jnp.asarray(state), jnp.asarray(actions))
        return jnp.sum(q * weights), q

    (_, jq), jgrads = _value_and_grad(objective, jparams)
    q = net.q_all(module, torch.from_numpy(state), torch.from_numpy(actions))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), **TOL)
    (q * torch.from_numpy(weights)).sum().backward()
    _assert_flat_close(_module_tree(module, grad=True), jgrads)
    with pytest.raises(ValueError, match="keys"):
        load_flax_two_tower_q_params(module, {"MLP_0": {}})


def test_mlp_with_prior_matches_jax():
    jnet = JaxMLPWithPrior(hidden_dims=(16,), output_dim=2, prior_scale=0.5)
    net = MLPWithPrior(hidden_dims=(16,), output_dim=2, prior_scale=0.5)
    jparams = _init(jnet, jax.random.PRNGKey(0), 3)
    params = net.init(torch.Generator().manual_seed(0), 3)
    load_flax_mlp_with_prior_params(params, _np_tree(jparams))
    x = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((6, 2)).astype(np.float32)
    (_, jout), jgrads = _value_and_grad(
        lambda p: (jnp.sum(jnet.apply(p, jnp.asarray(x)) * w), jnet.apply(p, jnp.asarray(x))),
        jparams)
    out = net.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    tree = {name: {"kernel": layer.weight.grad.numpy().T, "bias": layer.bias.grad.numpy()}
            for name, layer in zip(params["train"].layer_names, params["train"].layers())}
    _assert_flat_close(tree, jgrads["train"])
    assert all(p.grad is None for p in params["prior"].parameters())


def test_epinet_matches_jax_with_gradients_to_features():
    jnet, net = JaxEpinet(index_dim=4, hidden_dims=(16,), output_dim=2), Epinet(
        index_dim=4, hidden_dims=(16,), output_dim=2)
    jparams = _init(jnet, jax.random.PRNGKey(0), 5)
    params = net.init(torch.Generator().manual_seed(0), 5)
    load_flax_epinet_params(params, _np_tree(jparams))
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((6, 5)).astype(np.float32)
    w = rng.standard_normal((6, 2)).astype(np.float32)
    z = np.asarray(jnet.sample_index(jax.random.PRNGKey(3)))

    def objective(p, f):
        out = jnet.apply(p, f, jnp.asarray(z))
        return jnp.sum(out * w), out

    (_, jout), (jgrads, jfeat_grad) = _value_and_grad(objective, jparams, jnp.asarray(feats),
                                                      argnums=(0, 1))
    f = torch.from_numpy(feats).requires_grad_()
    out = net.apply(params, f, torch.from_numpy(z))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    # The epinet passes the features' gradient; the prior, stop-gradded, does not.
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jfeat_grad), **TOL)
    mlp = params["train"].MLP_0
    tree = {"MLP_0": {name: {"kernel": layer.weight.grad.numpy().T,
                             "bias": layer.bias.grad.numpy()}
                      for name, layer in zip(mlp.layer_names, mlp.layers())}}
    _assert_flat_close(tree, jgrads["train"])
    assert net.sample_index(torch.Generator().manual_seed(0)).shape == (4,)


# ---------------------------------------------------------- deep exploration


def test_deep_exploration_acts_on_each_envs_member_and_redraws_on_done():
    B, A = 12, 3
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((B, K, A)).astype(np.float32)
    mask = rng.random((B, A)) < 0.7
    mask[np.arange(B), rng.integers(0, A, B)] = True
    z = rng.integers(0, K, B)
    jmod, mod = JaxDeepExploration(ensemble_size=K), DeepExploration(ensemble_size=K)
    jstate = JaxDeepExplorationState(z=jnp.asarray(z, jnp.int32))
    state = DeepExplorationState(z=torch.from_numpy(z))
    _, jindex = jmod.act(jstate, jnp.asarray(scores), None, jnp.asarray(mask), None)
    _, index = mod.act(state, torch.from_numpy(scores), None, torch.from_numpy(mask), None)
    np.testing.assert_array_equal(index.numpy(), np.asarray(jindex))
    assert index.dtype == torch.int32
    done = rng.random(B) < 0.5
    key = jax.random.PRNGKey(9)
    jreset = jmod.reset(jstate, jnp.asarray(done), key)
    fresh = np.asarray(jax.random.randint(key, (B,), 0, K, dtype=jnp.int32))
    reset = mod.reset(state, torch.from_numpy(done), None, fresh=torch.from_numpy(fresh))
    np.testing.assert_array_equal(reset.z.numpy(), np.asarray(jreset.z))
    # Its own draw: z changes only where done, and within [0, K).
    drawn = mod.reset(state, torch.from_numpy(done), torch.Generator().manual_seed(0))
    assert torch.equal(drawn.z[~torch.from_numpy(done)], state.z[~torch.from_numpy(done)])
    assert drawn.z.dtype == torch.int64 and ((drawn.z >= 0) & (drawn.z < K)).all()
    assert mod.init(B, CPU).z.shape == (B,)


# ----------------------------------------------------------- bootstrapped DQN


def _bootstrapped(ensemble_size=K):
    kw = {"training_rounds": 1, "batch_size": 64, "target_update_freq": 2}
    jl = JaxBootstrappedDQN(q_network=JaxEnsemble(ensemble_size=ensemble_size),
                            **kw).bind(JaxCartPole().action_space)
    tl = BootstrappedDQN(q_network=EnsembleQValueNetwork(ensemble_size=ensemble_size),
                         **kw).bind(CartPole().action_space)
    jstate = _init(jl, jax.random.PRNGKey(0), 4, jl.action_space, 8)
    tstate = tl.init(torch.Generator().manual_seed(0), 4, tl.action_space, 8, CPU)
    train, prior = _np_tree(jstate.params), _np_tree(jstate.prior_params)
    load_flax_twin_critic_params(tstate.params, train)
    load_flax_twin_critic_params(tstate.target_params, train)
    load_flax_twin_critic_params(tstate.prior_params, prior)
    return jl, jstate, tl, tstate


@pytest.mark.parametrize("ensemble_size", [K, 1])
def test_bootstrapped_learn_batch_matches_optax_over_three_steps(ensemble_size):
    jl, jstate, tl, tstate = _bootstrapped(ensemble_size)
    prior_before = [p.clone() for p in tstate.prior_params.parameters()]
    optimized = {id(p) for g in tstate.optimizer.param_groups for p in g["params"]}
    assert optimized == {id(p) for p in tstate.params.parameters()}
    learn_batch = jax.jit(jl.learn_batch)
    loss_and_grads = jax.jit(lambda st, b: _jax_loss_and_grads(jl, st, b))
    rng = np.random.default_rng(0)
    for step in range(3):
        data = _batch_data(64, seed=step)
        del data["next_action"], data["next_action_index"]
        if step < 2:  # the third batch has no mask: all ones
            data["bootstrap_mask"] = (rng.random((64, ensemble_size)) < 0.5).astype(np.float32)
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
        tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})

        jloss, jgrads = loss_and_grads(jstate, jbatch)
        tloss, _ = tl.td_loss(tstate, tbatch)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        tstate.params.zero_grad()
        tloss.backward()
        _assert_flat_close(_stacked_tree(tstate.params, grad=True), jgrads, STEP_TOL)

        jstate, jaux = learn_batch(jstate, jbatch)
        tstate, taux = tl.learn_batch(tstate, tbatch)
        assert tstate.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), **STEP_TOL)
        np.testing.assert_allclose(taux["per_sample_td"].numpy(),
                                   np.asarray(jaux["per_sample_td"]), **STEP_TOL)
        _assert_flat_close(_stacked_tree(tstate.params), jstate.params, STEP_TOL)
        _assert_flat_close(_stacked_tree(tstate.target_params), jstate.target_params, STEP_TOL)
    for before, after in zip(prior_before, tstate.prior_params.parameters()):
        assert torch.equal(before, after)
    _assert_flat_close(_stacked_tree(tstate.prior_params), jstate.prior_params, dict(rtol=0, atol=0))


def test_bootstrapped_acts_like_jax():
    jl, jstate, tl, tstate = _bootstrapped()
    subj = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)
    act = jax.jit(jl.act, static_argnames="exploit")
    _, jchoice = act(jstate, jnp.asarray(subj), None, jax.random.PRNGKey(0), exploit=True)
    _, choice = tl.act(tstate, torch.from_numpy(subj), None, None, exploit=True)
    np.testing.assert_array_equal(choice.index.numpy(), np.asarray(jchoice.index))
    z = np.arange(8) % K
    jstate = jstate.replace(explore_state=JaxDeepExplorationState(z=jnp.asarray(z, jnp.int32)))
    tstate = dataclasses.replace(tstate, explore_state=DeepExplorationState(z=torch.from_numpy(z)))
    _, jchoice = act(jstate, jnp.asarray(subj), None, jax.random.PRNGKey(0))
    _, choice = tl.act(tstate, torch.from_numpy(subj), None, None)
    np.testing.assert_array_equal(choice.index.numpy(), np.asarray(jchoice.index))
    np.testing.assert_array_equal(choice.action.numpy(), np.asarray(jchoice.action))


def test_bootstrapped_act_dtype_casts_members_and_priors():
    """Under `act_dtype` the acting forward reads bfloat16 copies of the
    members (recast after a learn step) and of the priors (cast once)."""
    tl = BootstrappedDQN(q_network=EnsembleQValueNetwork(ensemble_size=K), act_dtype="bfloat16",
                         training_rounds=1, batch_size=16).bind(CartPole().action_space)
    tstate = tl.init(torch.Generator().manual_seed(0), 4, tl.action_space, 8, CPU)
    assert tstate.act_prior_params.MLP_0.dense_0.kernel.dtype == torch.bfloat16
    subj = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32))
    data = _batch_data(16, seed=0)
    del data["next_action"], data["next_action_index"]
    tstate, _ = tl.learn_batch(tstate, TransitionBatch(
        **{k: torch.from_numpy(v) for k, v in data.items()}))
    _, choice = tl.act(tstate, subj, None, None, exploit=True)
    for cast, param in zip(tstate.act_params.parameters(), tstate.params.parameters()):
        assert torch.equal(cast, param.to(torch.bfloat16))
    q = tl.q_network.q_ensemble(
        {"train": tstate.act_params, "prior": tstate.act_prior_params}, subj.to(torch.bfloat16),
        tl._candidates(tstate, 8).to(torch.bfloat16))
    assert torch.equal(choice.index.long(), q.float().mean(dim=1).argmax(dim=-1))


def test_bootstrapped_agent_keeps_the_prior_and_redraws_z_only_on_done():
    agent = PearlAgent(
        policy_learner=BootstrappedDQN(q_network=EnsembleQValueNetwork(ensemble_size=K),
                                       training_rounds=2, batch_size=32),
        replay_buffer=BootstrapReplayBuffer(capacity=512, ensemble_size=K),
    ).for_env(CartPole())
    venv = VectorEnv(CartPole(), 16, CPU)
    gen = make_generator(0, "cpu")
    env_states, obs = venv.reset(gen)
    astate = agent.init(0, 4, 16, obs, device="cpu")
    assert astate.replay.storage.bootstrap_mask.shape == (512, K)
    prior = [p.clone() for p in astate.learner.prior_params.parameters()]
    params = [p.clone() for p in astate.learner.params.parameters()]
    changed = 0
    for step in range(32):
        z = astate.learner.explore_state.z.clone()
        astate, choice = agent.act(astate, gen)
        env_states, result, next_obs = venv.step(env_states, choice.action, gen)
        astate = agent.observe(astate, result, next_obs, gen)
        moved = astate.learner.explore_state.z != z
        assert not (moved & ~result.done).any(), step
        changed += int(moved.sum())
        if step % 8 == 7:
            astate, metrics = agent.learn(astate, gen)
            assert torch.isfinite(metrics["loss"])
    assert changed > 0 and astate.replay.size == 512
    for before, after in zip(prior, astate.learner.prior_params.parameters()):
        assert torch.equal(before, after)
    assert all(not torch.equal(b, a) for b, a in zip(params, astate.learner.params.parameters()))
    mask = astate.replay.storage.bootstrap_mask
    assert set(mask.unique().tolist()) == {0.0, 1.0}


# ------------------------------------------------------------------- tabular


def _one_hot_data(n, n_states, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_states, n)
    ns = rng.integers(0, n_states, n)
    a = rng.integers(0, 2, n).astype(np.int32)
    return dict(
        state=np.eye(n_states, dtype=np.float32)[s], action=a[:, None].astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_state=np.eye(n_states, dtype=np.float32)[ns],
        terminated=rng.random(n) < 0.3, truncated=np.zeros(n, bool), action_index=a,
    )


def _tabular_pair(jax_kw=None, torch_kw=None):
    jl = JaxTabular(num_states=3, learning_rate=0.5, **(jax_kw or {})).bind(
        JaxCartPole().action_space)
    tl = TabularQLearning(num_states=3, learning_rate=0.5, **(torch_kw or {})).bind(
        CartPole().action_space)
    return (jl, jl.init(jax.random.PRNGKey(0), 3, jl.action_space, 8), tl,
            tl.init(None, 3, tl.action_space, 8, CPU))


def test_tabular_q_sums_repeated_state_action_pairs_like_jax():
    jl, jstate, tl, tstate = _tabular_pair()
    learn_batch = jax.jit(jl.learn_batch)
    for step in range(3):  # 32 rows over 3 x 2 pairs: every pair repeats
        data = _one_hot_data(32, 3, step)
        jstate, jm = learn_batch(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}))
        tstate, tm = tl.learn_batch(tstate, TransitionBatch(
            **{k: torch.from_numpy(v) for k, v in data.items()}))
        np.testing.assert_allclose(tstate.q_table.numpy(), np.asarray(jstate.q_table), **TOL)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
    # `learn` over a part-filled storage: the unwritten rows weigh nothing.
    jbuf, tbuf = JaxBuffer(capacity=16), BasicReplayBuffer(capacity=16)
    data = _one_hot_data(8, 3, 7)
    jbs = jbuf.push(jbuf.init(JaxBatch(**{k: jnp.asarray(v[:1]) for k, v in data.items()})),
                    JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}))
    tbs = tbuf.push(tbuf.init(TransitionBatch(**{k: torch.from_numpy(v[:1]) for k, v in
                                               data.items()})),
                    TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}))
    jstate, _, _ = jax.jit(lambda st, bs: jl.learn(st, jbuf, bs, None))(jstate, jbs)
    tstate, _, _ = tl.learn(tstate, tbuf, tbs, None)
    np.testing.assert_allclose(tstate.q_table.numpy(), np.asarray(jstate.q_table), **TOL)
    assert tl.on_policy


def test_tabular_q_acts_on_jax_tie_noise():
    jl, jstate, tl, tstate = _tabular_pair({"exploration": JaxNoExploration()},
                                           {"exploration": NoExploration()})
    table = np.array([[0.0, 0.0], [1.0, 0.5], [0.2, 0.2]], np.float32)
    jstate = jstate.replace(q_table=jnp.asarray(table))
    tstate.q_table.copy_(torch.from_numpy(table))
    subj = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    key = jax.random.PRNGKey(4)
    _, jchoice = jl.act(jstate, jnp.asarray(subj), None, key)
    k_tie, _ = jax.random.split(key)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(k_tie, (8, 2))))
    _, choice = tl.act(tstate, torch.from_numpy(subj), None, None, noise=noise)
    np.testing.assert_array_equal(choice.index.numpy(), np.asarray(jchoice.index))
    _, jchoice = jl.act(jstate, jnp.asarray(subj), None, key, exploit=True)
    _, choice = tl.act(tstate, torch.from_numpy(subj), None, None, exploit=True)
    np.testing.assert_array_equal(choice.index.numpy(), np.asarray(jchoice.index))
    # Its own draws: the all-zero row's ties go both ways.
    _, choice = tl.act(tstate, torch.from_numpy(np.eye(3, dtype=np.float32)[[0] * 64]), None,
                       torch.Generator().manual_seed(0))
    assert set(choice.index.tolist()) == {0, 1}


def test_dict_tabular_q_matches_jax_step_for_step():
    jl = JaxDictTabular(learning_rate=0.5, exploration_rate=0.3, seed=3)
    tl = DictTabularQLearning(learning_rate=0.5, exploration_rate=0.3, seed=3)
    rng = np.random.default_rng(0)
    for _ in range(200):
        obs, nxt = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        a = jl.act(obs, num_actions=3)
        assert tl.act(obs, num_actions=3) == a
        r, done = float(rng.standard_normal()), bool(rng.random() < 0.2)
        jl.learn(obs, a, r, nxt, done, num_actions=3)
        tl.learn(obs, a, r, nxt, done, num_actions=3)
    assert tl.q_values == jl.q_values and len(tl.q_values) > 4
    assert tl.act(np.array([1.0, 2.0]), 3, exploit=True) == jl.act(np.array([1.0, 2.0]), 3,
                                                                    exploit=True)
