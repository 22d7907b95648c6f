"""The on-policy learners of the PyTorch port against the JAX package: the
reverse walks (`gae_lambda_returns`, `discounted_returns`), the
`OnPolicyReplayBuffer`'s trajectory view, the value networks, two learns each
of PPO and REINFORCE (MLP and CNN actor and critic) on carried weights and
the same minibatch rows, the PPO agent on CartPole as a whole, and the entry
points at a tiny size on the CPU.

JAX and torch random streams never agree: the tests hand the port the rows
JAX's `learn` draws (ppo.py:146-154) and the Gumbel noise its acting draws
(`jax.random.categorical`), from the very keys the JAX code splits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.api.spaces import DiscreteActionSpace as JaxDiscrete
from pearl_tpu.envs.cartpole import CartPole as JaxCartPole
from pearl_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from pearl_tpu.neural_networks.actor_networks import CNNActorNetwork as JaxCNNActor
from pearl_tpu.neural_networks.value_networks import CNNValueNetwork as JaxCNNValue
from pearl_tpu.neural_networks.value_networks import VanillaValueNetwork as JaxValue
from pearl_tpu.policy_learners.sequential_decision_making import (
    REINFORCE as JaxREINFORCE,
    ProximalPolicyOptimization as JaxPPO,
)
from pearl_tpu.policy_learners.sequential_decision_making.ppo import (
    gae_lambda_returns as jax_gae,
)
from pearl_tpu.policy_learners.sequential_decision_making.reinforce import (
    discounted_returns as jax_returns,
)
from pearl_tpu.replay_buffers.on_policy import OnPolicyReplayBuffer as JaxOnPolicy
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.utils.pytree import tree_select as jax_tree_select
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.spaces import DiscreteActionSpace
from pearl_tpu_torch.envs import CartPole, CartPoleState, VectorEnv
from pearl_tpu_torch.neural_networks import (
    CNNActorNetwork,
    CNNValueNetwork,
    VanillaActorNetwork,
    VanillaValueNetwork,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    REINFORCE,
    ProximalPolicyOptimization,
    discounted_returns,
    gae_lambda_returns,
)
from pearl_tpu_torch.replay_buffers import OnPolicyReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import (
    load_flax_discrete_actor_params,
    load_flax_value_params,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# float32 throughout; XLA and PyTorch sum in other orders and Adam's
# m / sqrt(v) passes the differences on, over two learns.
TOL = dict(rtol=1e-4, atol=1e-5)
NET_TOL = dict(rtol=1e-5, atol=1e-6)
# The small CNN: (20, 20, 2) images, kernels (4, 3), strides (2, 1).
CNN = dict(input_shape=(20, 20, 2), out_channels=(4, 8), kernel_sizes=(4, 3), strides=(2, 1),
           hidden_dims=(8,))
CNN_OBS = 20 * 20 * 2


# --------------------------------------------------------- flax <-> port
def flax_leaves(module, value=lambda p: p):
    """{flax path: numpy} over `module`'s parameters (or `value(p)` of each,
    e.g. an Adam moment), in flax's layouts: nn.Linear weights transposed,
    conv weights to HWIO (a leading member axis kept), and the first MLP
    kernel after a conv stack in the reference's (H, W, C) row order."""
    feature = getattr(module, "feature_shape", None)
    first = f"MLP_0.{module.MLP_0.layer_names[0]}" if feature is not None else None
    out = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        v = value(p).detach().numpy()
        if leaf == "weight":  # nn.Linear (out, in), conv (O, I, k, k), stacked conv
            leaf = "kernel"
            v = v.transpose({2: (1, 0), 4: (2, 3, 1, 0), 5: (0, 3, 4, 2, 1)}[v.ndim])
        if leaf == "kernel" and ".".join(path) == first:
            C, H, W = feature
            lead = v.shape[:-2]
            n = len(lead)
            v = v.reshape(lead + (C, H, W, v.shape[-1]))
            v = v.transpose(tuple(range(n)) + (n + 1, n + 2, n, n + 3)).reshape(
                lead + (C * H * W, -1)
            )
        out[tuple(path) + (leaf,)] = v
    return out


def assert_leaves_close(ours, ref, **tol):
    ref = traverse_util.flatten_dict(jax.tree.map(np.asarray, ref))
    assert set(ours) == set(ref)
    for path, v in ref.items():
        np.testing.assert_allclose(ours[path], v, err_msg=str(path), **(tol or TOL))


def assert_adam_close(opt, module, jopt):
    """The port's AdamW moments and count against optax's (an
    `inject_hyperparams` state holds the Adam state inside)."""
    adam = jopt.inner_state[0] if hasattr(jopt, "inner_state") else jopt[0]

    def state(p, key):  # torch makes the state at the first step
        return opt.state[p].get(key, torch.zeros(() if key == "step" else p.shape))

    assert_leaves_close(flax_leaves(module, lambda p: state(p, "exp_avg")), adam.mu)
    assert_leaves_close(flax_leaves(module, lambda p: state(p, "exp_avg_sq")), adam.nu)
    for p in module.parameters():
        assert int(state(p, "step")) == int(adam.count)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


# ------------------------------------------------------ the reverse walks
def _rollout_arrays(seed, T=7, B=5):
    rng = np.random.default_rng(seed)
    terminated = rng.random((T, B)) < 0.2
    truncated = ~terminated & (rng.random((T, B)) < 0.2)
    return dict(
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        next_values=rng.normal(size=(T, B)).astype(np.float32),
        terminated=terminated,
        done=terminated | truncated,
    )


@pytest.mark.parametrize("fn", ["gae", "discounted"])
def test_returns_match_jax_on_a_random_rollout(fn):
    a = _rollout_arrays(0)
    assert a["terminated"].any() and (a["done"] & ~a["terminated"]).any()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if fn == "gae":
        ref = jax_gae(j["rewards"], j["values"], j["next_values"], j["terminated"], j["done"],
                      0.9, 0.8)
        ours = gae_lambda_returns(t["rewards"], t["values"], t["next_values"], t["terminated"],
                                  t["done"], 0.9, 0.8)
    else:
        ref = (jax_returns(j["rewards"], j["next_values"], j["terminated"], j["done"], 0.9),)
        ours = (discounted_returns(t["rewards"], t["next_values"], t["terminated"], t["done"],
                                   0.9),)
        assert not t["done"][-1].all()  # the last step bootstraps all the same
    for o, r in zip(ours, ref):
        assert o.shape == (7, 5) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["single_episode", "truncation_bootstraps"])
def test_discounted_returns_reference_cases(case):
    if case == "single_episode":  # gamma 0.5, rewards 1, terminal at t = 2
        rewards, next_values = torch.ones(3, 1), torch.zeros(3, 1)
        terminated = torch.tensor([[False], [False], [True]])
        done, want = terminated, [1.75, 1.5, 1.0]
    else:  # truncated at the end: G1 = 1 + 0.5 * 10, G0 = 1 + 0.5 * G1
        rewards, next_values = torch.ones(2, 1), torch.tensor([[0.0], [10.0]])
        terminated = torch.zeros(2, 1, dtype=torch.bool)
        done, want = torch.tensor([[False], [True]]), [4.0, 6.0]
    g = discounted_returns(rewards, next_values, terminated, done, 0.5)
    np.testing.assert_allclose(g[:, 0].numpy(), want, rtol=1e-6)


def test_gae_at_lambda_one_is_the_monte_carlo_return():
    T, B = 5, 2
    rewards = torch.from_numpy(np.random.default_rng(1).uniform(size=(T, B)).astype(np.float32))
    zeros = torch.zeros(T, B)
    terminated = torch.zeros(T, B, dtype=torch.bool)
    terminated[-1] = True
    adv, lam_ret = gae_lambda_returns(rewards, zeros, zeros, terminated, terminated, 0.9, 1.0)
    expect = discounted_returns(rewards, zeros, terminated, terminated, 0.9)
    torch.testing.assert_close(adv, expect, rtol=1e-5, atol=0)
    torch.testing.assert_close(lam_ret, adv, rtol=1e-5, atol=0)


# ---------------------------------------------------------------- buffer
def _transitions(seed, T, B, obs_dim, num_actions, scale=1.0):
    """T pushes of B transitions, as numpy dicts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(T):
        idx = rng.integers(0, num_actions, B).astype(np.int32)
        terminated = rng.random(B) < 0.2
        out.append(dict(
            state=(rng.uniform(size=(B, obs_dim)) * scale).astype(np.float32),
            action=idx[:, None].astype(np.float32),
            reward=rng.normal(size=B).astype(np.float32),
            next_state=(rng.uniform(size=(B, obs_dim)) * scale).astype(np.float32),
            terminated=terminated,
            truncated=~terminated & (rng.random(B) < 0.2),
            action_index=idx,
        ))
    return out


def _push_all(jbuf, jbs, tbuf, tbs, pushes):
    for p in pushes:
        jbs = jbuf.push(jbs, JaxBatch(**{k: jnp.asarray(v) for k, v in p.items()}))
        tbs = tbuf.push(tbs, TransitionBatch(**{k: torch.from_numpy(v) for k, v in p.items()}))
    return jbs, tbs


def _buffers(T, B, obs_dim):
    jbuf, tbuf = JaxOnPolicy(capacity=T * B, num_envs=B), OnPolicyReplayBuffer(
        capacity=T * B, num_envs=B
    )
    example = _transitions(99, 1, 1, obs_dim, 2)[0]
    jbs = jbuf.init(JaxBatch(**{k: jnp.asarray(v) for k, v in example.items()}))
    tbs = tbuf.init(TransitionBatch(**{k: torch.from_numpy(v) for k, v in example.items()}))
    return jbuf, jbs, tbuf, tbs


def test_trajectory_view_after_T_pushes_is_the_references_and_a_view():
    T, B = 4, 3
    jbuf, jbs, tbuf, tbs = _buffers(T, B, 4)
    assert tbuf.rollout_steps == jbuf.rollout_steps == T
    jbs, tbs = _push_all(jbuf, jbs, tbuf, tbs, _transitions(0, T, B, 4, 2))
    assert tbs.size == T * B and tbs.cursor == 0 == int(jbs.cursor)
    jview, tview = jbuf.trajectory_view(jbs), tbuf.trajectory_view(tbs)
    for f in dataclasses.fields(tview):
        ours = getattr(tview, f.name)
        if ours is None:
            assert getattr(jview, f.name) is None
            continue
        ref = np.asarray(getattr(jview, f.name))
        assert tuple(ours.shape) == ref.shape and ours.shape[:2] == (T, B)
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert ours.data_ptr() == getattr(tbs.storage, f.name).data_ptr()  # a view
    assert tbuf.clear(tbs).cursor == 0


# ---------------------------------------------------------- value networks
@pytest.mark.parametrize("kind", ["vanilla", "cnn"])
def test_value_networks_match_jax_forward_and_grads(kind):
    if kind == "vanilla":
        jnet, tnet, dim, scale = JaxValue(hidden_dims=(8, 8)), VanillaValueNetwork(
            hidden_dims=(8, 8)), 4, 1.0
    else:
        jnet, tnet, dim, scale = JaxCNNValue(**CNN), CNNValueNetwork(**CNN), CNN_OBS, 255.0
    jparams = jnet.init(jax.random.PRNGKey(0), dim)
    params = load_flax_value_params(tnet.init(torch.Generator().manual_seed(0), dim),
                                    np_tree(jparams))
    rng = np.random.default_rng(2)
    x = (rng.uniform(size=(6, dim)) * scale).astype(np.float32)
    w = rng.normal(size=6).astype(np.float32)
    def jloss(p):
        v = jnet.value(p, jnp.asarray(x))
        return jnp.sum(v * w), v

    (_, jvalues), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    v = tnet.value(params, torch.from_numpy(x))
    assert v.shape == (6,)
    (v * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jvalues), **NET_TOL)
    assert_leaves_close(flax_leaves(params, lambda p: p.grad), jgrads, **NET_TOL)


# ------------------------------------------------------------- learners
LEARNERS = {"ppo": (JaxPPO, ProximalPolicyOptimization), "reinforce": (JaxREINFORCE, REINFORCE)}


def _on_policy_learners(name, nets, num_actions=3):
    jax_cls, cls = LEARNERS[name]
    kw = dict(actor_learning_rate=3e-3, critic_learning_rate=3e-3)
    if name == "ppo":
        kw.update(training_rounds=3, batch_size=8, epsilon=0.1)
    if nets == "cnn":
        jkw = dict(actor_network=JaxCNNActor(**CNN), critic_network=JaxCNNValue(**CNN))
        tkw = dict(actor_network=CNNActorNetwork(**CNN), critic_network=CNNValueNetwork(**CNN))
        dim = CNN_OBS
    else:
        from pearl_tpu.neural_networks.actor_networks import VanillaActorNetwork as JaxActor

        jkw = dict(actor_network=JaxActor(hidden_dims=(8, 8)), critic_network=JaxValue(
            hidden_dims=(8, 8)))
        tkw = dict(actor_network=VanillaActorNetwork(hidden_dims=(8, 8)),
                   critic_network=VanillaValueNetwork(hidden_dims=(8, 8)))
        dim = 4
    jl = jax_cls(**kw, **jkw).bind(JaxDiscrete.create(jnp.arange(num_actions)))
    tl = cls(**kw, **tkw).bind(DiscreteActionSpace.discrete(num_actions))
    jstate = jl.init(jax.random.PRNGKey(0), dim, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), dim, tl.action_space, 1, CPU)
    carry_weights(jstate, tstate)
    return jl, jstate, tl, tstate, dim


def carry_weights(jstate, tstate):
    load_flax_discrete_actor_params(tstate.actor_params, np_tree(jstate.actor_params))
    load_flax_value_params(tstate.critic_params, np_tree(jstate.critic_params))


def assert_on_policy_states_close(jstate, tstate):
    assert tstate.step == int(jstate.step)
    assert tstate.critic_target_params is None and jstate.critic_target_params is None
    assert_leaves_close(flax_leaves(tstate.actor_params), jstate.actor_params)
    assert_leaves_close(flax_leaves(tstate.critic_params), jstate.critic_params)
    assert_adam_close(tstate.actor_opt, tstate.actor_params, jstate.actor_opt)
    assert_adam_close(tstate.critic_opt, tstate.critic_params, jstate.critic_opt)


def ppo_indices(learner, key, rows):
    """The rows JAX's PPO.learn draws from `key` (ppo.py:146-154)."""
    keys = jax.random.split(key, learner.training_rounds)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.randint(k, (learner.batch_size,), 0, rows)) for k in keys
    ])).long()


@pytest.mark.parametrize("nets", ["vanilla", "cnn"])
@pytest.mark.parametrize("name", list(LEARNERS))
def test_learn_matches_jax_over_two_learns(name, nets):
    T, B = 4, 5
    jl, jstate, tl, tstate, dim = _on_policy_learners(name, nets)
    jbuf, jbs, tbuf, tbs = _buffers(T, B, dim)
    jax_learn = jax.jit(lambda s, bs, k: jl.learn(s, jbuf, bs, k))
    scale = 255.0 if nets == "cnn" else 1.0
    for learn in range(2):
        jbs, tbs = _push_all(jbuf, jbs, tbuf, tbs, _transitions(learn, T, B, dim, 3, scale))
        key = jax.random.PRNGKey(10 + learn)
        indices = ppo_indices(tl, key, T * B) if name == "ppo" else None
        jstate, jbs, jmetrics = jax_learn(jstate, jbs, key)
        tstate, tbs, tmetrics = tl.learn(tstate, tbuf, tbs, None, indices=indices)
        assert set(tmetrics) == set(jmetrics) == {"actor_loss", "critic_loss"}
        for k in jmetrics:
            np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), err_msg=k, **TOL)
        assert_on_policy_states_close(jstate, tstate)
        jbs, tbs = jbuf.clear(jbs), tbuf.clear(tbs)
    assert tstate.step == (2 * tl.training_rounds if name == "ppo" else 2)


def test_on_policy_learners_refuse_what_they_cannot_learn_from():
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    _, _, tl, tstate, _ = _on_policy_learners("ppo", "vanilla")
    buf = BasicReplayBuffer(capacity=8)
    with pytest.raises(TypeError, match="OnPolicyReplayBuffer"):
        tl.learn(tstate, buf, None, None)
    with pytest.raises(NotImplementedError, match="whole rollouts"):
        tl.learn_batch(tstate, None)
    _, _, rl, rstate, _ = _on_policy_learners("reinforce", "vanilla")
    with pytest.raises(ValueError, match="no indices"):
        rl.learn(rstate, buf, None, None, indices=torch.zeros(1, 1, dtype=torch.long))


# --------------------------------------------------- the slice as a whole
def test_ppo_agent_acts_observes_and_learns_like_the_jax_agent():
    n, T, rounds, batch = 8, 4, 2, 8
    rng = np.random.default_rng(0)
    physics = rng.uniform(-0.05, 0.05, (n, 4)).astype(np.float32)
    physics[0] = [2.39, 1.0, 0.0, 0.0]  # terminates on the first step
    t0 = np.zeros(n, np.int32)
    t0[1] = 498  # truncates on the second step
    kw = dict(training_rounds=rounds, batch_size=batch)
    jagent = JaxAgent(
        policy_learner=JaxPPO(**kw), replay_buffer=JaxOnPolicy(capacity=T * n, num_envs=n)
    ).for_env(JaxCartPole())
    tagent = PearlAgent(
        policy_learner=ProximalPolicyOptimization(**kw),
        replay_buffer=OnPolicyReplayBuffer(capacity=T * n, num_envs=n),
    ).for_env(CartPole())
    assert isinstance(tagent.policy_learner.actor_network, VanillaActorNetwork)
    jastate = jagent.init(jax.random.PRNGKey(0), 4, n, jnp.asarray(physics))
    tastate = tagent.init(0, 4, n, torch.from_numpy(physics), device="cpu")
    carry_weights(jastate.learner, tastate.learner)
    assert tastate.available_mask.shape == (n, 2) and tastate.available_mask.all()

    jenv, venv = JaxCartPole(), VectorEnv(CartPole(), n, CPU)
    jstates = JaxCartPoleState(physics=jnp.asarray(physics), t=jnp.asarray(t0))
    tstates = CartPoleState(torch.from_numpy(physics), torch.from_numpy(t0))
    jax_act, jax_observe = jax.jit(jagent.act), jax.jit(jagent.observe)
    jax_step = jax.jit(jax.vmap(jenv.step))
    key = jax.random.PRNGKey(1)
    for step in range(T):
        key, k_act, k_env, k_obs = jax.random.split(key, 4)
        # PropensityExploration's categorical draw: Gumbel noise from k_act.
        noise = torch.tensor(np.asarray(jax.random.gumbel(k_act, (n, 2))))
        jastate, jchoice = jax_act(jastate, k_act)
        tlearner, tchoice = tagent.policy_learner.act(
            tastate.learner, tagent.subjective_state(tastate), tastate.available_mask, None,
            noise=noise,
        )
        tastate = dataclasses.replace(tastate, learner=tlearner, last_action=tchoice)
        np.testing.assert_array_equal(tchoice.index.numpy(), np.asarray(jchoice.index))
        np.testing.assert_array_equal(tchoice.action.numpy(), np.asarray(jchoice.action))

        fresh = rng.uniform(-0.05, 0.05, (n, 4)).astype(np.float32)
        jfresh = JaxCartPoleState(physics=jnp.asarray(fresh), t=jnp.zeros(n, jnp.int32))
        jnew, jres = jax_step(jstates, jchoice.action, jax.random.split(k_env, n))
        jstates = jax_tree_select(jres.done, jfresh, jnew)
        jnext_obs = jax_tree_select(jres.done, jfresh.physics, jres.observation)
        tstates, tres, tnext_obs = venv.step(
            tstates, tchoice.action,
            fresh=(CartPoleState(torch.from_numpy(fresh), torch.zeros(n, dtype=torch.int32)),
                   torch.from_numpy(fresh)),
        )
        np.testing.assert_array_equal(tres.done.numpy(), np.asarray(jres.done))
        jastate = jax_observe(jastate, jres, jnext_obs, k_obs)
        tastate = tagent.observe(tastate, tres, tnext_obs)
    storage = tastate.replay.storage
    assert bool(storage.terminated.any()) and bool((storage.truncated & ~storage.terminated).any())
    assert tastate.replay.size == int(jastate.replay.size) == T * n

    learn_key = jax.random.PRNGKey(7)
    k_l, _ = jax.random.split(learn_key)  # pearl_agent.py: the learner's key
    indices = ppo_indices(tagent.policy_learner, k_l, T * n)
    jastate, jmetrics = jagent.learn(jastate, learn_key)
    tastate, tmetrics = tagent.learn(tastate, None, indices=indices)
    for k in jmetrics:
        np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), err_msg=k, **TOL)
    assert_on_policy_states_close(jastate.learner, tastate.learner)
    # The agent clears an on-policy buffer after its learn.
    assert tastate.replay.size == 0 == int(jastate.replay.size) and tastate.replay.cursor == 0


def test_runner_drives_ppo_at_64_envs_clearing_the_buffer_after_every_learn(monkeypatch):
    n, spl, lpc, calls = 64, 4, 2, 2
    seen = []
    learn = ProximalPolicyOptimization.learn

    def recording_learn(self, state, buffer, buffer_state, generator, indices=None):
        seen.append((buffer_state.size, buffer_state.cursor))
        return learn(self, state, buffer, buffer_state, generator, indices)

    monkeypatch.setattr(ProximalPolicyOptimization, "learn", recording_learn)
    agent = PearlAgent(
        policy_learner=ProximalPolicyOptimization(training_rounds=2, batch_size=32),
        replay_buffer=OnPolicyReplayBuffer(capacity=spl * n, num_envs=n),
    )
    init_fn, run_fn = make_compiled_runner(
        agent, CartPole(), num_envs=n, steps_per_learn=spl, learns_per_call=lpc, device="cpu"
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cpu")
    for call in range(calls):
        astate, env_states, stats = run_fn(astate, env_states, gen)
        assert astate.replay.size == 0 and astate.replay.cursor == 0
        assert stats["reward_sum"].item() == spl * lpc * n
    # Every learn saw exactly one full rollout, and the buffer started over.
    assert seen == [(spl * n, 0)] * (lpc * calls)
    assert astate.learner.step == 2 * lpc * calls
    index = astate.replay.storage.action_index
    assert set(index.unique().tolist()) <= {0, 1}
    torch.testing.assert_close(astate.replay.storage.action[:, 0], index.float())


@pytest.mark.parametrize("name", list(LEARNERS))
def test_online_learning_runs_on_policy_learners_on_cpu(name):
    n, rollout, chunks = 4, 16, 3
    learner = (ProximalPolicyOptimization(training_rounds=2, batch_size=32) if name == "ppo"
               else REINFORCE())
    agent = PearlAgent(
        policy_learner=learner,
        replay_buffer=OnPolicyReplayBuffer(capacity=rollout * n, num_envs=n),
    )
    res = online_learning(
        agent, CartPole(), num_envs=n, max_steps=rollout * n * chunks,
        learn_every_k_steps=rollout, seed=0, device="cpu",
    )
    assert res.total_steps == rollout * n * chunks
    assert res.agent_state.learner.step == chunks * (2 if name == "ppo" else 1)
    assert res.agent_state.replay.size == 0
