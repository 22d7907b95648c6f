"""Continuous control in the PyTorch port against the JAX package: the
actor-critic learners (continuous SAC with and without temperature tuning,
DDPG, TD3 with its delayed actor, TD3BC) over three `learn_batch` steps on
carried weights and the same normal draws, their continuous `act`,
`NormalDistributionExploration`, the one-hot repair, and the agent on
Pendulum as a whole: acting, observing into replay and learning like the JAX
agent, and the entry points at a tiny size on the CPU.

The noise: JAX draws it from keys its code splits (actor_critic_base.py:242,
sac_continuous.py:102, td3.py:31); the tests draw the same numbers from the
same keys and hand them to the port through its `noise=` seams.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pearl_tpu.action_representation_modules import (
    OneHotActionRepresentation as JaxOneHot,
)
from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.api.spaces import DiscreteActionSpace as JaxDiscreteSpace
from pearl_tpu.envs import Pendulum as JaxPendulum
from pearl_tpu.envs.pendulum import PendulumState as JaxPendulumState
from pearl_tpu.policy_learners.exploration_modules.common import (
    NormalDistributionExploration as JaxNormalExploration,
)
from pearl_tpu.policy_learners.sequential_decision_making import (
    TD3 as JaxTD3,
    TD3BC as JaxTD3BC,
    ContinuousSoftActorCritic as JaxCSAC,
    DeepDeterministicPolicyGradient as JaxDDPG,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.utils.pytree import tree_select as jax_tree_select
from pearl_tpu_torch.action_representation_modules import OneHotActionRepresentation
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.spaces import DiscreteActionSpace
from pearl_tpu_torch.envs import Pendulum, PendulumState, VectorEnv
from pearl_tpu_torch.policy_learners.exploration_modules import NormalDistributionExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    TD3,
    TD3BC,
    ContinuousSoftActorCritic,
    DeepDeterministicPolicyGradient,
)
from pearl_tpu_torch.parallel import make_mesh
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.pytree import compare
from pearl_tpu_torch.utils.jax_params import (
    load_flax_deterministic_actor_params,
    load_flax_gaussian_actor_params,
    load_flax_twin_critic_params,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# float32 throughout; XLA and PyTorch sum in other orders and Adam's
# m / sqrt(v) passes the differences on, over three steps.
TOL = dict(rtol=1e-4, atol=1e-5)
B = 32

CONFIGS = {
    "csac_autotune": (JaxCSAC, ContinuousSoftActorCritic, {}),
    "csac_fixed_alpha": (JaxCSAC, ContinuousSoftActorCritic, {"entropy_autotune": False}),
    "ddpg": (JaxDDPG, DeepDeterministicPolicyGradient, {}),
    "td3": (JaxTD3, TD3, {"actor_update_freq": 2}),
    "td3bc": (JaxTD3BC, TD3BC, {}),
}


def _learners(name, **overrides):
    jax_cls, cls, extra = CONFIGS[name]
    kw = {"training_rounds": 1, "batch_size": B, **extra, **overrides}
    jl = jax_cls(**kw).bind(JaxPendulum().action_space)
    tl = cls(**kw).bind(Pendulum().action_space)
    jstate = jl.init(jax.random.PRNGKey(0), 3, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), 3, tl.action_space, 1, CPU)
    _carry_weights(jstate, tstate)
    return jl, jstate, tl, tstate


def _load_actor(module, params):
    if "mu" in params:
        load_flax_gaussian_actor_params(module, params)
    else:
        load_flax_deterministic_actor_params(module, params)


def _carry_weights(jstate, tstate):
    """The JAX learner state's weights (and temperature) into the port's."""
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    _load_actor(tstate.actor_params, np_tree(jstate.actor_params))
    if tstate.actor_target_params is not None:
        _load_actor(tstate.actor_target_params, np_tree(jstate.actor_target_params))
    load_flax_twin_critic_params(tstate.critic_params, np_tree(jstate.critic_params))
    load_flax_twin_critic_params(tstate.critic_target_params, np_tree(jstate.critic_target_params))
    if tstate.extra is not None:
        with torch.no_grad():
            tstate.extra.log_alpha.copy_(torch.tensor(np.asarray(jstate.extra.log_alpha)))


def _port_leaves(module, value=lambda p: p):
    """{flax path: numpy} over `module`'s parameters, or over `value(p)` of
    each: an `nn.Linear` weight is the transpose of a flax kernel."""
    out = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        v = value(p).detach().numpy()
        if leaf == "weight":
            leaf, v = "kernel", v.T
        out[tuple(path) + (leaf,)] = v
    return out


def _assert_leaves_close(ours, ref, **tol):
    ref = traverse_util.flatten_dict(jax.tree.map(np.asarray, ref))
    assert set(ours) == set(ref)
    for path, v in ref.items():
        np.testing.assert_allclose(ours[path], v, err_msg=str(path), **(tol or TOL))


def _assert_adam_close(opt, module, jopt):
    """The port's AdamW moments and count against optax's."""
    adam = jopt[0]

    def state(p, key):  # torch makes the state at the first step
        return opt.state[p].get(key, torch.zeros(() if key == "step" else p.shape))

    _assert_leaves_close(_port_leaves(module, lambda p: state(p, "exp_avg")), adam.mu)
    _assert_leaves_close(_port_leaves(module, lambda p: state(p, "exp_avg_sq")), adam.nu)
    for p in module.parameters():
        assert int(state(p, "step")) == int(adam.count)


def _batch_data(seed, n=B):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, n)
    obs = lambda th: np.stack(  # noqa: E731
        [np.cos(th), np.sin(th), rng.uniform(-8, 8, n)], -1
    ).astype(np.float32)
    return dict(
        state=obs(theta),
        action=rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        reward=-rng.uniform(0, 16, n).astype(np.float32),
        next_state=obs(theta + 0.1),
        terminated=rng.random(n) < 0.25,
        truncated=rng.random(n) < 0.1,
        action_index=np.zeros(n, np.int32),
    )


def _batches(data):
    return (
        JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}),
        TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}),
    )


def _learn_noise(key, n=B):
    """The normal draws JAX's learn_batch makes from its state key, by seam."""
    k_next, k_actor, k_critic = jax.random.split(key, 3)
    draw = lambda k: torch.tensor(np.asarray(jax.random.normal(k, (n, 1))))  # noqa: E731
    return {
        "actor": draw(k_actor),
        "critic": draw(k_critic),
        "target": draw(k_critic),
        "alpha": draw(jax.random.fold_in(k_next, 1)),
    }


def _assert_states_close(jstate, tstate):
    assert tstate.step == int(jstate.step)
    _assert_leaves_close(_port_leaves(tstate.actor_params), jstate.actor_params)
    _assert_leaves_close(_port_leaves(tstate.critic_params), jstate.critic_params)
    _assert_leaves_close(_port_leaves(tstate.critic_target_params), jstate.critic_target_params)
    if jstate.actor_target_params is not None:
        _assert_leaves_close(_port_leaves(tstate.actor_target_params), jstate.actor_target_params)
    else:
        assert tstate.actor_target_params is None
    _assert_adam_close(tstate.actor_opt, tstate.actor_params, jstate.actor_opt)
    _assert_adam_close(tstate.critic_opt, tstate.critic_params, jstate.critic_opt)
    assert (tstate.extra is None) == (jstate.extra is None)
    if jstate.extra is not None:
        np.testing.assert_allclose(
            tstate.extra.log_alpha.item(), float(jstate.extra.log_alpha), **TOL
        )


@pytest.mark.parametrize("name", list(CONFIGS))
def test_learn_batch_matches_jax_over_three_steps(name):
    jl, jstate, tl, tstate = _learners(name)
    _assert_states_close(jstate, tstate)
    jax_learn_batch = jax.jit(jl.learn_batch)  # one compile beats hundreds of eager ones
    for step in range(3):
        jbatch, tbatch = _batches(_batch_data(step))
        noise = _learn_noise(jstate.key)
        jstate, jmetrics = jax_learn_batch(jstate, jbatch)
        tstate, tmetrics = tl.learn_batch(tstate, tbatch, noise=noise)
        assert set(tmetrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), err_msg=k, **TOL)
        _assert_states_close(jstate, tstate)
    assert tstate.step == 3


def test_td3_closed_gate_keeps_actor_and_target_exactly_and_advances_adam():
    _, _, tl, tstate = _learners("td3")
    opened = []
    for step in range(4):
        actor = [p.detach().clone() for p in tstate.actor_params.parameters()]
        target = [p.clone() for p in tstate.actor_target_params.parameters()]
        critic = [p.detach().clone() for p in tstate.critic_params.parameters()]
        _, tbatch = _batches(_batch_data(10 + step))
        tstate, _ = tl.learn_batch(tstate, tbatch)
        gate_open = tstate.step % 2 == 0
        opened.append(gate_open)
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))  # noqa: E731
        assert same(actor, tstate.actor_params.parameters()) != gate_open
        assert same(target, tstate.actor_target_params.parameters()) != gate_open
        assert not same(critic, tstate.critic_params.parameters())  # the critic every step
        p0 = next(tstate.actor_params.parameters())
        assert int(tstate.actor_opt.state[p0]["step"]) == step + 1
        assert tstate.actor_opt.param_groups[0]["lr"] == tl.actor_learning_rate
    assert opened == [False, True, False, True]


@pytest.mark.parametrize("name", ["csac_autotune", "ddpg"])
def test_actor_step_leaves_the_critic_untouched(name):
    # With a critic learning rate of 0 the critic's own step cannot move it:
    # whatever moved it would be the actor's. Its .grad must be its own
    # loss's gradient, with nothing of the actor loss's added.
    _, _, tl, tstate = _learners(name, critic_learning_rate=0.0)
    _, tbatch = _batches(_batch_data(20))
    noise = {k: torch.randn(B, 1, generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(("actor", "critic", "target", "alpha"))}
    critic = [p.detach().clone() for p in tstate.critic_params.parameters()]
    c_loss = tl.critic_loss(
        tstate, tstate.critic_params, tbatch, tbatch.state, tbatch.next_state, noise
    )
    expected = torch.autograd.grad(c_loss, list(tstate.critic_params.parameters()))
    a_loss = tl.actor_loss(tstate, tstate.actor_params, tbatch, tbatch.state, noise)
    expected_actor = torch.autograd.grad(a_loss, list(tstate.actor_params.parameters()))
    tstate, _ = tl.learn_batch(tstate, tbatch, noise=noise)
    for before, p, g in zip(critic, tstate.critic_params.parameters(), expected):
        assert torch.equal(before, p)
        assert torch.equal(p.grad, g)
    for p, g in zip(tstate.actor_params.parameters(), expected_actor):
        assert torch.equal(p.grad, g)
    for p in tstate.critic_target_params.parameters():
        assert p.grad is None and not p.requires_grad


def test_sac_without_autotune_keeps_alpha_constant():
    _, _, tl, tstate = _learners("csac_fixed_alpha", entropy_coef=0.1)
    assert tstate.extra is None and tl._alpha(tstate) == 0.1
    _, tbatch = _batches(_batch_data(30))
    tstate, metrics = tl.learn_batch(tstate, tbatch)
    assert "alpha" not in metrics and tstate.extra is None


def test_targets_are_copies_and_opt_hyperparameters_are_the_references():
    _, _, tl, tstate = _learners("ddpg")
    for online, target in (
        (tstate.actor_params, tstate.actor_target_params),
        (tstate.critic_params, tstate.critic_target_params),
    ):
        for o, t in zip(online.parameters(), target.parameters()):
            assert o.data_ptr() != t.data_ptr() and torch.equal(o, t) and not t.requires_grad
    for opt, lr in ((tstate.actor_opt, 1e-3), (tstate.critic_opt, 1e-3)):
        group = opt.param_groups[0]
        assert isinstance(opt, torch.optim.AdamW)
        assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
            lr, (0.9, 0.999), 1e-8, 0.01,
        )
    assert tstate.summ_opt is None  # the identity summarizer has no parameters
    _, _, _, sac = _learners("csac_autotune")
    group = sac.extra.optimizer.param_groups[0]
    assert isinstance(sac.extra.optimizer, torch.optim.Adam) and group["lr"] == 3e-4
    assert sac.extra.log_alpha.shape == ()


def test_features_not_ported_raise():
    # A discrete space initialises as far as the reference's does: continuous
    # SAC on it fails as the JAX learner fails (its Gaussian actor takes no
    # action count), else both give the same shapes.
    jl = JaxCSAC().bind(JaxDiscreteSpace.create(jnp.arange(2)))
    tl = ContinuousSoftActorCritic().bind(DiscreteActionSpace.discrete(2))
    try:
        jstate = jl.init(jax.random.PRNGKey(0), 4, jl.action_space, 1)
    except Exception as err:  # noqa: BLE001 - the port must fail the same way
        with pytest.raises(type(err)):
            tl.init(torch.Generator(), 4, tl.action_space, 1, CPU)
    else:
        tstate = tl.init(torch.Generator(), 4, tl.action_space, 1, CPU)
        ref = traverse_util.flatten_dict(jax.tree.map(np.shape, jstate.actor_params))
        assert {k: v.shape for k, v in _port_leaves(tstate.actor_params).items()} == ref
    # `pmean_axis` on a mesh of one rank averages nothing: the learn step is
    # the step without it, bit for bit.
    _, _, tl, tstate = _learners("csac_autotune")
    alone = copy.deepcopy(tstate)
    _, tbatch = _batches(_batch_data(40))
    noise = {k: torch.randn(B, 1, generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(("actor", "critic", "target", "alpha"))}
    with make_mesh(1, device="cpu") as mesh:
        tstate, metrics = dataclasses.replace(tl, pmean_axis=mesh.axis("data")).learn_batch(
            tstate, tbatch, noise=noise)
    alone, alone_metrics = tl.learn_batch(alone, tbatch, noise=noise)
    assert compare(tstate, alone, rtol=0, atol=0) == ""
    assert all(torch.equal(metrics[k], alone_metrics[k]) for k in metrics)
    # preprocess_batch is the identity, as the JAX learner's, and
    # PearlAgent.learn_batch hands the learner what it returns.
    jl, jstate, tl, tstate = _learners("ddpg")
    jbatch, tbatch = _batches(_batch_data(0))
    assert jl.preprocess_batch(jstate, jbatch) is jbatch
    assert tl.preprocess_batch(tstate, tbatch) is tbatch
    seen = []

    class Preprocessing(DeepDeterministicPolicyGradient):
        def preprocess_batch(self, state, batch):
            seen.append(batch)
            return dataclasses.replace(batch, reward=batch.reward + 1.0)

        def learn_batch(self, state, batch, noise=None):
            seen.append(batch)
            return state, {}

    agent = PearlAgent(policy_learner=Preprocessing()).for_env(Pendulum())
    astate = agent.init(0, 3, 1, torch.zeros(1, 3), device="cpu")
    agent.learn_batch(astate, tbatch)
    assert seen[0] is tbatch and torch.equal(seen[1].reward, tbatch.reward + 1.0)
    # PolicyLearner.learn: every round's sample passes through it.
    seen.clear()
    replay = agent.replay_buffer.push(astate.replay, tbatch)
    rows = torch.arange(4)[None]
    agent.policy_learner.learn(astate.learner, agent.replay_buffer, replay, None, indices=rows)
    assert len(seen) == 2 and torch.equal(seen[1].reward, tbatch.reward[:4] + 1.0)


# ------------------------------------------------------------------- acting
@pytest.mark.parametrize(
    "name,exploit", [("csac_autotune", False), ("csac_autotune", True), ("ddpg", False),
                     ("ddpg", True), ("td3", False)],
)
def test_act_matches_jax_with_the_same_draws(name, exploit):
    jl, jstate, tl, tstate = _learners(name)
    subj = _batch_data(40)["state"]
    key = jax.random.PRNGKey(5)
    # Both the policy sample and the exploration noise are normal(key, (B, 1)).
    noise = torch.tensor(np.asarray(jax.random.normal(key, (B, 1))))
    _, jchoice = jl.act(jstate, jnp.asarray(subj), None, key, exploit=exploit)
    _, tchoice = tl.act(tstate, torch.from_numpy(subj), None, None, exploit=exploit, noise=noise)
    assert tchoice.action.shape == (B, 1) and tchoice.action.dtype == torch.float32
    np.testing.assert_allclose(tchoice.action.numpy(), np.asarray(jchoice.action), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tchoice.index.numpy(), np.asarray(jchoice.index))
    assert (tchoice.index == 0).all() and (tchoice.action.abs() <= 2.0).all()


def test_act_dtype_acts_on_a_cast_copy_that_follows_the_actor():
    _, _, tl, tstate = _learners("ddpg")
    tl16 = dataclasses.replace(tl, act_dtype="bfloat16")
    state16 = tl16.init(torch.Generator().manual_seed(0), 3, tl.action_space, 1, CPU)
    state16 = dataclasses.replace(
        tstate, act_actor=state16.act_actor
    )  # the carried weights, with a bfloat16 copy
    subj = torch.from_numpy(_batch_data(41)["state"])

    def acts(state, learner):
        return learner.act(state, subj, None, None, exploit=True)[1].action

    full, cast = acts(tstate, tl), acts(state16, tl16)
    assert cast.dtype == torch.float32
    torch.testing.assert_close(cast, full, rtol=0, atol=5e-2)  # bfloat16 forward
    _, tbatch = _batches(_batch_data(42))
    state16, _ = tl16.learn_batch(state16, tbatch)
    after = acts(state16, tl16)
    assert not torch.equal(after, cast)
    for c, p in zip(state16.act_actor.parameters(), state16.actor_params.parameters()):
        assert c.dtype == torch.bfloat16 and torch.equal(c, p.detach().to(torch.bfloat16))


def test_normal_exploration_matches_jax_with_the_same_draws():
    rng = np.random.default_rng(50)
    base = rng.uniform(-2, 2, (B, 1)).astype(np.float32)
    base[:4] = [[2.0], [-2.0], [1.99], [-1.99]]  # clipped by the noise
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (B, 1)))
    low, high = np.float32([-2.0]), np.float32([2.0])
    for mean, std in ((0.0, 0.1), (0.05, 0.3)):
        _, ref = JaxNormalExploration(mean=mean, std_dev=std).act_continuous(
            (), jnp.asarray(base), jnp.asarray(low), jnp.asarray(high), key
        )
        _, ours = NormalDistributionExploration(mean=mean, std_dev=std).act_continuous(
            (), torch.from_numpy(base), torch.from_numpy(low), torch.from_numpy(high), None,
            noise=torch.tensor(noise),
        )
        # The same float32 expression: equal up to one ulp.
        np.testing.assert_array_max_ulp(ours.numpy(), np.asarray(ref), maxulp=1)
        assert (ours.abs() <= 2.0).all()


@pytest.mark.parametrize("n", [0, 3])
def test_one_hot_repair_matches_jax_nn_one_hot(n):
    idx = np.array([[1.0], [-1.0], [5.0], [0.0], [2.0], [2.7]], np.float32)
    ref = np.asarray(JaxOneHot(max_number_actions=n).apply(jnp.asarray(idx)))
    ours = OneHotActionRepresentation(max_number_actions=n).apply(torch.from_numpy(idx))
    assert ours.shape == ref.shape == (6, n) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)


# ---------------------------------------------------- the slice as a whole
LEARNERS = {
    "csac": (JaxCSAC, ContinuousSoftActorCritic),
    "ddpg": (JaxDDPG, DeepDeterministicPolicyGradient),
    "td3": (JaxTD3, TD3),
}


def _agents(name, n_envs=8, rounds=2, batch=16, capacity=64):
    jax_cls, cls = LEARNERS[name]
    kw = dict(training_rounds=rounds, batch_size=batch)
    jagent = JaxAgent(
        policy_learner=jax_cls(**kw), replay_buffer=JaxBuffer(capacity=capacity)
    ).for_env(JaxPendulum())
    tagent = PearlAgent(
        policy_learner=cls(**kw), replay_buffer=BasicReplayBuffer(capacity=capacity)
    ).for_env(Pendulum())
    return jagent, tagent


def test_csac_agent_acts_observes_and_learns_like_the_jax_agent():
    n, T, batch = 8, 6, 16
    rng = np.random.default_rng(0)
    theta = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    thdot = rng.uniform(-1, 1, n).astype(np.float32)
    t0 = np.zeros(n, np.int32)
    t0[2] = 197  # truncates on the third step
    obs = np.stack([np.cos(theta), np.sin(theta), thdot], -1)
    jagent, tagent = _agents("csac", n, batch=batch)
    jastate = jagent.init(jax.random.PRNGKey(0), 3, n, jnp.asarray(obs))
    tastate = tagent.init(0, 3, n, torch.from_numpy(obs), device="cpu")
    _carry_weights(jastate.learner, tastate.learner)
    assert tastate.available_mask is None and jastate.available_mask is None

    jenv, venv = JaxPendulum(), VectorEnv(Pendulum(), n, CPU)
    jstates = JaxPendulumState(jnp.asarray(theta), jnp.asarray(thdot), jnp.asarray(t0))
    tstates = PendulumState(torch.from_numpy(theta), torch.from_numpy(thdot), torch.from_numpy(t0))
    key = jax.random.PRNGKey(1)
    for step in range(T):
        key, k_act, k_env, k_obs = jax.random.split(key, 4)
        # Stochastic acting: JAX samples with normal(k_act, (n, 1)).
        noise = torch.tensor(np.asarray(jax.random.normal(k_act, (n, 1))))
        jastate, jchoice = jagent.act(jastate, k_act)
        tlearner, tchoice = tagent.policy_learner.act(
            tastate.learner, tagent.subjective_state(tastate), None, None, noise=noise
        )
        tastate = dataclasses.replace(tastate, learner=tlearner, last_action=tchoice)
        np.testing.assert_allclose(tchoice.action.numpy(), np.asarray(jchoice.action), rtol=1e-5, atol=1e-5)

        fth = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        fdot = rng.uniform(-1, 1, n).astype(np.float32)
        fobs = np.stack([np.cos(fth), np.sin(fth), fdot], -1)
        jfresh = JaxPendulumState(jnp.asarray(fth), jnp.asarray(fdot), jnp.zeros(n, jnp.int32))
        jnew, jres = jax.vmap(jenv.step)(jstates, jchoice.action, jax.random.split(k_env, n))
        jstates = jax_tree_select(jres.done, jfresh, jnew)
        jnext_obs = jax_tree_select(jres.done, jnp.asarray(fobs), jres.observation)
        tfresh = PendulumState(torch.from_numpy(fth), torch.from_numpy(fdot), torch.zeros(n, dtype=torch.int32))
        tstates, tres, tnext_obs = venv.step(tstates, tchoice.action, fresh=(tfresh, torch.from_numpy(fobs)))
        np.testing.assert_array_equal(tres.done.numpy(), np.asarray(jres.done))
        np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward), rtol=1e-5, atol=1e-5)
        jastate = jagent.observe(jastate, jres, jnext_obs, k_obs)
        tastate = tagent.observe(tastate, tres, tnext_obs)
    assert tres.done.sum() == 0 and int(tastate.replay.storage.truncated.sum()) == 1

    jrep, trep = jastate.replay, tastate.replay
    assert trep.size == int(jrep.size) == n * T and trep.cursor == int(jrep.cursor)
    for f in ("state", "next_state", "reward", "action"):
        ours, ref = getattr(trep.storage, f), np.asarray(getattr(jrep.storage, f))
        assert ours.shape == ref.shape and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    for f in ("terminated", "truncated", "action_index"):
        np.testing.assert_array_equal(getattr(trep.storage, f).numpy(), np.asarray(getattr(jrep.storage, f)))

    # One learn of two rounds: the JAX agent's sampled rows (pearl_agent.py:416,
    # policy_learner.py:182, replay_buffer.py:130) and its learner's draws.
    learn_key = jax.random.PRNGKey(7)
    k_l, _ = jax.random.split(learn_key)
    idx = [np.array(jax.random.randint(k, (batch,), 0, int(jrep.size)))
           for k in jax.random.split(k_l, 2)]
    lkey = jastate.learner.key
    jastate, jmetrics = jagent.learn(jastate, learn_key)
    learner, tl = tastate.learner, tagent.policy_learner
    tmetrics = []
    for r in range(2):
        noise = _learn_noise(lkey, batch)
        lkey = jax.random.split(lkey, 3)[0]
        rows = trep.storage
        tbatch = TransitionBatch(**{
            f.name: getattr(rows, f.name)[torch.from_numpy(idx[r]).long()]
            for f in dataclasses.fields(rows) if getattr(rows, f.name) is not None
        })
        learner, m = tl.learn_batch(learner, tbatch, noise=noise)
        tmetrics.append(m)
    for k in jmetrics:
        mean = np.mean([m[k].item() for m in tmetrics])
        np.testing.assert_allclose(mean, float(jmetrics[k]), err_msg=k, **TOL)
    _assert_states_close(jastate.learner, learner)


@pytest.mark.parametrize("name", list(LEARNERS))
def test_entry_points_run_continuous_control_on_cpu_at_a_tiny_size(name):
    n, spl, lpc, rounds, batch = 8, 2, 2, 2, 16
    jagent, tagent = _agents(name, n, rounds, batch)
    # PearlAgent.init: the JAX agent's replay layout, no mask.
    jastate = jagent.init(jax.random.PRNGKey(0), 3, n, jnp.zeros((n, 3)))
    tastate = tagent.init(0, 3, n, torch.zeros(n, 3), device="cpu")
    assert tastate.available_mask is None
    for f in dataclasses.fields(jastate.replay.storage):
        ref = getattr(jastate.replay.storage, f.name)
        ours = getattr(tastate.replay.storage, f.name)
        assert (ours is None) == (ref is None), f.name
        if ref is not None:
            assert tuple(ours.shape) == ref.shape and str(ours.dtype)[6:] == str(ref.dtype), f.name

    init_fn, run_fn = make_compiled_runner(
        tagent, Pendulum(), num_envs=n, steps_per_learn=spl, learns_per_call=lpc, device="cpu"
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, CPU)
    for _ in range(2):
        astate, env_states, stats = run_fn(astate, env_states, gen)
        assert np.isfinite(stats["reward_sum"].item()) and stats["reward_sum"].item() < 0
    pushed = 2 * spl * lpc * n
    storage = astate.replay.storage
    assert astate.replay.size == pushed and astate.learner.step == 2 * lpc * rounds
    actions = storage.action[:pushed]
    assert actions.shape == (pushed, 1) and actions.dtype == torch.float32
    assert torch.isfinite(actions).all() and (actions.abs() <= 2.0).all()
    assert (storage.action_index == 0).all() and storage.action_index.dtype == torch.int32
    assert env_states.theta.shape == (n,)

    res = online_learning(
        tagent, Pendulum(), num_envs=n, max_steps=4 * n, learn_every_k_steps=2,
        learning_starts=2 * n, seed=1, device="cpu",
    )
    assert res.total_steps == 4 * n and res.agent_state.learner.step == rounds
    again = online_learning(
        tagent, Pendulum(), num_envs=4, max_steps=8, exploit=True, learn=False,
        agent_state=res.agent_state, seed=2, device="cpu",
    )
    assert again.total_steps == 8 and again.agent_state.history_carry.shape == (4, 3)
