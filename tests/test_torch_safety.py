"""Reward-constrained safety, the env wrappers it needs and the agent's mask
and cost columns, in the PyTorch port, against the JAX package on the CPU:

- `SafetyWrapper`, `DynamicActionSpaceWrapper`, `PartialObservabilityWrapper`
  on given states, equal to JAX's; the safety wrapper's reward noise held by
  its mean and variance;
- the agent's `track_available_masks` and `store_cost` columns through the
  basic, deferred, on-policy and visual pushes;
- `RCSafetyModuleCostCriticContinuousAction._update_from_batch` at the same
  policy draws (continuous: the actor's normal noise; discrete: the Gumbel
  noise of the categorical), critic, target and lambda at both clip ends;
  `batch_transform`; `PearlAgent.learn_batch`'s order;
- the twins of the reference's `test_rc_safety_module_learns_lambda` and
  `test_dynamic_action_space_end_to_end`.

Tolerances: the RC update rtol 1e-4 / atol 1e-5 (one AdamW step of a float32
critic, summed in other orders); the wrappers exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.envs import Pendulum as JaxPendulum
from pearl_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from pearl_tpu.envs.wrappers import DynamicActionSpaceWrapper as JaxDynamic
from pearl_tpu.envs.wrappers import PartialObservabilityWrapper as JaxPartial
from pearl_tpu.envs.wrappers import SafetyWrapper as JaxSafety
from pearl_tpu.policy_learners.sequential_decision_making import (
    DeepDeterministicPolicyGradient as JaxDDPG,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.safety_modules import RCSafetyModuleCostCriticContinuousAction as JaxRC
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import (
    CartPole,
    CartPoleState,
    DynamicActionSpaceWrapper,
    PartialObservabilityWrapper,
    Pendulum,
    SafetyWrapper,
    SyntheticAtari,
    VectorEnv,
)
from pearl_tpu_torch.history_summarization_modules import (
    FrameRingHistorySummarization,
    LSTMHistorySummarization,
)
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    ContinuousSoftActorCritic,
    DeepDeterministicPolicyGradient,
    DeepQLearning,
    ProximalPolicyOptimization,
)
from pearl_tpu_torch.replay_buffers import (
    BasicReplayBuffer,
    OnPolicyReplayBuffer,
    TransitionBatch,
    VisualReplayBuffer,
)
from pearl_tpu_torch.safety_modules import RCSafetyModuleCostCriticContinuousAction
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import (
    load_flax_deterministic_actor_params,
    load_flax_twin_critic_params,
)
from tests.test_torch_actor_critic import _batch_data as pendulum_batch_data
from tests.test_torch_actor_critic import _learners as actor_critic_learners
from tests.test_torch_actor_critic import _port_leaves
from tests.test_torch_on_policy import _on_policy_learners, assert_leaves_close

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
B = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- wrappers
def _cartpole_states(seed, n=16):
    rng = np.random.default_rng(seed)
    physics = rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
    t = rng.integers(0, 40, n).astype(np.int32)
    action = rng.integers(0, 2, (n, 1)).astype(np.float32)
    return physics, t, action


def _jax_step(env, physics, t, action):
    """JAX's per-env step, vmapped over the given states."""
    state = JaxCartPoleState(physics=jnp.asarray(physics), t=jnp.asarray(t))
    keys = jax.random.split(jax.random.PRNGKey(0), physics.shape[0])
    return jax.vmap(env.step)(state, jnp.asarray(action), keys)


def _port_step(env, physics, t, action):
    state = CartPoleState(physics=torch.from_numpy(physics), t=torch.from_numpy(t))
    if isinstance(env, SafetyWrapper):
        state = env.reset(physics.shape[0], torch.Generator().manual_seed(0), CPU)[0]
        state = dataclasses.replace(
            state, env=CartPoleState(physics=torch.from_numpy(physics), t=torch.from_numpy(t))
        )
    return env.step(state, torch.from_numpy(action))


def test_wrappers_equal_jax_on_given_states():
    physics, t, action = _cartpole_states(0)
    cases = [
        (JaxPartial(env=JaxCartPole(), observed_indices=(0, 2)),
         PartialObservabilityWrapper(env=CartPole(), observed_indices=(0, 2))),
        (JaxDynamic(env=JaxCartPole(), interval=4, num_masked=1),
         DynamicActionSpaceWrapper(env=CartPole(), interval=4, num_masked=1)),
        (JaxSafety(env=JaxCartPole(), risky_fn=lambda o, a: o[0] > 0),
         SafetyWrapper(env=CartPole(), risky_fn=lambda o, a: o[:, 0] > 0)),
    ]
    for jenv, tenv in cases:
        _, jres = _jax_step(jenv, physics, t, action)
        _, tres = _port_step(tenv, physics, t, action)
        np.testing.assert_array_equal(tres.observation.numpy(), np.asarray(jres.observation))
        np.testing.assert_array_equal(tres.reward.numpy(), np.asarray(jres.reward))
        for field in ("cost", "available_actions_mask"):
            jv, tv = getattr(jres, field), getattr(tres, field)
            assert (jv is None) == (tv is None), field
            if tv is not None:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=field)
    partial = cases[0][1]
    assert partial.observation_dim == 2
    np.testing.assert_array_equal(
        partial.observation_space.high.numpy(), np.asarray(cases[0][0].observation_space.high)
    )
    state, obs = partial.reset(3, torch.Generator().manual_seed(0), CPU)
    assert obs.shape == (3, 2) and state.physics.shape == (3, 4)
    # Both mask phases appear and the shrunk one hides only the last action.
    mask = _port_step(cases[1][1], physics, t, action)[1].available_actions_mask
    assert mask[:, 0].all() and not mask[:, 1].all() and mask[:, 1].any()


def test_safety_wrapper_noise_has_its_mean_and_variance():
    """Risky steps gain mean + sigma * N(0, 1), one draw per env per step;
    safe steps gain nothing. 4096 envs x 8 steps, five-sigma bounds."""
    n, steps, mean, sigma = 4096, 8, 0.5, 2.0
    env = SafetyWrapper(
        env=CartPole(), risky_fn=lambda o, a: o[:, 0] > 0,
        noisy_reward_sigma=sigma, noisy_reward_mean=mean,
    )
    state, _ = env.reset(n, torch.Generator().manual_seed(0), CPU)
    bonus, safe = [], []
    for _ in range(steps):
        state, result = env.step(state, torch.zeros((n, 1)))
        risky = result.cost.bool()
        bonus.append(result.reward[risky] - 1.0)
        safe.append(result.reward[~risky] - 1.0)
        assert torch.equal(result.info["risky_sa"], result.cost)
    bonus, safe = torch.cat(bonus), torch.cat(safe)
    k = bonus.numel()
    assert k > 1000 and safe.numel() > 1000 and torch.all(safe == 0.0)
    assert abs(bonus.mean().item() - mean) < 5 * sigma / k**0.5
    assert abs(bonus.var().item() / sigma**2 - 1.0) < 5 * (2.0 / k) ** 0.5
    assert len(set(bonus[:50].tolist())) == 50  # a draw per env per step


# ---------------------------------------------------- mask and cost columns
def _masked_cost_env(env=None):
    inner = DynamicActionSpaceWrapper(env=env or CartPole(), interval=2, num_masked=1)
    return SafetyWrapper(env=inner, risky_fn=lambda o, a: o.flatten(1)[:, 0] > 0)


def _drive(agent, env, num_envs, steps, deferred=False):
    """`steps` act/step/observe rounds by hand; returns the final state and,
    per step, (mask at act time, the step's mask, its cost)."""
    agent = agent.for_env(env)
    venv = VectorEnv(env, num_envs, CPU)
    gen = make_generator(0, CPU)
    env_states, obs = venv.reset(gen)
    astate = agent.init(0, venv.observation_dim, num_envs, obs, device="cpu")
    seen, transitions = [], []
    for _ in range(steps):
        astate, choice = agent.act(astate, gen)
        curr = astate.available_mask.clone()
        chosen = curr[torch.arange(num_envs), choice.index.long()]
        assert chosen.all()
        env_states, result, next_obs = venv.step(env_states, choice.action, gen)
        seen.append((curr, result.available_actions_mask, result.cost))
        if deferred:
            astate, transition = agent.observe_deferred(astate, result, next_obs, gen)
            transitions.append(transition)
        else:
            astate = agent.observe(astate, result, next_obs, gen)
    if deferred:
        from pearl_tpu_torch.utils.pytree import tree_map

        flat = tree_map(lambda *xs: torch.cat(xs), *transitions)
        astate = dataclasses.replace(
            astate, replay=agent.replay_buffer.push(astate.replay, flat, gen)
        )
    return astate, seen


def _columns(storage):
    return storage.curr_available_mask, storage.next_available_mask, storage.cost


def _tiny_visual(num_envs):
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(
                input_shape=(20, 20, 4), time_major_stack=True, hidden_dims=(8,)
            ),
            training_rounds=1, batch_size=8,
            history_summarizer=FrameRingHistorySummarization(history_length=4),
        ),
        replay_buffer=VisualReplayBuffer(capacity=8 * num_envs, stack=4, num_envs=num_envs),
        track_available_masks=True, store_cost=True,
    )
    return agent, _masked_cost_env(SyntheticAtari(height=20, width=20, frames=1))


@pytest.mark.parametrize("path", ["basic", "deferred", "on_policy", "visual"])
def test_mask_and_cost_columns_reach_every_push(path):
    n, steps = 4, 6
    if path == "visual":
        agent, env = _tiny_visual(n)
    else:
        learner = (
            ProximalPolicyOptimization(training_rounds=1, batch_size=4)
            if path == "on_policy"
            else DeepQLearning(training_rounds=1, batch_size=4)
        )
        buffer = (
            OnPolicyReplayBuffer(capacity=steps * n, num_envs=n)
            if path == "on_policy"
            else BasicReplayBuffer(capacity=48)
        )
        agent = PearlAgent(
            policy_learner=learner, replay_buffer=buffer,
            track_available_masks=True, store_cost=True,
        )
        env = _masked_cost_env()
    astate, seen = _drive(agent, env, n, steps, deferred=path == "deferred")
    storage = astate.replay.storage
    if path == "visual":
        storage = storage["rest"]
    curr, nxt, cost = _columns(storage)
    assert curr.dtype == nxt.dtype == torch.bool and cost.dtype == torch.float32
    for i, (c, m, k) in enumerate(seen):
        rows = slice(i * n, (i + 1) * n)
        assert torch.equal(curr[rows], c) and torch.equal(nxt[rows], m)
        assert torch.equal(cost[rows], k)
    assert not torch.stack([m for _, m, _ in seen]).all()  # some action was masked
    assert any(k.any() for _, _, k in seen)


def test_columns_are_absent_unless_asked_for():
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=4),
        replay_buffer=BasicReplayBuffer(capacity=64),
    )
    astate, _ = _drive(agent, _masked_cost_env(), 4, 2)
    assert _columns(astate.replay.storage) == (None, None, None)


def test_dynamic_action_space_end_to_end():
    """The twin of the reference's test of the same name."""
    env = DynamicActionSpaceWrapper(env=CartPole(), interval=2, num_masked=1)
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=16),
        replay_buffer=BasicReplayBuffer(capacity=256),
        track_available_masks=True,
    )
    res = online_learning(
        agent, env, num_envs=4, max_steps=128, learn_every_k_steps=8, learning_starts=32,
        seed=0, device="cpu",
    )
    replay = res.agent_state.replay
    size = replay.size
    masks = replay.storage.next_available_mask[:size]
    assert (~masks[:, 1]).sum() > 0
    curr = replay.storage.curr_available_mask[:size]
    idx = replay.storage.action_index[:size].long()
    assert curr[torch.arange(size), idx].all()


# ---------------------------------------------------------------------- RC
def _rc_pair(obs_dim, space_pair, **kw):
    jrc, trc = JaxRC(batch_size=B, **kw), RCSafetyModuleCostCriticContinuousAction(
        batch_size=B, **kw
    )
    jspace, tspace = space_pair
    js = jrc.init(jax.random.PRNGKey(3), obs_dim, jspace, 1)
    ts = trc.init(torch.Generator().manual_seed(0), obs_dim, tspace, 1, CPU)
    load_flax_twin_critic_params(ts.critic_params, _np_tree(js.critic_params))
    load_flax_twin_critic_params(ts.critic_target_params, _np_tree(js.critic_target_params))
    return jrc, js, trc, ts


def _with_lambda(js, ts, lam):
    js = js.replace(lagrangian=jnp.asarray(lam, jnp.float32))
    return js, dataclasses.replace(ts, lagrangian=torch.tensor(lam, dtype=torch.float32))


def _assert_rc_close(js, ts):
    for mine, ref in ((ts.critic_params, js.critic_params),
                      (ts.critic_target_params, js.critic_target_params)):
        assert_leaves_close(_port_leaves(mine), ref, **TOL)
    np.testing.assert_allclose(ts.lagrangian.item(), float(js.lagrangian), **TOL)


def _continuous_case(seed):
    jl, jls, tl, tls = actor_critic_learners("csac_autotune")
    data = pendulum_batch_data(seed)
    data["cost"] = np.random.default_rng(seed + 7).random(B).astype(np.float32)
    return jl, jls, tl, tls, data, 3, (JaxPendulum().action_space, Pendulum().action_space)


def _discrete_case(seed):
    jl, jls, tl, tls, dim = _on_policy_learners("ppo", "mlp")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 3, B).astype(np.int32)

    def mask():
        m = rng.random((B, 3)) < 0.7
        m[np.arange(B), rng.integers(0, 3, B)] = True
        return m

    curr = mask()
    curr[np.arange(B), idx] = True
    data = dict(
        state=rng.normal(size=(B, dim)).astype(np.float32),
        action=idx[:, None].astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        next_state=rng.normal(size=(B, dim)).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.1,
        action_index=idx,
        curr_available_mask=curr,
        next_available_mask=mask(),
        cost=(rng.random(B) < 0.4).astype(np.float32),
    )
    return jl, jls, tl, tls, data, dim, (jl.action_space, tl.action_space)


def _rc_noise(key, continuous, action_width):
    """The draws JAX's update makes from its state key, by seam."""
    k_next, k_lam, _ = jax.random.split(key, 3)
    if continuous:
        draw = lambda k: torch.tensor(np.asarray(jax.random.normal(k, (B, action_width))))  # noqa: E731
    else:
        draw = lambda k: torch.tensor(np.asarray(jax.random.gumbel(k, (B, action_width))))  # noqa: E731
    return {"next": draw(k_next), "lambda": draw(k_lam)}


# lambda before the update, and the constraint: inside the box, pinned at 0
# by a large constraint, pinned at the upper bound from just below it.
LAMBDA_CASES = [(0.3, 0.1), (0.0, 5.0), (19.999, -5.0)]


@pytest.mark.parametrize("case", ["continuous", "discrete"])
@pytest.mark.parametrize("lam,constraint", LAMBDA_CASES)
def test_rc_update_matches_jax_at_the_same_draws(case, lam, constraint):
    make = _continuous_case if case == "continuous" else _discrete_case
    jl, jls, tl, tls, data, obs_dim, spaces = make(0)
    jrc, js, trc, ts = _rc_pair(obs_dim, spaces, constraint_value=constraint)
    js, ts = _with_lambda(js, ts, lam)
    update = jax.jit(lambda s, b: jrc._update_from_batch(s, b, jl, jls))
    width = 1 if case == "continuous" else 3
    for step in range(2):
        if step:
            data = make(step)[4]
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
        tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
        noise = _rc_noise(js.key, case == "continuous", width)
        js, jm = update(js, jbatch)
        ts, tm = trc._update_from_batch(ts, tbatch, tl, tls, noise=noise)
        _assert_rc_close(js, ts)
        np.testing.assert_allclose(
            tm["cost_critic_loss"].item(), float(jm["cost_critic_loss"]), **TOL
        )
        assert tm["lambda"] is ts.lagrangian and ts.lagrangian.dim() == 0
    if lam == 0.0:
        assert ts.lagrangian.item() == 0.0
    if lam > 19:
        assert ts.lagrangian.item() == 20.0


def test_rc_draws_from_its_own_generator_without_noise():
    jl, jls, tl, tls, data, obs_dim, spaces = _discrete_case(0)
    _, _, trc, ts = _rc_pair(obs_dim, spaces)
    tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
    state = ts.generator.get_state()
    ts2, metrics = trc._update_from_batch(ts, tbatch, tl, tls)
    assert not torch.equal(ts2.generator.get_state(), state)
    assert torch.isfinite(metrics["cost_critic_loss"])


def test_batch_transform_subtracts_lambda_times_cost():
    _, _, trc, ts = _rc_pair(3, (JaxPendulum().action_space, Pendulum().action_space))
    ts = dataclasses.replace(ts, lagrangian=torch.tensor(0.5))
    data = pendulum_batch_data(0)
    batch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
    assert trc.batch_transform(ts)(batch) is batch  # no cost column
    cost = torch.rand(B, generator=torch.Generator().manual_seed(1))
    out = trc.batch_transform(ts)(dataclasses.replace(batch, cost=cost))
    torch.testing.assert_close(out.reward, batch.reward - 0.5 * cost, rtol=0, atol=0)
    assert torch.equal(out.cost, cost)


def test_rc_refuses_a_summary_of_another_width_at_the_first_learn():
    """The reference sizes the cost critic from observation_dim and feeds it
    subjective states; the port keeps that sizing and says why it fails."""
    learner = ContinuousSoftActorCritic(
        training_rounds=1, batch_size=8,
        history_summarizer=LSTMHistorySummarization(history_length=2, hidden_dim=5, num_layers=1),
    )
    agent = PearlAgent(
        policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=64),
        safety_module=RCSafetyModuleCostCriticContinuousAction(batch_size=8), store_cost=True,
    )
    with pytest.raises(ValueError, match="observation_dim=3"):
        online_learning(
            agent, Pendulum(emit_torque_cost=True), num_envs=4, max_steps=128,
            learn_every_k_steps=8, learning_starts=16, seed=0, device="cpu",
        )


def test_agent_learn_batch_transforms_first_then_learner_then_safety_like_jax():
    """DDPG (no draws in its update, nor in the RC module's with its
    deterministic actor) under RC at lambda 0.5: the learner learns from
    reward - 0.5 * cost and the RC module from the same transformed batch."""
    jl = JaxDDPG(training_rounds=1, batch_size=B)
    tl = DeepDeterministicPolicyGradient(training_rounds=1, batch_size=B)
    jagent = JaxAgent(
        policy_learner=jl, replay_buffer=JaxBuffer(capacity=64),
        safety_module=JaxRC(batch_size=B), store_cost=True,
    ).for_env(JaxPendulum())
    tagent = PearlAgent(
        policy_learner=tl, replay_buffer=BasicReplayBuffer(capacity=64),
        safety_module=RCSafetyModuleCostCriticContinuousAction(batch_size=B), store_cost=True,
    ).for_env(Pendulum())
    jstate = jagent.init(jax.random.PRNGKey(0), 3, 1, jnp.zeros((1, 3)))
    tstate = tagent.init(0, 3, 1, torch.zeros((1, 3)), device="cpu")
    jls, tls = jstate.learner, tstate.learner
    load_flax_deterministic_actor_params(tls.actor_params, _np_tree(jls.actor_params))
    load_flax_deterministic_actor_params(tls.actor_target_params, _np_tree(jls.actor_target_params))
    load_flax_twin_critic_params(tls.critic_params, _np_tree(jls.critic_params))
    load_flax_twin_critic_params(tls.critic_target_params, _np_tree(jls.critic_target_params))
    js, ts = jstate.safety, tstate.safety
    load_flax_twin_critic_params(ts.critic_params, _np_tree(js.critic_params))
    load_flax_twin_critic_params(ts.critic_target_params, _np_tree(js.critic_target_params))
    js, ts = _with_lambda(js, ts, 0.5)
    jstate, tstate = jstate.replace(safety=js), dataclasses.replace(tstate, safety=ts)
    data = pendulum_batch_data(4)
    data["cost"] = np.random.default_rng(5).random(B).astype(np.float32)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
    jstate, jm = jax.jit(jagent.learn_batch)(jstate, jbatch)
    tstate, tm = tagent.learn_batch(tstate, tbatch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, **TOL)
    assert_leaves_close(_port_leaves(tstate.learner.critic_params), jstate.learner.critic_params,
                        **TOL)
    _assert_rc_close(jstate.safety, tstate.safety)
    # The caller's batch is left as it was.
    assert torch.equal(tbatch.reward, torch.from_numpy(data["reward"]))


def test_agent_learn_hands_the_transform_to_the_learner_then_updates_the_module():
    """Online: the learner learns from reward - lambda * cost (the same
    update as its `learn` given the module's transform, and another than
    without it), then the module updates from replay under the new state."""
    import copy

    agent = PearlAgent(
        policy_learner=DeepDeterministicPolicyGradient(training_rounds=2, batch_size=B),
        replay_buffer=BasicReplayBuffer(capacity=64),
        safety_module=RCSafetyModuleCostCriticContinuousAction(batch_size=B), store_cost=True,
    ).for_env(Pendulum())
    astate = agent.init(0, 3, 1, torch.zeros((1, 3)), device="cpu")
    data = pendulum_batch_data(6, n=64)
    data["cost"] = np.random.default_rng(7).random(64).astype(np.float32)
    batch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
    astate = dataclasses.replace(
        astate, replay=agent.replay_buffer.push(astate.replay, batch),
        safety=dataclasses.replace(astate.safety, lagrangian=torch.tensor(0.5)),
    )
    idx = torch.randint(0, 64, (2, B), generator=torch.Generator().manual_seed(0))
    learner, buffer, module = agent.policy_learner, agent.replay_buffer, agent.safety_module
    shaped, plain = copy.deepcopy(astate), copy.deepcopy(astate)
    critic0 = [p.clone() for p in astate.safety.critic_params.parameters()]

    after, metrics = agent.learn(astate, torch.Generator().manual_seed(1), indices=idx)
    ls_shaped, _, _ = learner.learn(
        shaped.learner, buffer, shaped.replay, None, indices=idx,
        batch_transform=module.batch_transform(shaped.safety),
    )
    ls_plain, _, _ = learner.learn(plain.learner, buffer, plain.replay, None, indices=idx)
    ours = list(after.learner.critic_params.parameters())
    assert all(torch.equal(a, b) for a, b in zip(ours, ls_shaped.critic_params.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(ours, ls_plain.critic_params.parameters()))
    assert {"cost_critic_loss", "lambda"} <= set(metrics)
    moved = after.safety.critic_params.parameters()
    assert all(not torch.equal(a, b) for a, b in zip(moved, critic0))


def test_rc_safety_module_learns_lambda():
    """The twin of the reference's test of the same name."""
    agent = PearlAgent(
        policy_learner=ContinuousSoftActorCritic(training_rounds=1, batch_size=32),
        replay_buffer=BasicReplayBuffer(capacity=1024),
        safety_module=RCSafetyModuleCostCriticContinuousAction(
            constraint_value=0.05, batch_size=32
        ),
        store_cost=True,
    )
    res = online_learning(
        agent, Pendulum(emit_torque_cost=True), num_envs=4, max_steps=256,
        learn_every_k_steps=8, learning_starts=64, seed=0, device="cpu",
    )
    s = res.agent_state.safety
    lam = s.lagrangian.item()
    assert np.isfinite(lam) and 0.0 <= lam <= 20.0
    assert all(torch.isfinite(p).all() for p in s.critic_params.parameters())
    assert res.agent_state.replay.storage.cost.max() > 0.0
