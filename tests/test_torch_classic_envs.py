"""MountainCar, ContinuousMountainCar, Acrobot and FrozenLake of the
PyTorch port (pearl_tpu_torch/envs) against the JAX package's
(pearl_tpu/envs): numpy-made states and actions through one step of each,
the JAX step under `jax.vmap`; FrozenLake's slip is fed JAX's own draws,
taken from the keys its step is given. Then the resets, and the slice as a
whole at a tiny size on the CPU: the headline agent on Acrobot (B1's plain
version) and on MountainCar through the runner, continuous SAC on
ContinuousMountainCar, and DQN and tabular Q on FrozenLake through
`online_learning`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs import classic as jax_classic
from pearl_tpu.envs import frozen_lake as jax_frozen
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import (
    Acrobot,
    AcrobotState,
    ContinuousMountainCar,
    FrozenLake,
    FrozenLakeState,
    MountainCar,
    MountainCarState,
)
from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    ContinuousSoftActorCritic,
    DeepQLearning,
    TabularQLearning,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.utils import make_generator

torch.set_num_threads(1)

# One float32 step of MountainCar: the same operations in the same order;
# only cos may differ by an ulp between XLA's and PyTorch's CPU versions.
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
B = 64


def _keys(seed, n=B):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_step(env, state, actions, seed=0):
    return jax.jit(jax.vmap(env.step))(state, jnp.asarray(actions), _keys(seed, len(actions)))


def _assert_result(res, jres, tol=STEP_TOL):
    np.testing.assert_allclose(res.observation.numpy(), np.asarray(jres.observation), **tol)
    np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward), **tol)
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jres.truncated))


# ---------------------------------------------------------------- MountainCar
def _mountain_car_cases(rng, actions_of):
    position = rng.uniform(-1.2, 0.6, B).astype(np.float32)
    velocity = rng.uniform(-0.07, 0.07, B).astype(np.float32)
    position[0], velocity[0] = -1.19, -0.05  # into the left wall: velocity to 0
    position[1], velocity[1] = 0.49, 0.05  # reaches the goal
    position[2], velocity[2] = 0.44, 0.05  # the continuous car's goal (0.45)
    velocity[3] = 0.069  # the speed limit after the push
    t = rng.integers(0, 150, B).astype(np.int32)
    t[4:8] = 199  # truncated this step
    t[1] = 199  # at the goal AND the horizon: terminated, not truncated
    return position, velocity, t, actions_of(rng)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_mountain_car_step_matches_jax(continuous):
    rng = np.random.default_rng(1)
    if continuous:
        env, jenv = ContinuousMountainCar(max_steps=200), jax_classic.ContinuousMountainCar(
            max_steps=200)
        position, velocity, t, actions = _mountain_car_cases(
            rng, lambda r: r.uniform(-1.5, 1.5, (B, 1)).astype(np.float32))
    else:
        env, jenv = MountainCar(), jax_classic.MountainCar()
        position, velocity, t, actions = _mountain_car_cases(
            rng, lambda r: r.integers(0, 3, (B, 1)).astype(np.float32))
    jstate = jax_classic.MountainCarState(
        position=jnp.asarray(position), velocity=jnp.asarray(velocity), t=jnp.asarray(t))
    jnew, jres = _jax_step(jenv, jstate, actions)
    state = MountainCarState(torch.from_numpy(position), torch.from_numpy(velocity),
                             torch.from_numpy(t))
    new, res = env.step(state, torch.from_numpy(actions))
    _assert_result(res, jres)
    np.testing.assert_allclose(new.position.numpy(), np.asarray(jnew.position), **STEP_TOL)
    np.testing.assert_allclose(new.velocity.numpy(), np.asarray(jnew.velocity), **STEP_TOL)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    assert new.t.dtype == torch.int32
    assert new.velocity[0] == 0.0 and res.terminated[1] and not res.truncated[1]
    assert res.truncated[4:8].all()


# -------------------------------------------------------------------- Acrobot
# One RK4 step of dt = 0.2 evaluates the dynamics four times, each with seven
# sines and cosines, which XLA and PyTorch round differently by up to an ulp.
# At the speeds a random-policy episode reaches (|dtheta1| up to about 4.4,
# |dtheta2| up to about 7.2 over 500 steps of 512 envs) the two steps agree
# to a few ulps (measured: 4.8e-7 at most): held to rtol/atol 1e-6. Near the
# speed limits (4 pi, 9 pi) the dtheta^2 terms amplify rounding: there JAX's
# own float32 step is up to 1e-3 from its float64 step, so the port is held
# to that float64 step no further than 3 times JAX's float32 step is
# (measured: 2.1 times at most). Only one step is held: the system is
# chaotic, and a long rollout in two libraries drifts apart.
ACROBOT_TOL = dict(rtol=1e-6, atol=1e-6)
_ANGLES = ("theta1", "theta2", "dtheta1", "dtheta2")


def _acrobot_cases(speeds, n=256):
    rng = np.random.default_rng(2)
    theta = rng.uniform(-math.pi, math.pi, (n, 2)).astype(np.float32)
    dtheta = np.stack([rng.uniform(-speeds[0], speeds[0], n),
                       rng.uniform(-speeds[1], speeds[1], n)], -1).astype(np.float32)
    theta[0] = [math.pi - 0.01, 0.0]  # swung up: terminates
    theta[2] = [3.1, 3.1]  # the wrap crosses pi
    t = rng.integers(0, 499, n).astype(np.int32)
    t[3:6] = 499
    actions = rng.integers(0, 3, (n, 1)).astype(np.float32)
    return theta, dtheta, t, actions


def _acrobot_steps(theta, dtheta, t, actions):
    """The JAX step in float32 and in float64, and the port's (float32)."""
    def jax_step(dtype):
        state = jax_classic.AcrobotState(
            *(jnp.asarray(a, dtype) for a in (theta[:, 0], theta[:, 1], dtheta[:, 0],
                                              dtheta[:, 1])), t=jnp.asarray(t))
        new, res = _jax_step(jax_classic.Acrobot(), state, actions)
        return {k: np.asarray(getattr(new, k)) for k in _ANGLES}, res

    jnew, jres = jax_step(jnp.float32)
    with jax.enable_x64(True):
        exact, _ = jax_step(jnp.float64)
    state = AcrobotState(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        theta[:, 0], theta[:, 1], dtheta[:, 0], dtheta[:, 1])), torch.from_numpy(t))
    new, res = Acrobot().step(state, torch.from_numpy(actions))
    return jnew, jres, exact, {k: getattr(new, k).numpy() for k in _ANGLES}, res


def _angle_gap(a, b, name):
    """|a - b|, an angle's across the wrap at +-pi."""
    d = a - b
    return np.abs(np.remainder(d + math.pi, 2 * math.pi) - math.pi if name[0] == "t" else d)


def test_acrobot_step_matches_jax_at_an_episodes_speeds():
    jnew, jres, _, new, res = _acrobot_steps(*_acrobot_cases((4.5, 7.5)))
    for name in _ANGLES:
        bound = ACROBOT_TOL["atol"] + ACROBOT_TOL["rtol"] * np.abs(jnew[name])
        assert (_angle_gap(new[name], jnew[name], name) <= bound).all(), name
    np.testing.assert_allclose(res.observation.numpy(), np.asarray(jres.observation),
                               **ACROBOT_TOL)
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jres.truncated))
    np.testing.assert_array_equal(res.reward.numpy(), np.asarray(jres.reward))
    assert res.terminated[0] and res.truncated[3:6].all() and res.reward[0] == 0.0


def test_acrobot_step_at_the_speed_limits_is_as_exact_as_jax():
    theta, dtheta, t, actions = _acrobot_cases((4 * math.pi, 9 * math.pi))
    dtheta[1] = [4 * math.pi, 9 * math.pi]  # at both limits: the clamp holds them
    jnew, jres, exact, new, res = _acrobot_steps(theta, dtheta, t, actions)
    for name in _ANGLES:
        port_err = _angle_gap(new[name], exact[name], name).max()
        jax_err = _angle_gap(jnew[name], exact[name], name).max()
        assert port_err <= 1e-6 + 3 * jax_err, (name, port_err, jax_err)
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jres.truncated))
    assert (np.abs(new["dtheta1"]) <= np.float32(4 * math.pi)).all()
    assert (np.abs(new["dtheta2"]) <= np.float32(9 * math.pi)).all()
    assert (np.abs(new["theta1"]) <= math.pi).all()


def test_acrobot_angle_wrap_is_a_floor_mod():
    """The wrap ((x + pi) % 2 pi) - pi of a negative angle rounds toward
    -inf as JAX's `%` does (torch.fmod would keep the sign of x)."""
    x = np.array([-7.0, -3.5, -math.pi, 0.0, 3.5, 7.0, 10.0], np.float32)
    jax_wrap = np.asarray(((jnp.asarray(x) + jnp.pi) % (2 * jnp.pi)) - jnp.pi)
    got = ((torch.from_numpy(x) + math.pi) % (2 * math.pi)) - math.pi
    np.testing.assert_array_equal(got.numpy(), jax_wrap)
    assert (got >= -math.pi).all() and (got < math.pi).all()


# ----------------------------------------------------------------- FrozenLake
def _frozen_cases(n=B):
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 16, n).astype(np.int32)
    pos[:4] = [0, 3, 12, 15]  # the four corners: moves into the walls clamp
    pos[4:6] = [14, 11]  # next to the goal; 11 is a hole
    t = rng.integers(0, 99, n).astype(np.int32)
    t[6:10] = 99  # truncated unless terminated
    actions = rng.integers(0, 4, (n, 1)).astype(np.float32)
    actions[:4, 0] = [0, 2, 1, 2]  # left, right, down, right at the corners
    actions[4, 0] = 2  # onto the goal
    return pos, t, actions


@pytest.mark.parametrize("slippery", [False, True], ids=["still", "slippery"])
@pytest.mark.parametrize("one_hot", [True, False], ids=["one_hot", "index"])
def test_frozen_lake_step_matches_jax_with_its_draws(slippery, one_hot):
    pos, t, actions = _frozen_cases()
    jenv = jax_frozen.FrozenLake(slippery=slippery, one_hot_obs=one_hot)
    keys = _keys(4)
    jnew, jres = jax.jit(jax.vmap(jenv.step))(
        jax_frozen.FrozenLakeState(pos=jnp.asarray(pos), t=jnp.asarray(t)),
        jnp.asarray(actions), keys)
    # The slip of each env's step, from the key that step is given.
    slip = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), -1, 2))(keys))
    assert set(np.unique(slip)) == {-1, 0, 1}
    env = FrozenLake(slippery=slippery, one_hot_obs=one_hot)
    state = FrozenLakeState(pos=torch.from_numpy(pos), t=torch.from_numpy(t))
    new, res = env._transition(state, torch.from_numpy(actions),
                               torch.from_numpy(slip.copy()) if slippery else None)
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(jnew.pos))
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    np.testing.assert_array_equal(res.observation.numpy(), np.asarray(jres.observation))
    np.testing.assert_array_equal(res.reward.numpy(), np.asarray(jres.reward))
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jres.truncated))
    assert new.pos.dtype == torch.int32 and new.t.dtype == torch.int32
    if not slippery:
        assert list(new.pos[:5]) == [0, 3, 12, 15, 15] and res.reward[4] == 1.0


def test_frozen_lake_takes_an_action_out_of_range_as_jax():
    """jnp indexing: -2 counts from the end (right), 7 and 4 clamp to 3 (up)."""
    pos = np.array([1, 6, 9, 10], np.int32)
    actions = np.array([[-2.0], [7.0], [4.0], [-1.0]], np.float32)
    t = np.zeros(4, np.int32)
    jenv = jax_frozen.FrozenLake(slippery=False)
    jnew, _ = jax.jit(jax.vmap(jenv.step))(
        jax_frozen.FrozenLakeState(pos=jnp.asarray(pos), t=jnp.asarray(t)),
        jnp.asarray(actions), _keys(0, 4))
    new, _ = FrozenLake(slippery=False).step(
        FrozenLakeState(pos=torch.from_numpy(pos), t=torch.from_numpy(t)),
        torch.from_numpy(actions))
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(jnew.pos))


def test_frozen_lake_slip_draws_and_spaces():
    env = FrozenLake()
    gen = make_generator(0, "cpu")
    state, obs = env.reset(4096, gen, "cpu")
    assert obs.shape == (4096, 16) and (obs[:, 0] == 1).all() and state.generator is gen
    # Action 1 (down) from the start: down, or a slip to left (stay) or right.
    new, res = env.step(state, torch.ones((4096, 1)))
    counts = torch.bincount(new.pos.long(), minlength=16)
    assert set(torch.nonzero(counts).flatten().tolist()) == {0, 1, 4}
    assert (counts[[0, 1, 4]].float() / 4096 - 1 / 3).abs().max() < 0.03
    index_env = FrozenLake(one_hot_obs=False)
    assert index_env.observation_dim == 1 and index_env.observation_space.n == 16
    assert env.observation_dim == 16 and env.max_episode_steps == 100


# --------------------------------------------------------------------- resets
@pytest.mark.parametrize("env,low,high", [
    (MountainCar(), [-0.6, 0.0], [-0.4, 0.0]),
    (ContinuousMountainCar(), [-0.6, 0.0], [-0.4, 0.0]),
    (Acrobot(), None, None),
], ids=["mountain_car", "continuous_mountain_car", "acrobot"])
def test_classic_resets_draw_the_reference_box(env, low, high):
    state, obs = env.reset(4096, make_generator(0, "cpu"), "cpu")
    assert obs.shape == (4096, env.observation_dim) and obs.dtype == torch.float32
    assert (state.t == 0).all() and state.t.dtype == torch.int32
    if isinstance(env, Acrobot):
        angles = torch.stack([state.theta1, state.theta2, state.dtheta1, state.dtheta2], -1)
        assert (angles >= -0.1).all() and (angles < 0.1).all()
        assert angles.min() < -0.09 and angles.max() > 0.09
        np.testing.assert_allclose(obs[:, 0].numpy(), np.cos(state.theta1.numpy()), rtol=1e-6)
    else:
        assert (obs >= torch.tensor(low)).all() and (obs <= torch.tensor(high)).all()
        assert obs[:, 0].min() < -0.59 and obs[:, 0].max() > -0.41


# --------------------------------------------------- the slice at a tiny size
def _headline_agent():
    return PearlAgent(
        policy_learner=DeepQLearning(q_network=MultiHeadQValueNetwork(), training_rounds=1,
                                     batch_size=64),
        replay_buffer=BasicReplayBuffer(capacity=64 * 8 * 4),
    )


@pytest.mark.parametrize("env,obs_dim", [(Acrobot(), 6), (MountainCar(), 2)],
                         ids=["acrobot", "mountain_car"])
def test_headline_runner_on_classic_control_at_a_tiny_size(env, obs_dim):
    """bench.py's headline agent on Acrobot (6 -> 64 -> 64 -> 3) and
    MountainCar (2 -> ... -> 3) at 64 envs through the runner, B1's plain
    version on the CPU: every action in {0, 1, 2}, a reward of -1 a step
    until the goal, finite Q values."""
    agent = _headline_agent()
    init_fn, run_fn = make_compiled_runner(agent, env, num_envs=64, steps_per_learn=8,
                                           learns_per_call=2, device="cpu")
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cpu")
    astate, env_states, stats = run_fn(astate, env_states, gen)
    assert astate.replay.size == 2 * 8 * 64
    index = astate.replay.storage.action_index[:astate.replay.size]
    assert ((index >= 0) & (index <= 2)).all() and len(index.unique()) == 3
    assert stats["reward_sum"].item() <= 0 and stats["reward_sum"].item() >= -2 * 8 * 64
    q = astate.learner.params(torch.zeros((5, obs_dim)))
    assert q.shape == (5, 3) and torch.isfinite(q).all()


def test_continuous_sac_on_continuous_mountain_car_at_a_tiny_size():
    agent = PearlAgent(
        policy_learner=ContinuousSoftActorCritic(training_rounds=1, batch_size=32),
        replay_buffer=BasicReplayBuffer(capacity=1024),
    )
    init_fn, run_fn = make_compiled_runner(agent, ContinuousMountainCar(), num_envs=16,
                                           steps_per_learn=4, learns_per_call=2, device="cpu")
    astate, env_states = init_fn(0)
    astate, env_states, stats = run_fn(astate, env_states, make_generator(0, "cpu"))
    actions = astate.replay.storage.action[:astate.replay.size]
    assert (actions.abs() <= 1.0).all() and torch.isfinite(stats["reward_sum"])


def test_frozen_lake_dqn_and_tabular_q_drive_online_learning_at_a_tiny_size():
    dqn = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=16,
                                     exploration=EGreedyExploration(epsilon=0.5)),
        replay_buffer=BasicReplayBuffer(capacity=1024),
    )
    res = online_learning(dqn, FrozenLake(slippery=False), num_envs=8, max_steps=8 * 40,
                          learn_every_k_steps=2, learning_starts=32, seed=0, device="cpu")
    assert res.total_steps == 320 and len(res.episode_returns) > 0
    assert set(np.unique(res.episode_returns)) <= {0.0, 1.0}
    tabular = PearlAgent(
        policy_learner=TabularQLearning(learning_rate=0.5,
                                        exploration=EGreedyExploration(epsilon=0.3)),
        replay_buffer=BasicReplayBuffer(capacity=8),
    )
    res = online_learning(tabular, FrozenLake(slippery=False), num_envs=8, max_steps=8 * 50,
                          learn_every_k_steps=1, seed=0, device="cpu")
    q = res.agent_state.learner.q_table
    assert q.shape == (16, 4) and torch.isfinite(q).all()


@pytest.mark.cuda
def test_classic_resets_and_steps_make_no_host_sync_on_the_card():
    """A reset and a step of each env here, on the card, under
    `set_sync_debug_mode("error")`: the vector env resets a whole batch at
    every step, so neither may sync the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = make_generator(0, "cuda")
    for env in (MountainCar(), ContinuousMountainCar(), Acrobot(), FrozenLake(),
                FrozenLake(one_hot_obs=False)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, obs = env.reset(1024, gen, "cuda")
            action = torch.zeros((1024, 1), device="cuda")
            env.step(state, action)
        finally:
            torch.cuda.set_sync_debug_mode(0)
