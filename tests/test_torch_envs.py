"""CartPole, Pendulum, SyntheticAtari and the vector env of the PyTorch port
(pearl_tpu_torch/envs) against the JAX package's (pearl_tpu/envs): the same
numpy-made states and actions give the same next state, reward, terminated
and truncated, and the auto-reset keeps the terminal observation in the
result while the next observation comes from the given reset states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs.cartpole import CartPole as JaxCartPole
from pearl_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from pearl_tpu.envs.pendulum import Pendulum as JaxPendulum
from pearl_tpu.envs.pendulum import PendulumState as JaxPendulumState
from pearl_tpu.envs.pendulum import _angle_normalize as jax_angle_normalize
from pearl_tpu.envs.synthetic_visual import SyntheticAtari as JaxSyntheticAtari
from pearl_tpu.envs.synthetic_visual import SyntheticAtariState as JaxSyntheticAtariState
from pearl_tpu.utils.pytree import tree_select as jax_tree_select
from pearl_tpu_torch.envs import (
    CartPole,
    CartPoleState,
    Pendulum,
    PendulumState,
    SyntheticAtari,
    SyntheticAtariState,
    VectorEnv,
)
from pearl_tpu_torch.envs.pendulum import _angle_normalize
from pearl_tpu_torch.utils import make_generator

torch.set_num_threads(1)

# One float32 step: the same operations in the same order; only sin/cos may
# differ by an ulp between XLA's and PyTorch's CPU implementations.
STEP_TOL = dict(rtol=1e-6, atol=1e-7)


def _jax_step(physics, t, actions):
    env = JaxCartPole()
    state = JaxCartPoleState(physics=jnp.asarray(physics), t=jnp.asarray(t))
    keys = jax.random.split(jax.random.PRNGKey(0), physics.shape[0])
    new_state, result = jax.vmap(env.step)(state, jnp.asarray(actions), keys)
    return new_state, result


def _cases():
    rng = np.random.default_rng(0)
    B = 64
    physics = rng.uniform(-0.05, 0.05, (B, 4)).astype(np.float32)
    # Rows 0-3 cross a threshold this step by a wide margin.
    physics[0] = [2.39, 1.0, 0.0, 0.0]  # x leaves +2.4
    physics[1] = [-2.39, -1.0, 0.0, 0.0]  # x leaves -2.4
    physics[2] = [0.0, 0.0, 0.205, 1.0]  # theta leaves +12 degrees
    physics[3] = [0.0, 0.0, -0.205, -1.0]
    t = rng.integers(0, 400, B).astype(np.int32)
    t[4:8] = 499  # truncated this step
    t[0] = 499  # terminated AND at the horizon: terminated, not truncated
    actions = rng.integers(0, 2, (B, 1)).astype(np.float32)
    return physics, t, actions


def test_cartpole_step_matches_jax():
    physics, t, actions = _cases()
    jax_state, jax_res = _jax_step(physics, t, actions)
    state, res = CartPole().step(
        CartPoleState(torch.from_numpy(physics), torch.from_numpy(t)), torch.from_numpy(actions)
    )
    np.testing.assert_allclose(state.physics.numpy(), np.asarray(jax_state.physics), **STEP_TOL)
    np.testing.assert_array_equal(state.t.numpy(), np.asarray(jax_state.t))
    np.testing.assert_allclose(res.observation.numpy(), np.asarray(jax_res.observation), **STEP_TOL)
    np.testing.assert_array_equal(res.reward.numpy(), np.ones(64, np.float32))
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jax_res.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jax_res.truncated))
    assert res.terminated[:4].all() and not res.terminated[4:8].any()
    assert res.truncated[4:8].all() and not res.truncated[0]


def test_cartpole_rollout_matches_jax():
    # 40 steps from the same start under a fixed action sequence; the
    # dynamics amplify the per-step ulp differences a little.
    rng = np.random.default_rng(1)
    physics = rng.uniform(-0.05, 0.05, (16, 4)).astype(np.float32)
    t = np.zeros(16, np.int32)
    env = CartPole()
    state = CartPoleState(torch.from_numpy(physics), torch.from_numpy(t))
    jax_physics, jax_t = physics, t
    for _ in range(40):
        actions = rng.integers(0, 2, (16, 1)).astype(np.float32)
        state, _ = env.step(state, torch.from_numpy(actions))
        jax_state, _ = _jax_step(jax_physics, jax_t, actions)
        jax_physics, jax_t = np.asarray(jax_state.physics), np.asarray(jax_state.t)
    np.testing.assert_allclose(state.physics.numpy(), jax_physics, rtol=1e-5, atol=1e-6)


def test_vector_env_auto_reset_with_given_reset_states():
    physics, t, actions = _cases()
    rng = np.random.default_rng(2)
    fresh_physics = rng.uniform(-0.05, 0.05, physics.shape).astype(np.float32)
    fresh_t = np.zeros_like(t)

    jax_new, jax_res = _jax_step(physics, t, actions)
    jax_fresh = JaxCartPoleState(physics=jnp.asarray(fresh_physics), t=jnp.asarray(fresh_t))
    jax_next_states = jax_tree_select(jax_res.done, jax_fresh, jax_new)
    jax_next_obs = jax_tree_select(jax_res.done, jax_fresh.physics, jax_res.observation)

    venv = VectorEnv(CartPole(), 64, torch.device("cpu"))
    fresh = (
        CartPoleState(torch.from_numpy(fresh_physics), torch.from_numpy(fresh_t)),
        torch.from_numpy(fresh_physics),
    )
    next_states, res, next_obs = venv.step(
        CartPoleState(torch.from_numpy(physics), torch.from_numpy(t)),
        torch.from_numpy(actions),
        fresh=fresh,
    )
    np.testing.assert_allclose(next_states.physics.numpy(), np.asarray(jax_next_states.physics), **STEP_TOL)
    np.testing.assert_array_equal(next_states.t.numpy(), np.asarray(jax_next_states.t))
    np.testing.assert_allclose(next_obs.numpy(), np.asarray(jax_next_obs), **STEP_TOL)
    done = res.done.numpy()
    assert done[:8].all()
    # The result keeps the terminal observation; the next observation and
    # state restart from the given reset states where done.
    np.testing.assert_array_equal(next_obs.numpy()[done], fresh_physics[done])
    np.testing.assert_array_equal(next_states.t.numpy()[done], 0)
    assert not np.allclose(res.observation.numpy()[done], fresh_physics[done])
    np.testing.assert_array_equal(next_obs.numpy()[~done], res.observation.numpy()[~done])


def test_vector_env_reset_draws_the_reference_box():
    venv = VectorEnv(CartPole(), 4096, torch.device("cpu"))
    states, obs = venv.reset(make_generator(0, torch.device("cpu")))
    assert obs.shape == (4096, 4) and obs.dtype == torch.float32
    assert (obs >= -0.05).all() and (obs < 0.05).all()
    assert (states.t == 0).all() and states.t.dtype == torch.int32
    # Seeded: the same generator seed gives the same reset.
    _, again = venv.reset(make_generator(0, torch.device("cpu")))
    torch.testing.assert_close(obs, again, rtol=0, atol=0)
    assert CartPole().observation_dim == 4 and CartPole().action_space.n == 2


def _atari_case(B=16, seed=0):
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 6.28, B).astype(np.float32)
    t = rng.integers(0, 100, B).astype(np.int32)
    t[:3] = 127  # truncated this step (episode_len 128)
    actions = rng.integers(0, 6, (B, 1)).astype(np.float32)
    # Half the envs take the rewarded action.
    target = (np.floor(phase * np.float32(10.0)).astype(np.int32) + t) % 6
    actions[::2, 0] = target[::2]
    return phase, t, actions


@pytest.mark.parametrize(
    "frames,tdtype,jdtype", [(1, None, None), (4, None, None), (1, torch.bfloat16, jnp.bfloat16)]
)
def test_synthetic_atari_step_matches_jax(frames, tdtype, jdtype):
    phase, t, actions = _atari_case()
    kw = dict(height=20, width=18, frames=frames)
    jenv, tenv = JaxSyntheticAtari(obs_dtype=jdtype, **kw), SyntheticAtari(obs_dtype=tdtype, **kw)
    jstate = JaxSyntheticAtariState(phase=jnp.asarray(phase), t=jnp.asarray(t))
    keys = jax.random.split(jax.random.PRNGKey(0), len(phase))
    jnew, jres = jax.vmap(jenv.step)(jstate, jnp.asarray(actions), keys)
    tnew, tres = tenv.step(
        SyntheticAtariState(torch.from_numpy(phase), torch.from_numpy(t)), torch.from_numpy(actions)
    )
    assert tres.observation.shape == (16, 20 * 18 * frames) == jres.observation.shape
    assert tres.observation.dtype == (tdtype or torch.float32)
    # The sine's argument is summed in float32 in the same order; XLA's and
    # PyTorch's CPU sin may differ by an ulp of the value (atol 2e-7 near 0),
    # and the cast to bfloat16 can turn that into one bfloat16 ulp (2^-8).
    want = np.asarray(jres.observation.astype(jnp.float32))
    tol = dict(rtol=2.0**-8, atol=2.0**-16) if tdtype else dict(rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(tres.observation.float().numpy(), want, **tol)
    if tdtype:
        assert (tres.observation.float().numpy() == want).mean() > 0.99
    np.testing.assert_array_equal(tres.reward.numpy(), np.asarray(jres.reward))
    assert tres.reward[::2].eq(1.0).all() and tres.reward.dtype == torch.float32
    np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
    np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
    assert tres.truncated[:3].all() and not tres.truncated[3:].any() and not tres.terminated.any()
    np.testing.assert_array_equal(tnew.t.numpy(), np.asarray(jnew.t))
    np.testing.assert_array_equal(tnew.phase.numpy(), phase)


def test_synthetic_atari_reset_and_spaces():
    env = SyntheticAtari(height=12, width=10, frames=1)
    cpu = torch.device("cpu")
    state, obs = env.reset(4096, make_generator(0, cpu), cpu)
    assert obs.shape == (4096, 120) and obs.dtype == torch.float32
    assert (state.phase >= 0).all() and (state.phase < 6.28).all() and state.phase.std() > 1.0
    assert (state.t == 0).all() and state.t.dtype == torch.int32
    _, again = env.reset(4096, make_generator(0, cpu), cpu)
    assert torch.equal(obs, again)  # seeded
    # The reset observation is the grid at t = 0 of the JAX env.
    jobs = jax.vmap(JaxSyntheticAtari(height=12, width=10, frames=1)._obs)(
        JaxSyntheticAtariState(phase=jnp.asarray(state.phase.numpy()), t=jnp.zeros(4096, jnp.int32))
    )
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-6, atol=2e-7)
    jenv = JaxSyntheticAtari()
    full = SyntheticAtari()
    assert full.observation_dim == jenv.observation_space.shape[-1] == 84 * 84 * 4
    assert full.action_space.n == jenv.action_space.n == 6
    assert full.max_episode_steps == 128


def test_vector_env_auto_resets_synthetic_atari():
    phase, t, actions = _atari_case()
    env = SyntheticAtari(height=8, width=8, frames=1)
    venv = VectorEnv(env, 16, torch.device("cpu"))
    fresh_state = SyntheticAtariState(torch.full((16,), 1.5), torch.zeros(16, dtype=torch.int32))
    fresh_obs = env._obs(fresh_state)
    next_states, res, next_obs = venv.step(
        SyntheticAtariState(torch.from_numpy(phase), torch.from_numpy(t)),
        torch.from_numpy(actions),
        fresh=(fresh_state, fresh_obs),
    )
    done = res.done
    assert done[:3].all() and not done[3:].any()
    assert (next_states.t[:3] == 0).all() and (next_states.phase[:3] == 1.5).all()
    assert torch.equal(next_obs[:3], fresh_obs[:3]) and torch.equal(next_obs[3:], res.observation[3:])
    assert not torch.equal(res.observation[:3], fresh_obs[:3])  # the terminal frame stays


# Pendulum: sin and cos of XLA and of PyTorch may differ by an ulp, which
# the step's products carry on; atol 1e-5 as values reach 8 (speed) and 16
# (cost).
PENDULUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_pendulum_step(theta, theta_dot, t, actions, env=None, step_fn=None):
    step_fn = step_fn or jax.vmap((env or JaxPendulum()).step)
    state = JaxPendulumState(jnp.asarray(theta), jnp.asarray(theta_dot), jnp.asarray(t))
    keys = jax.random.split(jax.random.PRNGKey(0), len(theta))
    return step_fn(state, jnp.asarray(actions), keys)


def _pendulum_case(B=64, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-3 * np.pi, 3 * np.pi, B).astype(np.float32)  # beyond +-pi too
    theta_dot = rng.uniform(-9, 9, B).astype(np.float32)  # some beyond max_speed
    t = rng.integers(0, 199, B).astype(np.int32)
    t[:4] = 199  # truncated this step
    actions = rng.uniform(-3, 3, (B, 1)).astype(np.float32)  # clamped to +-2
    return theta, theta_dot, t, actions


@pytest.mark.parametrize("emit_torque_cost", [False, True])
def test_pendulum_step_matches_jax(emit_torque_cost):
    theta, theta_dot, t, actions = _pendulum_case()
    jnew, jres = _jax_pendulum_step(
        theta, theta_dot, t, actions, JaxPendulum(emit_torque_cost=emit_torque_cost)
    )
    new, res = Pendulum(emit_torque_cost=emit_torque_cost).step(
        PendulumState(torch.from_numpy(theta), torch.from_numpy(theta_dot), torch.from_numpy(t)),
        torch.from_numpy(actions),
    )
    np.testing.assert_allclose(new.theta.numpy(), np.asarray(jnew.theta), **PENDULUM_TOL)
    np.testing.assert_allclose(new.theta_dot.numpy(), np.asarray(jnew.theta_dot), **PENDULUM_TOL)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    assert res.observation.shape == (64, 3) and res.observation.dtype == torch.float32
    np.testing.assert_allclose(res.observation.numpy(), np.asarray(jres.observation), **PENDULUM_TOL)
    np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward), **PENDULUM_TOL)
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jres.truncated))
    assert res.truncated[:4].all() and not res.truncated[4:].any() and not res.terminated.any()
    assert (new.theta_dot.abs() <= 8.0).all()
    if emit_torque_cost:
        np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost), **PENDULUM_TOL)
        assert (res.cost <= 1.0).all()  # the torque is clamped before the cost
    else:
        assert res.cost is None and jres.cost is None


def test_pendulum_angle_normalize_is_a_floor_mod():
    x = np.float32([np.pi, -np.pi, 3 * np.pi, -3 * np.pi, 2 * np.pi, -2 * np.pi, 0.0,
                    4.0, -4.0, 10.5, -10.5, 1e3, -1e3, 3.1, -3.1])
    ours = _angle_normalize(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_angle_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert (ours >= -np.float32(np.pi)).all() and (ours < np.float32(np.pi)).all()
    # fmod would keep the sign of a negative argument: -4 -> -4 + 2pi, not -4.
    np.testing.assert_allclose(ours[8], -4.0 + 2 * np.pi, atol=1e-5)


def test_pendulum_rollout_across_truncation_matches_jax():
    # 250 steps under random torques with the vector env's auto-reset to
    # given reset states: every env truncates at step 200 and restarts. The
    # dynamics are chaotic and would amplify the per-step ulp differences,
    # so each JAX step starts from the port's state and is held at 1e-5.
    B = 16
    rng = np.random.default_rng(3)
    theta = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    theta_dot = rng.uniform(-1, 1, B).astype(np.float32)
    fresh_theta = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    fresh_dot = rng.uniform(-1, 1, B).astype(np.float32)
    venv = VectorEnv(Pendulum(), B, torch.device("cpu"))
    fresh_state = PendulumState(
        torch.from_numpy(fresh_theta), torch.from_numpy(fresh_dot), torch.zeros(B, dtype=torch.int32)
    )
    fresh = (fresh_state, Pendulum._obs(fresh_state.theta, fresh_state.theta_dot))
    state = PendulumState(torch.from_numpy(theta), torch.from_numpy(theta_dot), torch.zeros(B, dtype=torch.int32))
    jstep = jax.jit(jax.vmap(JaxPendulum().step))
    for step in range(250):
        actions = rng.uniform(-2, 2, (B, 1)).astype(np.float32)
        jnew, jres = _jax_pendulum_step(
            state.theta.numpy(), state.theta_dot.numpy(), state.t.numpy(), actions, step_fn=jstep
        )
        state, res, next_obs = venv.step(state, torch.from_numpy(actions), fresh=fresh)
        done = np.asarray(jres.done)
        np.testing.assert_array_equal(res.done.numpy(), done)
        assert done.all() == (step == 199) and done.any() == (step == 199)
        np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward), **PENDULUM_TOL)
        np.testing.assert_allclose(res.observation.numpy(), np.asarray(jres.observation), **PENDULUM_TOL)
        jth = np.where(done, fresh_theta, np.asarray(jnew.theta))
        jdot = np.where(done, fresh_dot, np.asarray(jnew.theta_dot))
        np.testing.assert_allclose(state.theta.numpy(), jth, **PENDULUM_TOL)
        np.testing.assert_allclose(state.theta_dot.numpy(), jdot, **PENDULUM_TOL)
        np.testing.assert_array_equal(state.t.numpy(), np.where(done, 0, np.asarray(jnew.t)))
        if step == 199:
            np.testing.assert_array_equal(next_obs.numpy(), fresh[1].numpy())
            assert not np.allclose(res.observation.numpy(), fresh[1].numpy())  # terminal obs kept
    assert (state.t == 50).all()


def test_pendulum_reset_and_spaces():
    env, cpu = Pendulum(), torch.device("cpu")
    state, obs = env.reset(4096, make_generator(0, cpu), cpu)
    assert obs.shape == (4096, 3) and obs.dtype == torch.float32
    assert (state.theta >= -np.pi).all() and (state.theta < np.pi).all() and state.theta.std() > 1.5
    assert (state.theta_dot >= -1).all() and (state.theta_dot < 1).all()
    assert (state.t == 0).all() and state.t.dtype == torch.int32
    torch.testing.assert_close(obs, Pendulum._obs(state.theta, state.theta_dot), rtol=0, atol=0)
    _, again = env.reset(4096, make_generator(0, cpu), cpu)
    assert torch.equal(obs, again)  # seeded
    jenv = JaxPendulum()
    space = env.action_space
    assert space.is_continuous and space.action_dim == space.dim == 1 and not hasattr(space, "n")
    np.testing.assert_array_equal(space.low.numpy(), np.asarray(jenv.action_space.low))
    np.testing.assert_array_equal(space.high.numpy(), np.asarray(jenv.action_space.high))
    np.testing.assert_array_equal(
        env.observation_space.high.numpy(), np.asarray(jenv.observation_space.high)
    )
    assert env.observation_dim == 3 and env.max_episode_steps == jenv.max_episode_steps == 200
