"""CartPole and the vector env of the PyTorch port (pearl_tpu_torch/envs)
against the JAX package's (pearl_tpu/envs): the same numpy-made states and
actions give the same next state, reward, terminated and truncated, and the
auto-reset keeps the terminal observation in the result while the next
observation comes from the given reset states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pearl_tpu.envs.cartpole import CartPole as JaxCartPole
from pearl_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from pearl_tpu.utils.pytree import tree_select as jax_tree_select
from pearl_tpu_torch.envs import CartPole, CartPoleState, VectorEnv
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
