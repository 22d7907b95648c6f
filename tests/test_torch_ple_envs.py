"""Catcher, FlappyBird, Pixelcopter, Pong, PuckWorld and Breakout of the
PyTorch port (pearl_tpu_torch/envs) against the JAX package's
(pearl_tpu/envs): numpy-made states and actions through one step, the JAX
step under `jax.vmap`; what a step draws (a fruit's column, pipe gaps, a
gate, a serve, the target's new place) is fed to the port's `_transition`
from JAX's own draws, taken from the keys the JAX step is given. Then the
resets, and the registry's rows through the runner at a tiny size on the
CPU: DQN on the four games, PuckWorld and its three variants, and the CNN
DQN on Breakout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs import breakout as jax_breakout
from pearl_tpu.envs import ple as jax_ple
from pearl_tpu.envs import puckworld as jax_puckworld
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import (
    Breakout,
    BreakoutState,
    Catcher,
    CatcherState,
    FlappyBird,
    FlappyBirdState,
    PartialObservabilityWrapper,
    Pixelcopter,
    PixelcopterState,
    Pong,
    PongState,
    PuckWorld,
    PuckWorldState,
    SafetyWrapper,
    SparseRewardWrapper,
)
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import make_compiled_runner
from pearl_tpu_torch.utils import make_generator

torch.set_num_threads(1)

# One float32 step: the same operations in the same order; only sin, cos and
# sqrt may differ by an ulp between XLA's and PyTorch's CPU versions.
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
B = 64


def _keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _check_step(env, jenv, fields, jax_state_cls, state_cls, actions, draw=None):
    """One step of both packages from the numpy `fields`; `draw(key)` is
    what the JAX step draws from its key, fed to the port's `_transition`."""
    keys = _keys(len(actions))
    jstate = jax_state_cls(**{k: jnp.asarray(v) for k, v in fields.items()})
    jnew, jres = jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(actions), keys)
    state = state_cls(**{k: torch.from_numpy(v.copy()) for k, v in fields.items()})
    if draw is None:
        new, res = env.step(state, torch.from_numpy(actions))
    else:
        draws = torch.from_numpy(np.array(jax.vmap(draw)(keys)))
        new, res = env._transition(state, torch.from_numpy(actions), draws)
    for name in fields:
        got, want = getattr(new, name), np.asarray(getattr(jnew, name))
        if got.is_floating_point():
            np.testing.assert_allclose(got.numpy(), want, **STEP_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            assert got.dtype == torch.from_numpy(fields[name]).dtype, name
    np.testing.assert_allclose(res.observation.numpy(), np.asarray(jres.observation), **STEP_TOL)
    np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward), **STEP_TOL)
    np.testing.assert_array_equal(res.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), np.asarray(jres.truncated))
    return new, res


def _f32(*a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------- Catcher
def test_catcher_step_matches_jax_with_its_draws():
    rng = np.random.default_rng(0)
    f = dict(
        player_x=rng.uniform(0, 1, B), player_vel=rng.uniform(-0.05, 0.05, B),
        fruit_x=rng.uniform(0.05, 0.95, B), fruit_y=rng.uniform(0, 0.98, B),
    )
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["lives"] = rng.integers(1, 4, B).astype(np.int32)
    f["t"] = rng.integers(0, 499, B).astype(np.int32)
    # Landing this step: a catch, a miss, a miss of the last life.
    f["fruit_y"][:3] = 0.995
    f["player_x"][:3], f["fruit_x"][:3] = 0.5, _f32(0.55, 0.9, 0.1)
    f["player_vel"][:3], f["lives"][:3] = 0.0, [3, 3, 1]
    f["player_x"][3], f["player_vel"][3] = 0.01, -0.05  # into the left wall
    f["t"][4:6] = 499
    actions = rng.integers(0, 3, (B, 1)).astype(np.float32)
    actions[:4, 0] = [2, 2, 2, 0]
    _, res = _check_step(Catcher(), jax_ple.Catcher(), f, jax_ple.CatcherState, CatcherState,
                         actions, lambda k: jax.random.uniform(k, (), minval=0.05, maxval=0.95))
    assert list(res.reward[:3]) == [1.0, -1.0, -5.0] and res.terminated[2]
    assert set(res.reward.tolist()) <= {0.0, 1.0, -1.0, -5.0}


# ------------------------------------------------------------- FlappyBird
def test_flappy_bird_step_matches_jax_with_its_draws():
    rng = np.random.default_rng(1)
    f = dict(
        player_y=rng.uniform(0.05, 0.95, B), player_vel=rng.uniform(-0.05, 0.05, B),
        pipe_x=np.stack([rng.uniform(-0.09, 1.0, B), rng.uniform(0.5, 1.75, B)], -1),
        gap_y=rng.uniform(0.25, 0.75, (B, 2)),
    )
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["t"] = rng.integers(0, 499, B).astype(np.int32)
    f["pipe_x"][0] = [0.21, 0.96]  # passed this step
    f["player_y"][0], f["gap_y"][0] = 0.5, [0.5, 0.5]
    f["pipe_x"][1] = [-0.09, 0.66]  # recycled this step
    f["pipe_x"][2], f["player_y"][2], f["gap_y"][2] = [0.22, 0.97], 0.2, [0.6, 0.5]  # a pipe
    f["player_y"][3], f["player_vel"][3] = 0.99, 0.05  # the floor
    f["pipe_x"][4] = [-0.08, 0.3]  # behind the bird: the other pipe is next
    f["t"][5:7] = 499
    actions = rng.integers(0, 2, (B, 1)).astype(np.float32)
    actions[[0, 2, 3], 0] = 1
    new, res = _check_step(
        FlappyBird(), jax_ple.FlappyBird(), f, jax_ple.FlappyBirdState, FlappyBirdState, actions,
        lambda k: jax.random.uniform(k, (2,), minval=0.25, maxval=0.75))
    assert res.reward[0] == 1.0 and res.terminated[2] and res.terminated[3]
    assert new.pipe_x[1, 0] > 1.0


# ------------------------------------------------------------ Pixelcopter
def test_pixelcopter_step_matches_jax_with_its_draws():
    rng = np.random.default_rng(2)
    f = dict(
        player_y=rng.uniform(0.3, 0.7, B), player_vel=rng.uniform(-0.04, 0.04, B),
        phase=rng.uniform(0, 2 * np.pi, B), gate_x=rng.uniform(-0.02, 1.0, B),
        gate_y=rng.uniform(0.35, 0.65, B),
    )
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["t"] = rng.integers(0, 499, B).astype(np.int32)
    f["gate_x"][0], f["player_y"][0], f["gate_y"][0] = 0.01, 0.5, 0.5  # through the gate
    f["gate_x"][1], f["player_y"][1], f["gate_y"][1] = 0.03, 0.3, 0.6  # into its block
    f["player_y"][2], f["phase"][2] = 0.21, np.float32(np.pi / 2)  # into the ceiling
    f["t"][3:5] = 499
    actions = rng.integers(0, 2, (B, 1)).astype(np.float32)
    actions[:3, 0] = [1, 1, 0]
    _, res = _check_step(
        Pixelcopter(), jax_ple.Pixelcopter(), f, jax_ple.PixelcopterState, PixelcopterState,
        actions, lambda k: jax.random.uniform(k, (), minval=0.35, maxval=0.65))
    assert res.reward[0] == 1.0 and res.terminated[1] and res.terminated[2]


# ------------------------------------------------------------------- Pong
def test_pong_step_matches_jax_with_its_draws():
    rng = np.random.default_rng(3)
    ang = rng.uniform(-0.5, 0.5, B)
    f = dict(
        player_y=rng.uniform(0, 1, B), player_vel=rng.uniform(-0.03, 0.03, B),
        cpu_y=rng.uniform(0, 1, B), ball=rng.uniform(0.02, 0.98, (B, 2)),
        ball_vel=0.03 * np.stack([np.sign(rng.uniform(-1, 1, B)) * np.cos(ang), np.sin(ang)], -1),
    )
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["player_score"] = rng.integers(0, 5, B).astype(np.int32)
    f["cpu_score"] = rng.integers(0, 5, B).astype(np.int32)
    f["t"] = rng.integers(0, 499, B).astype(np.int32)
    # A return off the agent's paddle, a point for the agent that ends the
    # match, a point for the CPU, a bounce off the top wall.
    f["ball"][0], f["ball_vel"][0], f["player_y"][0] = [0.06, 0.5], [-0.03, 0.0], 0.5
    f["ball"][1], f["ball_vel"][1], f["cpu_y"][1] = [0.99, 0.5], [0.03, 0.0], 0.1
    f["player_score"][1] = 4
    f["ball"][2], f["ball_vel"][2], f["player_y"][2] = [0.01, 0.5], [-0.03, 0.0], 0.9
    f["ball"][3], f["ball_vel"][3] = [0.5, 0.99], [0.02, 0.02]
    f["t"][4:6] = 499
    actions = rng.integers(0, 3, (B, 1)).astype(np.float32)
    actions[:3, 0] = 2
    new, res = _check_step(Pong(), jax_ple.Pong(), f, jax_ple.PongState, PongState, actions,
                           lambda k: jax.random.uniform(k, (), minval=-0.5, maxval=0.5))
    assert new.ball_vel[0, 0] > 0 and res.reward[1] == 1.0 and res.terminated[1]
    assert res.reward[2] == -1.0 and new.ball_vel[3, 1] < 0


# -------------------------------------------------------------- PuckWorld
def test_puckworld_step_matches_jax_with_its_draws():
    rng = np.random.default_rng(4)
    f = dict(pos=rng.uniform(0, 1, (B, 2)), vel=rng.uniform(-0.1, 0.1, (B, 2)),
             good=rng.uniform(0, 1, (B, 2)), bad=rng.uniform(0, 1, (B, 2)))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["t"] = rng.integers(0, 998, B).astype(np.int32)
    f["t"][:3] = [299, 599, 899]  # the target relocates
    f["pos"][3], f["vel"][3] = [0.01, 0.99], [-0.05, 0.05]  # a corner: both components
    f["bad"][4] = f["pos"][4] + 0.05  # inside the creep's disc
    f["bad"][5] = f["pos"][5]  # on the agent: the pursuit divides by norm + 1e-8
    f["vel"][5] = 0.0
    f["t"][6:8] = 999
    actions = rng.integers(0, 5, (B, 1)).astype(np.float32)
    actions[3, 0], actions[5, 0] = 1, 0

    def draw(key):
        k_good, _ = jax.random.split(key)
        return jax.random.uniform(k_good, (2,))

    new, res = _check_step(PuckWorld(), jax_puckworld.PuckWorld(), f,
                           jax_puckworld.PuckWorldState, PuckWorldState, actions, draw)
    assert not np.allclose(new.good[:3].numpy(), f["good"][:3])
    assert (new.vel[3] == 0).all() and res.truncated[6:8].all() and not res.terminated.any()


# --------------------------------------------------------------- Breakout
def _breakout_cases():
    """Random states plus the walls and corners: the ball at column 0 and 9
    moving both ways, in the brick band at its top row, at the ceiling, over
    the paddle and past it, and a wall with one brick left."""
    rng = np.random.default_rng(5)
    n = 48
    ball = np.stack([rng.integers(0, 10, n), rng.integers(0, 10, n)], -1).astype(np.int32)
    ddir = (rng.integers(0, 2, (n, 2)) * 2 - 1).astype(np.int32)
    bricks = rng.uniform(0, 1, (n, 3, 10)) < 0.6
    paddle = rng.integers(0, 10, n).astype(np.int32)
    edge = [([4, 0], [1, -1]), ([4, 0], [1, 1]), ([4, 9], [-1, 1]), ([4, 9], [-1, -1]),
            ([1, 0], [-1, -1]), ([1, 9], [1, 1]), ([0, 5], [-1, 1]), ([2, 4], [-1, 1]),
            ([8, 3], [1, 1]), ([8, 3], [1, -1]), ([0, 0], [-1, -1]), ([0, 9], [-1, 1])]
    for i, (b, d) in enumerate(edge):
        ball[i], ddir[i] = b, d
    paddle[8] = 4  # under the ball's next cell: a bounce
    paddle[9] = 7  # far from it: a miss
    bricks[4:6] = True  # the top row's bricks live at columns 0-1 and 8-9
    bricks[7] = False
    bricks[7, 0, 5] = True  # the last brick: hit, and a fresh wall
    ball[7], ddir[7] = [2, 4], [-1, 1]
    t = rng.integers(0, 499, n).astype(np.int32)
    t[12:14] = 499
    actions = rng.integers(0, 3, (n, 1)).astype(np.float32)
    actions[:2, 0] = [0, 2]
    actions[8:10, 0] = 1  # the paddle stays
    return dict(ball=ball, last_ball=ball.copy(), ddir=ddir, paddle=paddle, bricks=bricks, t=t), \
        actions


def test_breakout_step_matches_jax_over_walls_corners_and_bricks():
    fields, actions = _breakout_cases()
    new, res = _check_step(Breakout(), jax_breakout.Breakout(), fields,
                           jax_breakout.BreakoutState, BreakoutState, actions)
    np.testing.assert_array_equal(res.reward.numpy()[7], 1.0)
    assert new.bricks[7].all()  # the wall was rebuilt
    assert res.terminated[9] and not res.terminated[8]
    assert ((new.ball[:, 1] >= 0) & (new.ball[:, 1] <= 9)).all()


def test_breakout_reset_and_observation_layout():
    env = Breakout()
    state, obs = env.reset(2048, make_generator(0, "cpu"), "cpu")
    assert obs.shape == (2048, 400) and env.observation_dim == 400
    grid = obs.reshape(2048, 10, 10, 4)
    assert (grid[..., 0].sum((1, 2)) == 1).all() and (grid[:, 9, 5, 0] == 1).all()
    assert (grid[..., 1].sum((1, 2)) == 1).all() and (grid[..., 3].sum((1, 2)) == 30).all()
    assert (state.ball[:, 0] == 4).all() and set(state.ddir[:, 1].tolist()) == {-1, 1}
    assert set(state.ball[:, 1].tolist()) == set(range(10))
    assert state.ball.dtype == torch.int32 and state.bricks.dtype == torch.bool
    # The JAX observation of the same state, element for element.
    jstate = jax_breakout.BreakoutState(**{
        f.name: jnp.asarray(getattr(state, f.name)[:8].numpy())
        for f in dataclasses.fields(state)})
    np.testing.assert_array_equal(
        obs[:8].numpy(), np.asarray(jax.vmap(jax_breakout.Breakout()._obs)(jstate)))


# ----------------------------------------------------------------- resets
@pytest.mark.parametrize("env", [Catcher(), FlappyBird(), Pixelcopter(), Pong(), PuckWorld()],
                         ids=lambda e: type(e).__name__)
def test_ple_resets_draw_the_reference_box(env):
    gen = make_generator(0, "cpu")
    state, obs = env.reset(4096, gen, "cpu")
    assert obs.shape == (4096, env.observation_dim) and obs.dtype == torch.float32
    assert (state.t == 0).all() and state.t.dtype == torch.int32 and state.generator is gen
    draws = {
        Catcher: lambda s: [(s.fruit_x, 0.05, 0.95)],
        FlappyBird: lambda s: [(s.gap_y, 0.25, 0.75)],
        Pixelcopter: lambda s: [(s.phase, 0.0, 2 * np.pi), (s.gate_y, 0.35, 0.65)],
        Pong: lambda s: [(torch.atan2(s.ball_vel[:, 1], -s.ball_vel[:, 0]), -0.5, 0.5)],
        PuckWorld: lambda s: [(s.pos, 0.0, 1.0), (s.good, 0.0, 1.0), (s.bad, 0.0, 1.0)],
    }[type(env)](state)
    for x, low, high in draws:
        span = high - low
        assert x.min() >= low - 1e-6 and x.max() <= high + 1e-6
        assert x.min() < low + 0.01 * span and x.max() > high - 0.01 * span


# ------------------------------------------------------ the slice, tiny
def _puckworld_variants():
    """configs.py:675-695: PO hides the velocities, SR pays 1 within 0.1 of
    the target, SF adds N(0.01, 0.1) in the risky half x > 0.5."""
    def success(obs):
        return torch.linalg.vector_norm(obs[..., 0:2] - obs[..., 4:6], dim=-1) < 0.1

    return {
        "PuckWorld-PO": PartialObservabilityWrapper(PuckWorld(),
                                                    observed_indices=(0, 1, 4, 5, 6, 7)),
        "PuckWorld-SR": SparseRewardWrapper(PuckWorld(), success_fn=success),
        "PuckWorld-SF": SafetyWrapper(PuckWorld(), risky_fn=lambda obs, a: obs[..., 0] > 0.5,
                                      noisy_reward_sigma=0.1),
    }


PLE_ENVS = {"Catcher": Catcher(), "FlappyBird": FlappyBird(), "Pixelcopter": Pixelcopter(),
            "Pong": Pong(), "PuckWorld": PuckWorld(), **_puckworld_variants()}


@pytest.mark.parametrize("name", list(PLE_ENVS))
def test_registry_dqn_row_runs_on_each_ple_env_at_a_tiny_size(name):
    """The registry's DQN row (configs.py:86-91: two rounds of 128, a learn
    every 4 steps) through the runner at 16 envs for 64 steps: finite
    rewards in the game's set, dones where the game ends them."""
    env = PLE_ENVS[name]
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=2, batch_size=128, exploration=EGreedyExploration(
            start_epsilon=0.5, end_epsilon=0.05, warmup_steps=20_000)),
        replay_buffer=BasicReplayBuffer(capacity=4096),
    )
    init_fn, run_fn = make_compiled_runner(agent, env, num_envs=16, steps_per_learn=4,
                                           learns_per_call=16, device="cpu")
    astate, env_states = init_fn(0)
    astate, env_states, stats = run_fn(astate, env_states, make_generator(0, "cpu"))
    replay = astate.replay
    reward = replay.storage.reward[:replay.size]
    assert replay.size == 16 * 64 and torch.isfinite(reward).all()
    if name in ("Catcher", "FlappyBird", "Pixelcopter", "Pong"):
        assert set(reward.unique().tolist()) <= {0.0, 1.0, 2.0, -1.0, -5.0, -4.0}
    elif name == "PuckWorld-SR":
        assert set(reward.unique().tolist()) <= {0.0, 1.0}
    elif name != "PuckWorld-SF":
        assert (reward <= 0).all()
    if name.startswith("PuckWorld"):
        # No PuckWorld episode ends before its 1000-step horizon.
        assert stats["episodes"].item() == 0
    assert replay.storage.state.shape[1] == (6 if name == "PuckWorld-PO" else env.observation_dim)


def test_registry_cnn_dqn_row_runs_on_breakout_at_a_tiny_size():
    """configs.py:256-261, 560-577: the CNN over (10, 10, 4), channels
    (16, 32), hidden 128; here 8 envs and a batch of 32."""
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(input_shape=(10, 10, 4), out_channels=(16, 32),
                                       kernel_sizes=(3, 3), strides=(1, 1), paddings=(1, 1),
                                       hidden_dims=(128,)),
            training_rounds=1, batch_size=32),
        replay_buffer=BasicReplayBuffer(capacity=1024),
    )
    init_fn, run_fn = make_compiled_runner(agent, Breakout(), num_envs=8, steps_per_learn=4,
                                           learns_per_call=4, device="cpu")
    astate, env_states = init_fn(0)
    astate, env_states, stats = run_fn(astate, env_states, make_generator(0, "cpu"))
    reward = astate.replay.storage.reward[:astate.replay.size]
    assert astate.replay.size == 128 and set(reward.unique().tolist()) <= {0.0, 1.0}
    assert all(torch.isfinite(p).all() for p in astate.learner.params.parameters())


@pytest.mark.cuda
def test_ple_and_breakout_resets_and_steps_make_no_host_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = make_generator(0, "cuda")
    for env in list(PLE_ENVS.values()) + [Breakout()]:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = env.reset(1024, gen, "cuda")
            env.step(state, torch.zeros((1024, 1), device="cuda"))
        finally:
            torch.cuda.set_sync_debug_mode(0)


# ------------------------------ the Catcher anchor's learner, three steps
def test_catcher_anchor_dqn_learns_like_jax_over_three_steps():
    """The learner of the Catcher anchor (tests/test_ple_envs.py:175-202: the
    default Q-network, batches of 128, 3 actions) against optax over three
    AdamW steps on Catcher transitions made by the JAX env: the anchor is
    met at a few seeds in either package, so this holds the learning step
    itself."""
    from pearl_tpu.neural_networks.q_value_networks import VanillaQValueNetwork as JaxVanilla
    from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
    from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
    from pearl_tpu_torch.neural_networks import VanillaQValueNetwork
    from pearl_tpu_torch.replay_buffers import TransitionBatch
    from pearl_tpu_torch.utils.jax_params import load_flax_q_params
    from tests.test_torch_dqn import TOL, _assert_tree_close, _flax_layout, _jax_loss

    jenv = jax_ple.Catcher()
    jl = JaxDQN(q_network=JaxVanilla(), training_rounds=2, batch_size=128).bind(jenv.action_space)
    tl = DeepQLearning(q_network=VanillaQValueNetwork(), training_rounds=2,
                       batch_size=128).bind(Catcher().action_space)
    jstate = jl.init(jax.random.PRNGKey(0), 4, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), 4, tl.action_space, 1, torch.device("cpu"))
    weights = jax.tree.map(np.asarray, jstate.params)
    load_flax_q_params(tstate.params, weights)
    load_flax_q_params(tstate.target_params, weights)
    # Transitions of 128 envs over 30 steps of random play, 3 x 128 of them.
    rng = np.random.default_rng(6)
    jstate_env, obs = jax.vmap(jenv.reset)(_keys(128))
    jstep = jax.jit(jax.vmap(jenv.step))
    rows = []
    for step in range(30):
        a = rng.integers(0, 3, (128, 1)).astype(np.float32)
        jstate_env, res = jstep(jstate_env, jnp.asarray(a), _keys(128, step))
        rows.append(dict(state=np.asarray(obs), action=a, action_index=a[:, 0].astype(np.int32),
                         reward=np.asarray(res.reward), next_state=np.asarray(res.observation),
                         terminated=np.asarray(res.terminated),
                         truncated=np.asarray(res.truncated)))
        obs = res.observation
    for step in range(3):
        data = {k: np.concatenate([r[k] for r in rows[step::3]])[rng.permutation(1280)[:128]]
                for k in rows[0]}
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
        tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
        jloss, _ = _jax_loss(jl, jstate, jbatch)
        tloss, _ = tl.td_loss(tstate, tbatch)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        jstate, jaux = jl.learn_batch(jstate, jbatch)
        tstate, taux = tl.learn_batch(tstate, tbatch)
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), **TOL)
        _assert_tree_close(_flax_layout(tstate.params), jstate.params)
        _assert_tree_close(_flax_layout(tstate.target_params), jstate.target_params)
