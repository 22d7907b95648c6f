"""The port's `online_learning` statistics modes and deferred pushes.

Within the port, on CartPole (the reference's own tests of
`tests/test_online_curves_and_mesh.py` and `tests/test_online_summary.py`):
"curves" equals "full" bit for bit at the same seed, the ring keeps the most
recent episodes, "summary" leaves the learner as "full" does, early stopping
works in both, and deferred pushes equal per-step pushes bit for bit.

Across packages: a deterministic env, written once for each package, whose
episodes end after fixed per-env lengths with fixed rewards (multiples of
1/8, so every sum is exact in any order), goes through the JAX driver and the
port's in each mode, with a ring at least as wide as the batch and one
narrower than the envs that finish in one step; no random stream matters.
The curves drain's arithmetic across 2^32 is held against the JAX driver's
own `_drain_ring`, run on the same scripted counter sequence.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.api.environment import Environment as JaxEnvironment
from pearl_tpu.api.spaces import BoxSpace as JaxBox, DiscreteActionSpace as JaxDiscrete
from pearl_tpu.api.types import ActionResult as JaxActionResult
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.training import online as jax_online
from pearl_tpu.training import online_learning as jax_online_learning
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs import CartPole, SyntheticAtari
from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, SARSAReplayBuffer, VisualReplayBuffer
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.training.online import RingDrain

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _dqn_agent(capacity=512, batch_size=32):
    return PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=batch_size),
        replay_buffer=BasicReplayBuffer(capacity=capacity),
    )


def _assert_params_equal(a, b):
    for x, y in zip(a.agent_state.learner.params.parameters(),
                    b.agent_state.learner.params.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---------------------------------------------------------- within the port


def test_curves_equals_full_same_seed():
    kwargs = dict(num_envs=8, max_steps=4096, learn_every_k_steps=4, chunks_per_dispatch=4,
                  seed=3, device="cpu")
    full = online_learning(_dqn_agent(), CartPole(), stats="full", **kwargs)
    curv = online_learning(_dqn_agent(), CartPole(), stats="curves", curve_capacity=2048,
                           **kwargs)
    assert curv.episodes_dropped == 0
    assert len(curv.episode_returns) == len(full.episode_returns) > 0
    np.testing.assert_array_equal(curv.episode_returns, full.episode_returns)
    np.testing.assert_array_equal(curv.episode_costs, full.episode_costs)
    np.testing.assert_array_equal(curv.episode_risky_ratios, full.episode_risky_ratios)
    assert curv.total_episodes == len(full.episode_returns)
    _assert_params_equal(full, curv)


def test_curves_ring_overflow_keeps_most_recent():
    # One dispatch, a ring far smaller than the episodes it finishes: the
    # drain yields the last R episodes and counts the rest as dropped.
    kwargs = dict(num_envs=16, max_steps=16 * 64, learn_every_k_steps=64, chunks_per_dispatch=1,
                  seed=5, device="cpu")
    full = online_learning(_dqn_agent(), CartPole(), stats="full", **kwargs)
    n_full, R = len(full.episode_returns), 8
    assert n_full > R
    with pytest.warns(UserWarning, match="curve_capacity"):
        curv = online_learning(_dqn_agent(), CartPole(), stats="curves", curve_capacity=R,
                               **kwargs)
    assert curv.episodes_dropped == n_full - R
    assert curv.total_episodes == n_full
    np.testing.assert_array_equal(curv.episode_returns, full.episode_returns[-R:])


def test_curves_early_stopping():
    res = online_learning(
        _dqn_agent(), CartPole(), num_envs=8, max_steps=200_000, learn_every_k_steps=4, seed=0,
        stats="curves", target_return=12.0, target_window=10, device="cpu",
    )
    assert res.reached_target
    assert res.total_steps < 200_000
    assert np.mean(res.episode_returns[-10:]) >= 12.0


@pytest.mark.parametrize("stats", ["full", "curves"])
def test_deferred_push_identical_learning(stats):
    """Chunk-granular ring writes are bit-identical to per-step pushes when
    capacity % (steps_per_chunk * num_envs) == 0."""
    kwargs = dict(num_envs=8, max_steps=2048, learn_every_k_steps=4, chunks_per_dispatch=2,
                  seed=7, stats=stats, device="cpu")
    a = online_learning(_dqn_agent(capacity=256), CartPole(), **kwargs)
    b = online_learning(_dqn_agent(capacity=256), CartPole(), deferred_push=True, **kwargs)
    assert len(a.episode_returns) > 0
    np.testing.assert_array_equal(a.episode_returns, b.episode_returns)
    _assert_params_equal(a, b)
    for x, y in zip(dataclasses.astuple(a.agent_state.replay.storage),
                    dataclasses.astuple(b.agent_state.replay.storage)):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_runner_deferred_push_identical():
    results = []
    for deferred in (False, True):
        init_fn, run_fn = make_compiled_runner(
            _dqn_agent(capacity=256), CartPole(), num_envs=8, steps_per_learn=4,
            learns_per_call=3, deferred_push=deferred, device="cpu",
        )
        astate, env_states = init_fn(0)
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            astate, env_states, stats = run_fn(astate, env_states, gen)
        results.append((astate, stats))
    (a, sa), (b, sb) = results
    assert sa["episodes"].item() == sb["episodes"].item() > 0
    assert a.replay.cursor == b.replay.cursor and a.replay.size == b.replay.size
    for x, y in zip(a.learner.params.parameters(), b.learner.params.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _stepwise_agents():
    sarsa = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=16),
        replay_buffer=SARSAReplayBuffer(capacity=256, num_envs=4),
    )
    visual = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(input_shape=(8, 8, 2), out_channels=(4,),
                                       kernel_sizes=(4,), strides=(2,), paddings=(0,),
                                       hidden_dims=(8,), time_major_stack=True),
            history_summarizer=FrameRingHistorySummarization(history_length=2),
            training_rounds=1, batch_size=16,
        ),
        replay_buffer=VisualReplayBuffer(capacity=256, stack=2, num_envs=4),
    )
    return {"sarsa": (sarsa, CartPole()), "visual": (visual, SyntheticAtari(height=8, width=8))}


@pytest.mark.parametrize("entry", ["online_learning", "make_compiled_runner"])
@pytest.mark.parametrize("buffer", ["sarsa", "visual"])
def test_deferred_push_rejected_for_stepwise_buffers(buffer, entry):
    agent, env = _stepwise_agents()[buffer]
    with pytest.raises(ValueError, match="deferred"):
        if entry == "online_learning":
            online_learning(agent, env, num_envs=4, max_steps=64, deferred_push=True,
                            device="cpu")
        else:
            make_compiled_runner(agent, env, num_envs=4, deferred_push=True, device="cpu")


def test_bad_stats_mode_raises():
    with pytest.raises(ValueError, match="stats"):
        online_learning(_dqn_agent(), CartPole(), stats="bogus", device="cpu")


def test_summary_mode_matches_full_mode_learner_state():
    """Same seed, same chunking: bit-identical learner params in both modes
    (the accounting draws nothing and reorders nothing)."""
    kwargs = dict(num_envs=8, max_steps=8 * 4 * 6, learn_every_k_steps=4, chunks_per_dispatch=2,
                  seed=11, device="cpu")
    full = online_learning(_dqn_agent(4096, 64), CartPole(), stats="full", **kwargs)
    summ = online_learning(_dqn_agent(4096, 64), CartPole(), stats="summary", **kwargs)
    _assert_params_equal(full, summ)
    assert summ.agent_state.learner.step == full.agent_state.learner.step


def test_summary_mode_counts_match_full_mode():
    kwargs = dict(num_envs=8, max_steps=8 * 2 * 40, learn_every_k_steps=2, seed=3, device="cpu")
    full = online_learning(_dqn_agent(4096, 64), CartPole(), stats="full", **kwargs)
    summ = online_learning(_dqn_agent(4096, 64), CartPole(), stats="summary", **kwargs)
    assert summ.total_episodes == len(full.episode_returns) > 0
    assert np.isclose(summ.mean_return, np.mean(full.episode_returns), rtol=1e-6)
    assert len(summ.return_curve) == 40  # one row per chunk
    assert summ.episode_returns.shape == (0,)


def test_summary_mode_early_stops_on_target():
    res = online_learning(
        _dqn_agent(), CartPole(), num_envs=16, max_steps=200_000, learn_every_k_steps=4,
        chunks_per_dispatch=2, seed=7, target_return=12.0, target_window=20, stats="summary",
        device="cpu",
    )
    assert res.reached_target
    assert res.total_steps < 200_000
    assert res.return_curve.max() >= 12.0  # the curve tracks the statistic


# ----------------------------------------------------- the deterministic env

# Per env: the step within the episode it starts at and a reward weight for
# its first episode. Every episode ends when t reaches L - 1; a reset starts
# at t = 0 with weight 1. Envs 0-2 end their first episodes on one step with
# different returns (a collision for a ring narrower than 3).
T0 = [0, 0, 0, 1, 1, 2, 3, -2]
W0 = [1.0, 2.0, 3.0, 1.0, 2.0, 1.0, 3.0, 2.0]
L = 5


def _reward_and_cost(t, t_float, w, xp):
    """Reward w * (1 + t / 4); a cost of w / 2 on even steps."""
    return w * (1.0 + 0.25 * t_float), xp.where(t % 2 == 0, 0.5 * w, 0.0)


@struct.dataclass
class _JaxDetState:
    t: jnp.ndarray
    w: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class _JaxDetEnv(JaxEnvironment):
    @property
    def action_space(self):
        return JaxDiscrete.discrete(2)

    @property
    def observation_space(self):
        return JaxBox.create([-10.0], [10.0])

    def reset(self, key):
        state = _JaxDetState(t=jnp.zeros((), jnp.int32), w=jnp.ones(()))
        return state, jnp.zeros((1,))

    def step(self, state, action, key):
        reward, cost = _reward_and_cost(state.t, state.t.astype(jnp.float32), state.w, jnp)
        done = state.t + 1 >= L
        t = state.t + 1
        obs = t.astype(jnp.float32)[None]
        result = JaxActionResult(observation=obs, reward=reward, terminated=done,
                                 truncated=jnp.zeros((), bool), cost=cost)
        return _JaxDetState(t=t, w=state.w), result


@dataclasses.dataclass
class _DetState:
    t: torch.Tensor
    w: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _DetEnv(Environment):
    @property
    def action_space(self):
        return DiscreteActionSpace.discrete(2)

    @property
    def observation_space(self):
        return BoxSpace.create([-10.0], [10.0])

    def reset(self, num_envs, generator, device):
        state = _DetState(t=torch.zeros((num_envs,), dtype=torch.int32, device=device),
                          w=torch.ones((num_envs,), device=device))
        return state, torch.zeros((num_envs, 1), device=device)

    def step(self, state, action):
        reward, cost = _reward_and_cost(state.t, state.t.float(), state.w, torch)
        done = state.t + 1 >= L
        t = state.t + 1
        result = ActionResult(observation=t.float()[:, None], reward=reward, terminated=done,
                              truncated=torch.zeros_like(done), cost=cost)
        return _DetState(t=t, w=state.w), result


DET_KW = dict(num_envs=len(T0), max_steps=len(T0) * 4 * 2 * 4, learn_every_k_steps=4,
              chunks_per_dispatch=2, learn=False)


def _jax_det_run(stats, R):
    env = _JaxDetEnv()
    agent = JaxAgent(policy_learner=JaxDQN(training_rounds=1, batch_size=8),
                     replay_buffer=JaxBuffer(capacity=256))
    state = _JaxDetState(t=jnp.asarray(T0, jnp.int32), w=jnp.asarray(W0, jnp.float32))
    obs = state.t.astype(jnp.float32)[:, None]
    astate = agent.for_env(env).init(jax.random.PRNGKey(0), 1, len(T0), obs)
    return jax_online_learning(agent, env, agent_state=astate, env_states=state, stats=stats,
                               curve_capacity=R, **DET_KW)


def _det_run(stats, R, **overrides):
    env = _DetEnv()
    agent = PearlAgent(policy_learner=DeepQLearning(training_rounds=1, batch_size=8),
                       replay_buffer=BasicReplayBuffer(capacity=256))
    state = _DetState(t=torch.tensor(T0, dtype=torch.int32), w=torch.tensor(W0))
    astate = agent.for_env(env).init(0, 1, len(T0), state.t.float()[:, None], device="cpu")
    return online_learning(agent, env, agent_state=astate, env_states=state, stats=stats,
                           curve_capacity=R, device="cpu", **{**DET_KW, **overrides})


@pytest.mark.filterwarnings("ignore:stats='curves'")
@pytest.mark.parametrize("stats,R", [("full", 4096), ("summary", 4096), ("curves", 64),
                                     ("curves", 2)])
def test_deterministic_env_matches_the_jax_driver(stats, R):
    ref, ours = _jax_det_run(stats, R), _det_run(stats, R)
    assert ours.total_steps == ref.total_steps
    assert ours.total_episodes == ref.total_episodes > 0
    assert ours.episodes_dropped == ref.episodes_dropped
    np.testing.assert_array_equal(ours.episode_returns, ref.episode_returns)
    np.testing.assert_allclose(ours.episode_costs, ref.episode_costs, atol=1e-6)
    np.testing.assert_allclose(ours.episode_risky_ratios, ref.episode_risky_ratios, atol=1e-6)
    if stats == "summary":
        np.testing.assert_allclose(ours.return_curve, ref.return_curve, atol=1e-6)
        for name in ("mean_return", "mean_cost", "mean_risky_ratio"):
            np.testing.assert_allclose(getattr(ours, name), getattr(ref, name), atol=1e-6)
        assert ours.mean_cost > 0 and 0 < ours.mean_risky_ratio < 1
    if stats == "curves" and R == 2:
        assert ours.episodes_dropped > 0


def test_summary_means_equal_the_full_modes_episodes():
    full, summ = _det_run("full", 4096), _det_run("summary", 4096)
    assert summ.total_episodes == len(full.episode_returns)
    np.testing.assert_allclose(summ.mean_return, full.episode_returns.mean(), rtol=1e-6)
    np.testing.assert_allclose(summ.mean_cost, full.episode_costs.mean(), rtol=1e-6)
    np.testing.assert_allclose(summ.mean_risky_ratio, full.episode_risky_ratios.mean(), rtol=1e-6)


@pytest.mark.filterwarnings("ignore:stats='curves'")
def test_narrow_ring_keeps_the_last_finishers_in_env_order():
    # One dispatch of five steps. On the fifth, envs 0, 1 and 2 end their
    # first episodes with returns 7.5, 15 and 22.5; a ring of 2 keeps the
    # last two finishers in env order, envs 1 and 2.
    kw = dict(learn_every_k_steps=5, max_steps=len(T0) * 5, chunks_per_dispatch=1)
    full, curv = _det_run("full", 4096, **kw), _det_run("curves", 2, **kw)
    assert full.episode_returns.tolist() == [11.25, 5.25, 6.5, 13.0, 7.5, 15.0, 22.5]
    assert curv.episode_returns.tolist() == [15.0, 22.5]
    assert curv.episodes_dropped == 5 and curv.total_episodes == 7


# ------------------------------------------------------------ the drain


def _jax_drain_ring():
    """The JAX driver's own `_drain_ring`, a closure inside
    `online_learning`, rebuilt around fresh cells."""
    code = next(c for c in jax_online.online_learning.__code__.co_consts
                if getattr(c, "co_name", None) == "_drain_ring")
    init = {"drained": [0], "raw_prev": [0], "cum": [0], "dropped": 0, "finished": [],
            "finished_costs": [], "finished_risky": []}
    cells = {name: types.CellType(init[name]) for name in code.co_freevars}
    fn = types.FunctionType(code, vars(jax_online), "_drain_ring", None,
                            tuple(cells[name] for name in code.co_freevars))
    return fn, cells


def test_drain_arithmetic_across_2_32_matches_the_jax_driver():
    R = 8
    rng = np.random.default_rng(0)
    jax_drain, cells = _jax_drain_ring()
    ours = RingDrain()
    got = []
    # Lifetime counts on the device; the JAX driver's uint32 wraps, the
    # port's int64 does not, and both drains read them modulo 2^32.
    lifetime = [3, 3, 2**32 - 5, 2**32 + 2, 2**32 + 2, 2**32 + 9, 2**33 + 1, 2**33 + 4]
    for count in lifetime:
        ring = rng.standard_normal((3, R)).astype(np.float32)
        jax_drain(np.asarray([count & 0xFFFFFFFF], np.uint32), ring, 0)
        got.extend(ours.drain(count, ring).tolist())
    assert ours.total == cells["cum"].cell_contents[0] == lifetime[-1]
    assert ours.drained == cells["drained"].cell_contents[0]
    assert ours.dropped == cells["dropped"].cell_contents
    want = np.stack([cells[k].cell_contents for k in ("finished", "finished_costs",
                                                       "finished_risky")], axis=1)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert len(got) > 0
