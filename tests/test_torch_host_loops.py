"""The port's host loops (`training/host_loop.py`), Gymnasium adapter
(`envs/gym_adapter.py`) and Atari wrappers (`envs/atari.py`) on the CPU.

- The Atari wrappers are numpy code carried over from the JAX package: on
  the reference's scripted fakes (`tests/test_atari_and_puckworld.py`) they
  give JAX's observations, rewards, flags and the fake's reset and step
  counts exactly, under the same seeds and actions.
- `GymEnvironment` gives JAX's spaces and every step of gymnasium's
  CartPole-v1 and Pendulum-v1 for the same seed and actions.
- `online_learning_host` with `DictTabularQLearning` on FrozenLake-v1 gives
  JAX's per-episode returns and table: both learners draw from
  `np.random.RandomState(seed)`.
- `agent_online_learning_host` runs a PearlAgent on the adapter, on a
  device env and on the composed Atari pipeline with a CNN-DQN (the
  properties of `tests/test_atari_and_puckworld.py:163-258`; the agents'
  random streams differ across packages).
"""

import dataclasses

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

from pearl_tpu.envs import atari as jax_atari  # noqa: E402
from pearl_tpu.envs.gym_adapter import GymEnvironment as JaxGymEnvironment  # noqa: E402
from pearl_tpu.policy_learners.sequential_decision_making.tabular_q import (  # noqa: E402
    DictTabularQLearning as JaxDictTabularQLearning,
)
from pearl_tpu.training import online_learning_host as jax_online_learning_host  # noqa: E402
from pearl_tpu_torch.agent import PearlAgent  # noqa: E402
from pearl_tpu_torch.envs import CartPole  # noqa: E402
from pearl_tpu_torch.envs import atari  # noqa: E402
from pearl_tpu_torch.envs.gym_adapter import GymEnvironment  # noqa: E402
from pearl_tpu_torch.neural_networks import (  # noqa: E402
    CNNQValueNetwork,
    MultiHeadQValueNetwork,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making import (  # noqa: E402
    DeepQLearning,
    DictTabularQLearning,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer  # noqa: E402
from pearl_tpu_torch.training import (  # noqa: E402
    agent_online_learning_host,
    online_learning_host,
    run_episode_host,
)
from test_atari_and_puckworld import FakeALE, FakeALEImage  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"


def _drive(env, raw, actions, seeds):
    """Reset with each seed in turn and step through `actions`, resetting
    (unseeded) whenever an episode ends; a record of every observation,
    reward and flag, and the fake's counts."""
    record = []
    for seed in seeds:
        obs, info = env.reset(seed=seed)
        record.append(("reset", np.array(obs), info.get("lives")))
        for a in actions:
            obs, reward, terminated, truncated, info = env.step(int(a))
            record.append(("step", np.array(obs), float(reward), bool(terminated),
                           bool(truncated), info.get("lives")))
            if terminated or truncated:
                obs, info = env.reset()
                record.append(("reset", np.array(obs), info.get("lives")))
    return record, dict(raw.calls)


def _assert_same_record(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])
        assert x[2:] == y[2:]


WRAPPERS = {
    "noop": lambda m, env: m.NoopResetEnv(env, noop_max=5),
    "fire": lambda m, env: m.FireResetEnv(env, fire_action=1),
    "episodic_life": lambda m, env: m.EpisodicLifeEnv(env),
    "max_and_skip": lambda m, env: m.MaxAndSkipEnv(env, skip=4),
    "wrap_atari": lambda m, env: m.wrap_atari(env, noop_max=3, skip=2),
    "wrap_atari_no_fire": lambda m, env: m.wrap_atari(env, noop_max=7, skip=3, fire_reset=False),
}


@pytest.mark.parametrize("fake", [FakeALE, FakeALEImage])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_atari_wrappers_match_the_reference_exactly(wrapper, fake):
    actions = np.random.default_rng(0).integers(0, 4, 70)
    got, want = [], []
    for module, out in ((atari, got), (jax_atari, want)):
        raw = fake()
        env = WRAPPERS[wrapper](module, raw)
        out.append(_drive(env, raw, actions, seeds=(0, 3, 11)))
        out.append(type(env).__name__)
    (got_record, got_calls), got_type = got
    (want_record, want_calls), want_type = want
    _assert_same_record(got_record, want_record)
    assert got_calls == want_calls and got_type == want_type
    assert got_calls["step"] > 70


def test_atari_wrappers_keep_the_reference_behaviour():
    """The reference's own checks of each wrapper
    (tests/test_atari_and_puckworld.py:58-115), on the port's classes."""
    obs, _ = atari.NoopResetEnv(FakeALE(), noop_max=5).reset(seed=0)
    assert 1 <= obs[0, 0] <= 5
    raw = FakeALE()
    obs, _ = atari.FireResetEnv(raw, fire_action=1).reset(seed=0)
    assert raw.calls["step"] == 1 and obs[0, 0] == 1.0
    env = atari.MaxAndSkipEnv(FakeALE(), skip=4)
    env.reset(seed=0)
    obs, reward, *_ = env.step(0)
    assert reward == 4.0 and obs[0, 0] == 4.0
    raw = FakeALE()
    env = atari.EpisodicLifeEnv(raw)
    env.reset(seed=0)
    terms = [bool(env.step(0)[2]) for _ in range(10)]
    assert terms[-1] and not any(terms[:-1])
    resets = raw.calls["reset"]
    env.reset()
    assert raw.calls["reset"] == resets  # a life lost does not reset the emulator
    assert isinstance(atari.wrap_atari(FakeALE(), noop_max=3, skip=2), atari.FireResetEnv)


def _gym_trace(env, actions):
    """Every observation, reward and flag of `actions` from seed 5, an ended
    episode reset with seed 6."""
    out = [np.asarray(env.reset(seed=5)[1])]
    for a in actions:
        _, result = env.step(None, a)
        out.append((np.asarray(result.observation), float(result.reward),
                    bool(result.terminated), bool(result.truncated)))
        if bool(result.terminated) or bool(result.truncated):
            out.append(np.asarray(env.reset(seed=6)[1]))
    return out


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_gym_environment_matches_the_reference(env_id):
    mine, ref = GymEnvironment(env_id), JaxGymEnvironment(env_id)
    assert mine.observation_dim == ref.observation_dim
    np.testing.assert_array_equal(mine.observation_space.low.numpy(),
                                  np.asarray(ref.observation_space.low))
    np.testing.assert_array_equal(mine.observation_space.high.numpy(),
                                  np.asarray(ref.observation_space.high))
    if env_id == "CartPole-v1":
        assert mine.action_space.n == ref.action_space.n == 2
        actions = np.random.default_rng(1).integers(0, 2, 300).astype(np.float32)[:, None]
    else:
        np.testing.assert_array_equal(mine.action_space.low.numpy(),
                                      np.asarray(ref.action_space.low))
        np.testing.assert_array_equal(mine.action_space.high.numpy(),
                                      np.asarray(ref.action_space.high))
        actions = np.random.default_rng(1).uniform(-2, 2, (300, 1)).astype(np.float32)
    got, want = _gym_trace(mine, actions), _gym_trace(ref, actions)
    assert isinstance(mine.reset(seed=0)[1], torch.Tensor)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        if isinstance(x, tuple):
            np.testing.assert_array_equal(x[0], y[0])
            assert x[1:] == y[1:]
        else:
            np.testing.assert_array_equal(x, y)
    mine.close()
    ref.close()


def test_tabular_host_loop_matches_the_reference_on_frozen_lake():
    kw = dict(learning_rate=0.1, discount_factor=0.95, exploration_rate=0.2, seed=4)
    mine, ref = DictTabularQLearning(**kw), JaxDictTabularQLearning(**kw)
    got = online_learning_host(GymEnvironment("FrozenLake-v1"), mine, number_of_episodes=300,
                               seed=3)
    want = jax_online_learning_host(JaxGymEnvironment("FrozenLake-v1"), ref,
                                    number_of_episodes=300, seed=3)
    assert got == want and len(got) == 300 and sum(got) > 0
    assert mine.q_values == ref.q_values


def test_run_episode_host_refuses_a_device_env():
    with pytest.raises(TypeError, match="GymEnvironment"):
        run_episode_host(CartPole(), DictTabularQLearning())


def _small_dqn(q_network=None):
    kw = {} if q_network is None else {"q_network": q_network}
    return PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=16, **kw),
        replay_buffer=BasicReplayBuffer(capacity=512),
    )


@pytest.mark.parametrize("make_env", [lambda: GymEnvironment("CartPole-v1"), CartPole],
                         ids=["gym", "device"])
def test_agent_host_loop_runs_gym_and_device_envs(make_env):
    """tests/test_atari_and_puckworld.py:163-183 on the adapter and on the
    port's CartPole (a batch of one), with the multi-head DQN of bench.py."""
    for agent in (_small_dqn(), _small_dqn(MultiHeadQValueNetwork())):
        rets = agent_online_learning_host(agent, make_env(), max_steps=300,
                                          learn_every_k_steps=8, learning_starts=32, seed=0,
                                          device=CPU)
        assert len(rets) >= 1 and all(r >= 1.0 for r in rets)


@dataclasses.dataclass(frozen=True, eq=False)
class _RecordingAgent(PearlAgent):
    """A PearlAgent that records the window each act sees."""

    acted_on: list = dataclasses.field(default_factory=list)

    def act(self, astate, generator, exploit=False):
        self.acted_on.append(astate.history_carry.clone())
        return super().act(astate, generator, exploit)


class _RecordingGym(GymEnvironment):
    """A GymEnvironment that records every observation it resets to."""

    def __post_init__(self):
        super().__post_init__()
        self.resets = []

    def reset(self, seed=None):
        state, obs = super().reset(seed)
        self.resets.append(obs)
        return state, obs


def test_agent_host_loop_seeds_a_new_episode_with_its_reset_observation():
    """After an episode ends the agent acts on the observation the env was
    reset to (the reference acts on the terminal one)."""
    agent = _RecordingAgent(policy_learner=DeepQLearning(training_rounds=1, batch_size=16),
                            replay_buffer=BasicReplayBuffer(capacity=512))
    env = _RecordingGym("CartPole-v1")
    rets = agent_online_learning_host(agent, env, max_steps=120, learn_every_k_steps=8,
                                      learning_starts=32, seed=0, device=CPU)
    assert len(rets) >= 2 and len(env.resets) == len(rets) + 1
    firsts = np.cumsum([0] + [int(r) for r in rets])  # CartPole pays 1 a step
    for episode, step in enumerate(firsts):
        if step < len(agent.acted_on):
            torch.testing.assert_close(agent.acted_on[step][0], env.resets[episode],
                                       rtol=0, atol=0)


def test_composed_atari_pipeline_trains_a_cnn_dqn():
    """tests/test_atari_and_puckworld.py:208-258: NoopReset, MaxAndSkip,
    EpisodicLife, FireReset, Resize, Grayscale, FrameStack, the adapter and
    the host loop with a CNN-DQN, for 300 steps on the image fake."""
    raw = FakeALEImage()
    env = atari.wrap_atari(raw, noop_max=3, skip=2)
    env = gymnasium.wrappers.ResizeObservation(env, (16, 16))
    env = gymnasium.wrappers.GrayscaleObservation(env)
    env = gymnasium.wrappers.FrameStackObservation(env, 2)
    env = gymnasium.wrappers.TransformObservation(
        env, lambda o: np.transpose(np.asarray(o), (1, 2, 0)),
        gymnasium.spaces.Box(0, 255, (16, 16, 2), np.uint8),
    )
    env = GymEnvironment(env)
    agent = _small_dqn(CNNQValueNetwork(input_shape=(16, 16, 2), out_channels=(8, 8),
                                        kernel_sizes=(4, 3), strides=(2, 1), paddings=(0, 0),
                                        hidden_dims=(32,)))
    returns = agent_online_learning_host(agent, env, max_steps=300, learn_every_k_steps=8,
                                         learning_starts=64, seed=0, device=CPU)
    assert len(returns) >= 10
    assert all(np.isfinite(r) for r in returns)
    assert raw.calls["step"] >= 500 and raw.calls["reset"] >= 1
