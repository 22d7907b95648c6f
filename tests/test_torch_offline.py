"""Offline RL in the PyTorch port against the JAX package: Implicit
Q-Learning over three `learn_batch` steps on carried weights (continuous on
Pendulum's widths, discrete on CartPole's with and without an availability
mask, and with advantage weights that overflow to inf before the clamp), the
expectile loss, `offline_learning`'s chunks and logger, datasets written by
one package and read by the other (`.npz`, the reference's `.pt`, a
`file://` URL), `collect_offline_data`'s slot layout on a ring that wraps,
`mix_datasets`, `normalized_score`, and the offline benchmark end to end at
a tiny size. Every entry point runs with `device="cpu"`; the inputs are made
with numpy from a seed; the JAX side is jitted.

Tolerance: rtol 1e-4 / atol 1e-5 (the learners' parity tolerance: float32
sums in other orders, passed on by Adam over three steps).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.envs import Pendulum as JaxPendulum
from pearl_tpu.envs.misc import FixedNumberOfStepsEnvironment as JaxFixedSteps
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.policy_learners.sequential_decision_making import (
    ImplicitQLearning as JaxIQL,
)
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.training import offline as jax_offline
from pearl_tpu.training.collect import collect_offline_data as jax_collect
from pearl_tpu.utils.metrics import normalized_score as jax_normalized_score
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.benchmarks import mix_datasets, run_offline_rl_benchmark
from pearl_tpu_torch.envs import CartPole, FixedNumberOfStepsEnvironment, Pendulum
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    TD3BC,
    ContinuousSoftActorCritic,
    DeepQLearning,
    ImplicitQLearning,
    expectile_loss,
)
from pearl_tpu_torch.parallel import make_mesh
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import (
    collect_offline_data,
    get_offline_data_in_buffer,
    offline_evaluation,
    offline_learning,
    online_learning,
    save_offline_data,
    transitions_from_arrays,
)
from pearl_tpu_torch.utils.jax_params import load_flax_iql_state
from pearl_tpu_torch.utils.metrics import MetricsLogger, normalized_score
from pearl_tpu_torch.utils.pytree import compare
from tests.test_torch_actor_critic import _assert_adam_close, _assert_leaves_close, _port_leaves

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
B = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ IQL
IQL_CASES = {
    "continuous": ("pendulum", False, {}),
    "continuous_overflow": ("pendulum", False, {"temperature_advantage_weighted_regression": 1e4}),
    "discrete": ("cartpole", False, {}),
    "discrete_masked": ("cartpole", True, {}),
}


def _iql_pair(env_name, **overrides):
    kw = {"training_rounds": 1, "batch_size": B, **overrides}
    jspace = (JaxPendulum() if env_name == "pendulum" else JaxCartPole()).action_space
    tspace = (Pendulum() if env_name == "pendulum" else CartPole()).action_space
    obs_dim = 3 if env_name == "pendulum" else 4
    jl, tl = JaxIQL(**kw).bind(jspace), ImplicitQLearning(**kw).bind(tspace)
    jstate = jl.init(jax.random.PRNGKey(0), obs_dim, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), obs_dim, tl.action_space, 1, CPU)
    load_flax_iql_state(tstate, {
        "actor_params": _np_tree(jstate.actor_params),
        "critic_params": _np_tree(jstate.critic_params),
        "critic_target_params": _np_tree(jstate.critic_target_params),
        "value_params": _np_tree(jstate.extra.value_params),
    })
    return jl, jstate, tl, tstate, obs_dim


def _iql_batch(seed, env_name, obs_dim, masked):
    rng = np.random.default_rng(seed)
    if env_name == "pendulum":
        action = rng.uniform(-2, 2, (B, 1)).astype(np.float32)
        index = np.zeros(B, np.int32)
    else:
        index = rng.integers(0, 2, B).astype(np.int32)
        action = index[:, None].astype(np.float32)
    data = dict(
        state=rng.normal(size=(B, obs_dim)).astype(np.float32),
        action=action,
        reward=rng.normal(size=B).astype(np.float32),
        next_state=rng.normal(size=(B, obs_dim)).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.1,
        action_index=index,
    )
    if masked:
        # At least one action available in every row; some rows hide the
        # stored action, whose probability is then 0 and clipped at 1e-8.
        mask = rng.random((B, 2)) < 0.7
        mask[~mask.any(-1), 0] = True
        data["curr_available_mask"] = mask
    return (
        JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}),
        TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}),
    )


def _assert_iql_close(jstate, tstate):
    assert tstate.step == int(jstate.step)
    _assert_leaves_close(_port_leaves(tstate.actor_params), jstate.actor_params)
    _assert_leaves_close(_port_leaves(tstate.critic_params), jstate.critic_params)
    _assert_leaves_close(_port_leaves(tstate.critic_target_params), jstate.critic_target_params)
    _assert_leaves_close(_port_leaves(tstate.extra.value_params), jstate.extra.value_params)
    _assert_adam_close(tstate.actor_opt, tstate.actor_params, jstate.actor_opt)
    _assert_adam_close(tstate.critic_opt, tstate.critic_params, jstate.critic_opt)
    _assert_adam_close(tstate.extra.value_opt, tstate.extra.value_params, jstate.extra.value_opt)


@pytest.mark.parametrize("case", list(IQL_CASES))
def test_iql_learn_batch_matches_jax_over_three_steps(case):
    env_name, masked, overrides = IQL_CASES[case]
    jl, jstate, tl, tstate, obs_dim = _iql_pair(env_name, **overrides)
    _assert_iql_close(jstate, tstate)
    jax_learn = jax.jit(jl.learn_batch)
    for step in range(3):
        jbatch, tbatch = _iql_batch(step, env_name, obs_dim, masked)
        if case == "continuous_overflow":
            with torch.no_grad():
                q = tl._q_target_sa(tstate, tbatch.state, tbatch.action)
                v = tl.value_network.value(tstate.extra.value_params, tbatch.state)
            assert torch.isinf(torch.exp(1e4 * (q - v))).any()  # clamped to 100
        jstate, jmetrics = jax_learn(jstate, jbatch)
        tstate, tmetrics = tl.learn_batch(tstate, tbatch)
        assert set(tmetrics) == set(jmetrics) == {"actor_loss", "critic_loss", "value_loss"}
        for k in jmetrics:
            assert np.isfinite(tmetrics[k].item()), k
            np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), err_msg=k, **TOL)
        _assert_iql_close(jstate, tstate)


def test_iql_value_step_reads_the_new_target_and_the_actor_the_old_value():
    """The value net regresses the critic target as it is after the step's
    soft update, and the actor loss weighs with the value net from before
    its step (the two reads the order of the updates decides)."""
    _, _, tl, tstate, obs_dim = _iql_pair("pendulum")
    _, tbatch = _iql_batch(5, "pendulum", obs_dim, False)
    old_value = copy.deepcopy(tstate.extra.value_params)
    expected_actor = tl.actor_loss(tstate, tstate.actor_params, tbatch, tbatch.state, {})
    tstate, metrics = tl.learn_batch(tstate, tbatch)
    torch.testing.assert_close(metrics["actor_loss"], expected_actor.detach(), rtol=0, atol=0)
    with torch.no_grad():
        q = tl.critic_network.q_min(tstate.critic_target_params, tbatch.state, tbatch.action)
        expected = expectile_loss(q, tl.value_network.value(old_value, tbatch.state), 0.75)
    torch.testing.assert_close(metrics["value_loss"], expected, rtol=0, atol=0)
    new_value = tstate.extra.value_params.parameters()
    assert all(not torch.equal(a, b) for a, b in zip(old_value.parameters(), new_value))


def test_expectile_loss_on_given_q_and_v():
    q = torch.tensor([1.0, 0.0, 2.0, -1.0])
    v = torch.tensor([0.0, 0.0, 3.0, 1.0])
    # u = (1, 0, -1, -2): weights 0.75, 0.75, 0.25, 0.25.
    expected = (0.75 * 1 + 0.0 + 0.25 * 1 + 0.25 * 4) / 4
    assert expectile_loss(q, v, 0.75).item() == pytest.approx(expected, rel=1e-7)
    rng = np.random.default_rng(0)
    qn, vn = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    u = qn - vn
    ref = np.mean(np.abs(0.9 - (u < 0)) * u**2)
    got = expectile_loss(torch.from_numpy(qn), torch.from_numpy(vn), 0.9).item()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_iql_pmean_axis_raises():
    # A bare axis name is a TypeError; the axis of a mesh of one rank
    # averages nothing: the learn step (the value net's included) is the
    # step without it, bit for bit.
    with pytest.raises(TypeError, match="make_mesh"):
        ImplicitQLearning(pmean_axis="dp")
    _, _, tl, tstate, obs_dim = _iql_pair("pendulum")
    alone = copy.deepcopy(tstate)
    _, tbatch = _iql_batch(5, "pendulum", obs_dim, False)
    with make_mesh(1, device="cpu") as mesh:
        tstate, metrics = dataclasses.replace(tl, pmean_axis=mesh.axis("data")).learn_batch(
            tstate, tbatch)
    alone, alone_metrics = tl.learn_batch(alone, tbatch)
    assert compare(tstate, alone, rtol=0, atol=0) == ""
    assert all(torch.equal(metrics[k], alone_metrics[k]) for k in metrics)


def test_discrete_iql_moves_its_value_net_in_every_learn_of_online_learning():
    env = CartPole()
    agent = PearlAgent(
        policy_learner=ImplicitQLearning(training_rounds=1, batch_size=16),
        replay_buffer=BasicReplayBuffer(capacity=256),
    )
    # 64 steps of 8 envs in chunks of 2: 4 chunks, the first before
    # learning starts.
    res = online_learning(agent, env, num_envs=8, max_steps=64, learn_every_k_steps=2,
                          learning_starts=16, seed=0, device="cpu")
    astate, bound = res.agent_state, agent.for_env(env)
    assert astate.learner.step == 3
    generator = torch.Generator().manual_seed(1)
    for _ in range(3):
        before = copy.deepcopy(astate.learner.extra.value_params)
        astate, metrics = bound.learn(astate, generator)
        assert set(metrics) == {"actor_loss", "critic_loss", "value_loss"}
        assert all(torch.isfinite(v).all() for v in metrics.values())
        after = astate.learner.extra.value_params.parameters()
        assert all(not torch.equal(a, b) for a, b in zip(before.parameters(), after))
    assert astate.learner.step == 6


# ------------------------------------------------------------ datasets
def _dataset_arrays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        state=rng.normal(size=(n, 4)).astype(np.float32),
        action=rng.integers(0, 2, (n, 1)).astype(np.float32),
        reward=rng.normal(size=n).astype(np.float32),
        next_state=rng.normal(size=(n, 4)).astype(np.float32),
        terminated=rng.random(n) < 0.1,
        cost=rng.random(n).astype(np.float64),  # narrowed to float32 by both
        curr_available_mask=rng.random((n, 2)) < 0.8,
    )


def _assert_storage_equal(port_state, jax_state):
    for f in dataclasses.fields(TransitionBatch):
        mine, ref = getattr(port_state.storage, f.name), getattr(jax_state.storage, f.name)
        assert (mine is None) == (ref is None), f.name
        if mine is not None:
            ref = np.asarray(ref)
            assert mine.numpy().dtype == ref.dtype, f.name
            np.testing.assert_array_equal(mine.numpy(), ref, err_msg=f.name)
    assert port_state.size == int(jax_state.size)


def test_npz_written_by_jax_loads_in_the_port_and_the_reverse(tmp_path):
    arrays = _dataset_arrays()
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_offline.save_offline_data(jax_path, jax_offline.transitions_from_arrays(**arrays))
    save_offline_data(port_path, transitions_from_arrays(**arrays, device="cpu"))
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in (jax_path, port_path):
        buffer, state = get_offline_data_in_buffer(path, device="cpu")
        _, jstate = jax_offline.get_offline_data_in_buffer(path)
        assert buffer.capacity == 64
        _assert_storage_equal(state, jstate)


def test_reference_pt_file_url_and_missing_files(tmp_path):
    rng = np.random.default_rng(3)
    rows = [
        {
            "observation": torch.tensor(rng.normal(size=4), dtype=torch.float32),
            "action": torch.tensor(float(rng.integers(0, 2))),
            "reward": torch.tensor(float(rng.normal())),
            "next_observation": torch.tensor(rng.normal(size=4), dtype=torch.float32),
            "terminated": torch.tensor(bool(rng.random() < 0.2)),
        }
        for _ in range(32)
    ]
    path = str(tmp_path / "data.pt")
    torch.save(rows, path)
    _, state = get_offline_data_in_buffer(path, device="cpu")
    _, jstate = jax_offline.get_offline_data_in_buffer(path)
    _assert_storage_equal(state, jstate)
    assert state.storage.state.shape == (32, 4) and state.storage.action.shape == (32, 1)
    assert not state.storage.truncated.any()
    _, url_state = get_offline_data_in_buffer("file://" + path, device="cpu")
    _assert_storage_equal(url_state, jstate)
    with pytest.raises(RuntimeError, match="local path"):
        get_offline_data_in_buffer("file:///nonexistent/dir/data_123.npz", device="cpu")
    with pytest.raises(FileNotFoundError):
        get_offline_data_in_buffer(str(tmp_path / "missing.npz"), device="cpu")


# ------------------------------------------------------------ training
def _cql_agent_and_buffer(n=256):
    arrays = _dataset_arrays(n)
    del arrays["cost"], arrays["curr_available_mask"]
    batch = transitions_from_arrays(**arrays, device="cpu")
    buffer = BasicReplayBuffer(capacity=n)
    buf_state = buffer.push(buffer.init(batch), batch)
    env = CartPole()
    agent = PearlAgent(
        policy_learner=DeepQLearning(is_conservative=True, conservative_alpha=1.0)
    ).for_env(env)
    astate = agent.init(0, 4, 1, torch.zeros(1, 4), device="cpu")
    return env, agent, astate, buffer, buf_state


@pytest.mark.parametrize("batches,expected", [(20, 20), (25, 30)])
def test_offline_learning_runs_whole_chunks_and_logs_each(batches, expected):
    env, agent, astate, buffer, buf_state = _cql_agent_and_buffer()
    logged = []
    astate = offline_learning(
        agent, astate, buffer, buf_state, number_of_batches=batches, batch_size=32,
        log_every=10, logger=lambda m, i: logged.append((i, m)),
    )
    assert astate.learner.step == expected
    assert [i for i, _ in logged] == list(range(10, expected + 1, 10))
    for _, metrics in logged:
        assert "loss" in metrics
        assert all(np.isfinite(v) and np.ndim(v) == 0 for v in metrics.values())
    returns = offline_evaluation(agent, astate, env, num_envs=4, max_steps=4 * 64, device="cpu")
    assert len(returns) > 0 and np.isfinite(returns).all()


def test_offline_learning_is_reproducible_from_its_seed():
    def run(seed):
        _, agent, astate, buffer, buf_state = _cql_agent_and_buffer()
        astate = offline_learning(agent, astate, buffer, buf_state, number_of_batches=10,
                                  batch_size=32, log_every=5, seed=seed)
        return [p.detach().clone() for p in astate.learner.params.parameters()]

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_metrics_logger_and_normalized_score(tmp_path):
    path = str(tmp_path / "sub" / "m.jsonl")
    log = MetricsLogger(path)
    log.log(3, {"loss": torch.tensor(0.5), "ret": np.float32(-2.0), "n": 4})
    log.close()
    assert log.records[0]["loss"] == 0.5 and log.records[0]["n"] == 4.0
    with open(path) as fh:
        assert '"step": 3' in fh.read()
    for args in [(50.0, 0.0, 100.0), (-300.0, -1200.0, -150.0), (7.0, 3.0, 3.0), (1.0, 2.0, 0.5)]:
        assert normalized_score(*args) == jax_normalized_score(*args)


def test_mix_datasets_fractions():
    def mk(v, n):
        return transitions_from_arrays(
            state=np.full((n, 3), v, np.float32), action=np.zeros((n, 1), np.float32),
            reward=np.full((n,), v, np.float32), next_state=np.zeros((n, 3), np.float32),
            terminated=np.zeros((n,), bool), device="cpu",
        )

    mixed = mix_datasets([mk(1.0, 100), mk(2.0, 100)], [0.25, 0.75], 100)
    assert mixed.reward.shape == (100,) and mixed.curr_available_mask is None
    assert int((mixed.reward == 1.0).sum()) == 25 and int((mixed.reward == 2.0).sum()) == 75
    assert torch.equal(mixed.reward[:25], torch.ones(25))


# ----------------------------------------------------------- collection
def test_collect_offline_data_holds_jax_rows_in_jax_slots_when_the_ring_wraps(tmp_path):
    """48 transitions from 4 envs: two chunks of 8 steps write 64 rows, so
    the last 16 wrap over slots 0-15 and the buffer is not in time order.
    The counting env makes every row's step visible."""
    kw = dict(num_transitions=48, num_envs=4, seed=3)
    jbatch = jax_collect(
        JaxAgent(policy_learner=JaxDQN(training_rounds=1, batch_size=8)), JaxFixedSteps(5), **kw
    )
    path = str(tmp_path / "c.npz")
    batch = collect_offline_data(
        PearlAgent(policy_learner=DeepQLearning(training_rounds=1, batch_size=8)),
        FixedNumberOfStepsEnvironment(5), save_path=path, device="cpu", **kw,
    )
    assert batch.reward.shape == (48,)
    for name in ("state", "next_state", "terminated", "truncated"):
        np.testing.assert_array_equal(
            getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)), err_msg=name
        )
    # Slots 0-15 hold the run's last 16 rows, slots 16-47 its rows 16-47:
    # what 64 slots hold at 48-63 and 16-47.
    whole = collect_offline_data(
        PearlAgent(policy_learner=DeepQLearning(training_rounds=1, batch_size=8)),
        FixedNumberOfStepsEnvironment(5), device="cpu", **{**kw, "num_transitions": 64},
    )
    assert torch.equal(batch.next_state[:16], whole.next_state[48:])
    assert torch.equal(batch.next_state[16:], whole.next_state[16:48])
    assert not torch.equal(batch.next_state[:16], whole.next_state[:16])
    _, state = get_offline_data_in_buffer(path, device="cpu")
    assert state.size == 48 and torch.equal(state.storage.state, batch.state)


def test_collect_offline_data_from_a_trained_learner_state():
    agent = PearlAgent(policy_learner=DeepQLearning(training_rounds=1, batch_size=8)).for_env(
        CartPole()
    )
    astate = agent.init(0, 4, 2, torch.zeros(2, 4), device="cpu")  # 2 envs, collected on 4
    batch = collect_offline_data(
        agent, CartPole(), num_transitions=64, num_envs=4, learner_state=astate.learner,
        exploit=True, device="cpu",
    )
    assert batch.state.shape == (64, 4) and torch.isfinite(batch.state).all()


# ------------------------------------------------------------ benchmark
def test_offline_rl_benchmark_end_to_end_at_a_tiny_size():
    results = run_offline_rl_benchmark(
        env_factory=Pendulum,
        behavior_agent_factory=lambda: PearlAgent(
            policy_learner=ContinuousSoftActorCritic(training_rounds=1, batch_size=64)
        ),
        offline_agent_factories={
            "IQL": lambda: PearlAgent(
                policy_learner=ImplicitQLearning(training_rounds=1, batch_size=64)
            ),
            "TD3BC": lambda: PearlAgent(policy_learner=TD3BC(training_rounds=1, batch_size=64)),
        },
        behavior_steps=2_048, dataset_size=1_024, expert_fraction=0.5, offline_batches=100,
        offline_batch_size=64, num_envs=8, eval_steps=1_600, seed=0, device="cpu",
    )
    anchors = results.pop("__anchors__")
    assert np.isfinite(anchors.returns).all()
    assert set(results) == {"IQL", "TD3BC"}
    for name, r in results.items():
        assert len(r.returns) > 0 and np.isfinite(r.raw_return), name
        assert -2000.0 < r.raw_return <= 0.0, name
        assert np.isfinite(r.normalized), name
