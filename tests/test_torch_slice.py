"""The first slice of the PyTorch port as a whole: the agent against the JAX
agent on carried weights (exploit-mode acting, observe into replay, one learn
on the same indices), the two drivers at a tiny size on the CPU, the
no-silent-fallback rule of the entry points, and import hygiene (the port
and chip_smoke.py import nothing of JAX or of the JAX package).
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.envs.cartpole import CartPole as JaxCartPole
from pearl_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from pearl_tpu.neural_networks.q_value_networks import MultiHeadQValueNetwork as JaxMultiHead
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.utils.pytree import tree_select as jax_tree_select
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole, CartPoleState, VectorEnv
from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
from pearl_tpu_torch.ops.fused_mlp import fused_mlp
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import load_flax_q_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# float32 env physics and network math, summed in other orders (see
# test_torch_envs.py and test_torch_dqn.py for the per-piece tolerances).
TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")


def _agents(B=8, rounds=2, batch=16, capacity=64):
    jagent = JaxAgent(
        policy_learner=JaxDQN(q_network=JaxMultiHead(), training_rounds=rounds, batch_size=batch),
        replay_buffer=JaxBuffer(capacity=capacity),
    ).for_env(JaxCartPole())
    tagent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=rounds, batch_size=batch
        ),
        replay_buffer=BasicReplayBuffer(capacity=capacity),
    ).for_env(CartPole())
    return jagent, tagent


def test_agent_acts_observes_and_learns_like_the_jax_agent():
    B, T = 8, 6
    rng = np.random.default_rng(0)
    physics = rng.uniform(-0.05, 0.05, (B, 4)).astype(np.float32)
    physics[0] = [2.39, 1.0, 0.0, 0.0]  # terminates on the first step
    t0 = np.zeros(B, np.int32)
    t0[1] = 497  # truncates on the third step
    jagent, tagent = _agents(B)
    jastate = jagent.init(jax.random.PRNGKey(0), 4, B, jnp.asarray(physics))
    tastate = tagent.init(0, 4, B, torch.from_numpy(physics), device="cpu")
    weights = jax.tree.map(np.asarray, jastate.learner.params)
    load_flax_q_params(tastate.learner.params, weights)
    load_flax_q_params(tastate.learner.target_params, weights)

    jenv, venv = JaxCartPole(), VectorEnv(CartPole(), B, CPU)
    jstates = JaxCartPoleState(physics=jnp.asarray(physics), t=jnp.asarray(t0))
    tstates = CartPoleState(torch.from_numpy(physics), torch.from_numpy(t0))
    key = jax.random.PRNGKey(1)
    saw_done = False
    for step in range(T):
        key, k_act, k_env, k_obs = jax.random.split(key, 4)
        jastate, jchoice = jagent.act(jastate, k_act, exploit=True)
        tastate, tchoice = tagent.act(tastate, None, exploit=True)
        np.testing.assert_array_equal(tchoice.index.numpy(), np.asarray(jchoice.index))
        np.testing.assert_array_equal(tchoice.action.numpy(), np.asarray(jchoice.action))

        fresh = rng.uniform(-0.05, 0.05, (B, 4)).astype(np.float32)
        jfresh = JaxCartPoleState(physics=jnp.asarray(fresh), t=jnp.zeros(B, jnp.int32))
        jnew, jres = jax.vmap(jenv.step)(jstates, jchoice.action, jax.random.split(k_env, B))
        jstates = jax_tree_select(jres.done, jfresh, jnew)
        jnext_obs = jax_tree_select(jres.done, jfresh.physics, jres.observation)
        tstates, tres, tnext_obs = venv.step(
            tstates,
            tchoice.action,
            fresh=(CartPoleState(torch.from_numpy(fresh), torch.zeros(B, dtype=torch.int32)),
                   torch.from_numpy(fresh)),
        )
        np.testing.assert_array_equal(tres.done.numpy(), np.asarray(jres.done))
        saw_done |= bool(tres.done.any())
        jastate = jagent.observe(jastate, jres, jnext_obs, k_obs)
        tastate = tagent.observe(tastate, tres, tnext_obs)
    assert saw_done

    jrep, trep = jastate.replay, tastate.replay
    assert trep.size == int(jrep.size) == B * T and trep.cursor == int(jrep.cursor)
    for f in ("state", "next_state", "reward", "action"):
        np.testing.assert_allclose(
            getattr(trep.storage, f).numpy(), np.asarray(getattr(jrep.storage, f)), **TOL
        )
    for f in ("terminated", "truncated", "action_index"):
        np.testing.assert_array_equal(
            getattr(trep.storage, f).numpy(), np.asarray(getattr(jrep.storage, f))
        )
    np.testing.assert_allclose(
        tastate.history_carry.numpy(), np.asarray(jastate.history_carry), **TOL
    )

    # One learn: the JAX agent's sampled rows (pearl_agent.py:416,
    # policy_learner.py:182, replay_buffer.py:130) handed to the port.
    learn_key = jax.random.PRNGKey(7)
    k_l, _ = jax.random.split(learn_key)
    idx = np.stack([
        np.asarray(jax.random.randint(k, (16,), 0, max(int(jrep.size), 1)))
        for k in jax.random.split(k_l, 2)
    ])
    jastate, jmetrics = jagent.learn(jastate, learn_key)
    tastate, tmetrics = tagent.learn(tastate, None, indices=torch.from_numpy(idx).long())
    np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), **TOL)
    for name, layer in zip(
        tastate.learner.params.MLP_0.layer_names, tastate.learner.params.MLP_0.layers()
    ):
        ref = jastate.learner.params["MLP_0"][name]
        np.testing.assert_allclose(layer.weight.detach().numpy().T, np.asarray(ref["kernel"]), **TOL)
        np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(ref["bias"]), **TOL)
    assert tastate.learner.step == int(jastate.learner.step) == 2


def test_runner_runs_on_cpu_at_a_tiny_size():
    num_envs, spl, lpc, rounds = 32, 4, 3, 2
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=rounds, batch_size=16
        ),
        replay_buffer=BasicReplayBuffer(capacity=1024),
    )
    init_fn, run_fn = make_compiled_runner(
        agent, CartPole(), num_envs=num_envs, steps_per_learn=spl, learns_per_call=lpc,
        device="cpu",
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, CPU)
    before = fused_mlp.launches
    for call in range(2):
        astate, env_states, stats = run_fn(astate, env_states, gen)
        assert stats["reward_sum"].item() == spl * lpc * num_envs  # reward 1.0 per env step
        assert stats["episodes"].dtype == torch.int64 and stats["episodes"].item() >= 0
    assert fused_mlp.launches == before  # CPU tensors run the plain chain
    assert astate.replay.size == 2 * spl * lpc * num_envs
    assert astate.learner.step == 2 * lpc * rounds
    assert astate.learner.explore_state == 2 * spl * lpc * num_envs
    assert env_states.physics.shape == (num_envs, 4)


def _online_agent():
    return PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=2, batch_size=16,
            exploration=EGreedyExploration(epsilon=0.1),
        ),
        replay_buffer=BasicReplayBuffer(capacity=512),
    )


def test_online_learning_runs_on_cpu_with_learning_starts():
    res = online_learning(
        _online_agent(), CartPole(), num_envs=8, max_steps=2000, learn_every_k_steps=2,
        learning_starts=200, seed=3, device="cpu",
    )
    assert res.total_steps == 2000 and not res.reached_target
    assert len(res.episode_returns) == res.total_episodes > 0
    assert ((res.episode_returns >= 1) & (res.episode_returns <= 500)).all()
    np.testing.assert_array_equal(res.episode_costs, 0.0)
    # 13 warm chunks (total < 200 before each), then 112 learning chunks.
    assert res.agent_state.learner.step == 112 * 2

    again = online_learning(
        _online_agent(), CartPole(), num_envs=8, max_steps=2000, learn_every_k_steps=2,
        learning_starts=200, seed=3, device="cpu",
    )
    np.testing.assert_array_equal(again.episode_returns, res.episode_returns)  # seeded


def test_online_learning_dispatch_size_does_not_change_the_run():
    # One generator is consumed in the same order however many chunks a
    # dispatch holds, so the episodes and the learned weights are the same.
    runs = [
        online_learning(
            _online_agent(), CartPole(), num_envs=8, max_steps=1024, learn_every_k_steps=2,
            chunks_per_dispatch=c, seed=5, device="cpu",
        )
        for c in (1, 4)
    ]
    assert runs[0].total_steps == runs[1].total_steps == 1024
    np.testing.assert_array_equal(runs[0].episode_returns, runs[1].episode_returns)
    for a, b in zip(
        runs[0].agent_state.learner.params.parameters(),
        runs[1].agent_state.learner.params.parameters(),
    ):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_online_learning_stops_early_and_resumes_from_a_state():
    res = online_learning(
        _online_agent(), CartPole(), num_envs=8, max_steps=100_000, learn_every_k_steps=2,
        seed=0, target_return=5.0, target_window=3, device="cpu",
    )
    assert res.reached_target and res.total_steps < 1000
    assert np.mean(res.episode_returns[-3:]) >= 5.0
    evaluated = online_learning(
        _online_agent(), CartPole(), num_envs=4, max_steps=400, exploit=True, learn=False,
        agent_state=res.agent_state, seed=1, device="cpu",
    )
    assert evaluated.total_steps == 400
    assert evaluated.agent_state.learner.step == res.agent_state.learner.step
    assert evaluated.agent_state.history_carry.shape == (4, 4)


@pytest.mark.parametrize(
    "kwargs",
    [{"stats": "summary"}, {"stats": "curves"}, {"mesh": object()}, {"deferred_push": True}],
)
def test_online_learning_modes_not_ported_raise(kwargs):
    with pytest.raises(NotImplementedError):
        online_learning(_online_agent(), CartPole(), max_steps=16, device="cpu", **kwargs)


def test_frame_ring_path_raises():
    @dataclasses.dataclass(frozen=True)
    class FrameRing:
        is_frame_ring: bool = True

    with pytest.raises(NotImplementedError, match="visual slice"):
        PearlAgent(policy_learner=DeepQLearning(history_summarizer=FrameRing()))


def test_entry_points_without_device_raise_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    agent = _online_agent()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_compiled_runner(agent, CartPole(), num_envs=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        online_learning(agent, CartPole(), num_envs=4, max_steps=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        agent.for_env(CartPole()).init(0, 4, 4, torch.zeros(4, 4))


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "pearl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    banned = ("jax", "flax", "optax", "pearl_tpu")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in banned, f"{path.relative_to(REPO)} imports {name}"
