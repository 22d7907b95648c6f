"""The slices of the PyTorch port as wholes: the DQN agent and the visual
CNN-DQN agent (frame ring, dedup replay) against the JAX agents on carried
weights (exploit-mode acting, observe into replay, one learn on the same
rows), the runner and `online_learning` at a tiny size on the CPU, the
no-silent-fallback rule of the entry points, and import hygiene (the port and
chip_smoke.py import nothing of JAX or of the JAX package).
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
from pearl_tpu.api.types import ActionResult as JaxActionResult
from pearl_tpu.envs.synthetic_visual import SyntheticAtari as JaxSyntheticAtari
from pearl_tpu.history_summarization_modules import FrameRingHistorySummarization as JaxFrameRing
from pearl_tpu.neural_networks.q_value_networks import CNNQValueNetwork as JaxCNN
from pearl_tpu.replay_buffers.visual import VisualReplayBuffer as JaxVisual
from pearl_tpu.envs.cartpole import CartPole as JaxCartPole
from pearl_tpu.envs.cartpole import CartPoleState as JaxCartPoleState
from pearl_tpu.neural_networks.q_value_networks import MultiHeadQValueNetwork as JaxMultiHead
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.utils.pytree import tree_select as jax_tree_select
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs import CartPole, CartPoleState, SyntheticAtari, VectorEnv
from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
from pearl_tpu_torch.neural_networks import CNNQValueNetwork, MultiHeadQValueNetwork
from pearl_tpu_torch.neural_networks.q_value_networks import VanillaQValueNetwork
from pearl_tpu_torch.ops.conv_cache import cache_write
from pearl_tpu_torch.ops.fused_mlp import fused_mlp
from pearl_tpu_torch.ops.layout_fence import copy_fence, masked_scale_fence4
from pearl_tpu_torch.ops.ring_conv import ring_conv1
from pearl_tpu_torch.ops.ring_write import ring_write, ring_write_where
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, VisualReplayBuffer
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import load_flax_cnn_q_params, load_flax_q_params

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


@pytest.mark.parametrize("write", ["copy_", "load_state_dict", "replace", "learn"])
def test_act_dtype_copy_follows_every_write_of_the_params(write):
    B = 8
    learner = DeepQLearning(
        q_network=VanillaQValueNetwork(), training_rounds=1, batch_size=16, act_dtype="bfloat16"
    )
    tagent = PearlAgent(
        policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=64)
    ).for_env(CartPole())
    rng = np.random.default_rng(0)
    obs = torch.from_numpy(rng.uniform(-0.05, 0.05, (B, 4)).astype(np.float32))
    astate = tagent.init(0, 4, B, obs, device="cpu")
    learner = tagent.policy_learner
    state = astate.learner

    def scores(state):
        with torch.no_grad():
            return learner._scores(state, obs, None)

    before = scores(state)
    cast_module = state.act_params
    stamp = cast_module._cast_of
    assert torch.equal(scores(state), before) and cast_module._cast_of == stamp  # no recast
    other = learner.q_network.init(make_generator(5, CPU), 4, 2, 2)
    if write == "copy_":
        with torch.no_grad():
            for p, q in zip(state.params.parameters(), other.parameters()):
                p.copy_(q)
    elif write == "load_state_dict":
        state.params.load_state_dict(other.state_dict())
    elif write == "replace":
        state = dataclasses.replace(state, params=other)
    else:
        astate, _ = tagent.act(astate, None, exploit=True)
        result = ActionResult(
            observation=obs, reward=torch.ones(B),
            terminated=torch.zeros(B, dtype=torch.bool), truncated=torch.zeros(B, dtype=torch.bool),
        )
        astate = tagent.observe(astate, result, obs)
        astate, _ = tagent.learn(astate, make_generator(1, CPU))
        state = astate.learner
    after = scores(state)
    assert not torch.equal(after, before)
    for cast, p in zip(cast_module.parameters(), state.params.parameters()):
        assert cast.dtype == torch.bfloat16 and torch.equal(cast, p.detach().to(torch.bfloat16))
    # The acting scores are those of the bfloat16 cast of the new params.
    q = learner.q_network.q_all(
        cast_module, obs.to(torch.bfloat16), learner._candidates(state, B).to(torch.bfloat16), None
    )
    assert torch.equal(after, q.detach().to(torch.float32))


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


@pytest.mark.parametrize("kwargs", [{"mesh": object()}])
def test_online_learning_modes_not_ported_raise(kwargs):
    with pytest.raises(NotImplementedError, match="item 20"):
        online_learning(_online_agent(), CartPole(), max_steps=16, device="cpu", **kwargs)


def test_frame_ring_path_raises():
    # A frame-ring summarizer is accepted only with a frame-push replay
    # buffer and a ring-aware Q-network; anything else is a TypeError at
    # construction, as in the JAX agent (whose check runs at first use).
    summ = FrameRingHistorySummarization(history_length=4)
    ring_net = CNNQValueNetwork(input_shape=(20, 20, 4), time_major_stack=True)
    visual = VisualReplayBuffer(capacity=64, stack=4, num_envs=8)
    with pytest.raises(TypeError, match="frame-push replay"):
        PearlAgent(policy_learner=DeepQLearning(q_network=ring_net, history_summarizer=summ))
    with pytest.raises(TypeError, match="ring-aware"):
        PearlAgent(policy_learner=DeepQLearning(history_summarizer=summ), replay_buffer=visual)
    with pytest.raises(TypeError, match="ring-aware"):
        PearlAgent(
            policy_learner=DeepQLearning(
                q_network=CNNQValueNetwork(input_shape=(20, 20, 4)), history_summarizer=summ
            ),
            replay_buffer=visual,
        )
    jagent = JaxAgent(policy_learner=JaxDQN(history_summarizer=JaxFrameRing(history_length=4)))
    with pytest.raises(TypeError, match="frame-push replay"):
        jagent._frame_path
    agent = PearlAgent(
        policy_learner=DeepQLearning(q_network=ring_net, history_summarizer=summ),
        replay_buffer=visual,
    )
    assert agent._frame_path and not _online_agent()._frame_path
    with pytest.raises(ValueError, match="deferred"):
        agent.observe_deferred(None, None, None)
    # The two opt-in act paths construct on the frame path; a configuration
    # they do not take is a ValueError at construction.
    for option in ("conv1_cache", "ring_conv"):
        net = CNNQValueNetwork(input_shape=(20, 20, 4), time_major_stack=True, **{option: True})
        opted = PearlAgent(
            policy_learner=DeepQLearning(q_network=net, history_summarizer=summ),
            replay_buffer=visual,
        )
        assert opted._frame_path and (opted._cache_net is net) == (option == "conv1_cache")
        with pytest.raises(ValueError, match=option):
            CNNQValueNetwork(
                input_shape=(20, 20, 16), time_major_stack=True, frame_channels=4, **{option: True}
            )
    assert agent._cache_net is None

    @dataclasses.dataclass(frozen=True)
    class FrameRing:
        is_frame_ring: bool = True

    with pytest.raises(TypeError, match="frame-push replay"):
        PearlAgent(policy_learner=DeepQLearning(history_summarizer=FrameRing()))


VIS = dict(H=20, W=20, T=4, B=6, A=6, batch=16)


def _visual_agents(ring_tdtype=None, ring_jdtype=None, act_dtype=None, T=VIS["T"]):
    H, W, B = VIS["H"], VIS["W"], VIS["B"]
    net = dict(input_shape=(H, W, T), time_major_stack=True, hidden_dims=(24,))
    buf = dict(capacity=8 * B, stack=T, num_envs=B, dedup_next=True)
    learner = dict(training_rounds=1, batch_size=VIS["batch"], act_dtype=act_dtype)
    jagent = JaxAgent(
        policy_learner=JaxDQN(
            q_network=JaxCNN(**net),
            history_summarizer=JaxFrameRing(history_length=T, dtype=ring_jdtype), **learner,
        ),
        replay_buffer=JaxVisual(frame_dtype=ring_jdtype, **buf),
    )
    tagent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(**net),
            history_summarizer=FrameRingHistorySummarization(history_length=T, dtype=ring_tdtype),
            **learner,
        ),
        replay_buffer=VisualReplayBuffer(frame_dtype=ring_tdtype, **buf),
    )
    env = dict(height=H, width=W, frames=1, num_actions=VIS["A"])
    return jagent.for_env(JaxSyntheticAtari(**env)), tagent.for_env(SyntheticAtari(**env))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


@pytest.mark.parametrize(
    "ring_tdtype,ring_jdtype,act_dtype,T",
    [
        (None, None, None, 4),
        (torch.bfloat16, jnp.bfloat16, "bfloat16", 4),
        # A window of one frame: the slot the acting frame is read from is
        # the slot the step writes, so the read must come first.
        (None, None, None, 1),
    ],
)
def test_visual_agent_acts_observes_and_learns_like_the_jax_agent(
    ring_tdtype, ring_jdtype, act_dtype, T
):
    H, W, B, A = VIS["H"], VIS["W"], VIS["B"], VIS["A"]
    F, steps = H * W, 11
    rng = np.random.default_rng(0)
    jagent, tagent = _visual_agents(ring_tdtype, ring_jdtype, act_dtype, T)
    first = rng.uniform(0, 255, (B, F)).astype(np.float32)
    jastate = jagent.init(jax.random.PRNGKey(0), F, B, jnp.asarray(first))
    tastate = tagent.init(0, F, B, torch.from_numpy(first), device="cpu")
    weights = jax.tree.map(np.asarray, jastate.learner.params)
    for module in (tastate.learner.params, tastate.learner.target_params):
        load_flax_cnn_q_params(module, weights)
    if act_dtype:
        # The loaded weights reach the acting copy with no help from the caller.
        cast_module = tagent.policy_learner._act_module(tastate.learner)
        for cast, p in zip(cast_module.parameters(), tastate.learner.params.parameters()):
            assert cast.dtype == torch.bfloat16
            assert torch.equal(cast, p.detach().to(torch.bfloat16))

    jlearner, tlearner = jagent.policy_learner, tagent.policy_learner
    key = jax.random.PRNGKey(1)
    for step in range(steps):
        key, k_act, k_obs = jax.random.split(key, 3)
        jscores = jlearner._scores(
            jastate.learner, jagent.subjective_state(jastate), jlearner.represented_candidates(B), None
        )
        with torch.no_grad():
            tscores = tlearner._scores(tastate.learner, tagent.subjective_state(tastate), None)
        assert tscores.dtype == torch.float32 and tscores.shape == (B, A)
        if act_dtype:
            # bfloat16 forward in both packages (see test_torch_cnn.py): 3e-2.
            np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=0, atol=3e-2)
        else:
            np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-5)
        jastate, jchoice = jagent.act(jastate, k_act, exploit=True)
        tastate, tchoice = tagent.act(tastate, None, exploit=True)
        if not act_dtype:
            np.testing.assert_array_equal(tchoice.index.numpy(), np.asarray(jchoice.index))
        # The same actions go into both replays whatever a near-tie did.
        tastate.last_action = ActionChoice(
            action=torch.from_numpy(np.array(jchoice.action)),
            index=torch.from_numpy(np.array(jchoice.index)),
        )

        obs = rng.uniform(0, 255, (B, F)).astype(np.float32)
        fresh = rng.uniform(0, 255, (B, F)).astype(np.float32)
        reward = rng.uniform(0, 1, B).astype(np.float32)
        terminated = np.zeros(B, bool)
        truncated = np.zeros(B, bool)
        terminated[0] = step in (2, 7)
        truncated[1] = step == 4
        truncated[:] |= step == 8  # every env at once, as a lockstep time limit
        truncated &= ~terminated
        done = terminated | truncated
        next_obs = np.where(done[:, None], fresh, obs)
        jres = JaxActionResult(
            observation=jnp.asarray(obs), reward=jnp.asarray(reward),
            terminated=jnp.asarray(terminated), truncated=jnp.asarray(truncated),
        )
        tres = ActionResult(
            observation=torch.from_numpy(obs), reward=torch.from_numpy(reward),
            terminated=torch.from_numpy(terminated), truncated=torch.from_numpy(truncated),
        )
        jastate = jagent.observe(jastate, jres, jnp.asarray(next_obs), k_obs)
        tastate = tagent.observe(tastate, tres, torch.from_numpy(next_obs))

        jview, tview = jastate.history_carry, tastate.history_carry
        assert tview.cursor == int(jview.cursor) == (step + 2) % T
        np.testing.assert_array_equal(tview.valid.numpy(), np.asarray(jview.valid))
        np.testing.assert_array_equal(_f32(tview.ring), _f32(jview.ring))

    jrep, trep = jastate.replay, tastate.replay
    assert trep.push_count == int(jrep.push_count) == steps
    assert trep.size == int(jrep.size) and trep.cursor == int(jrep.cursor)
    np.testing.assert_array_equal(_f32(trep.storage["frame_s"]), _f32(jrep.storage["frame_s"]))
    np.testing.assert_array_equal(trep.storage["seq"].numpy(), np.asarray(jrep.storage["seq"]))
    for f in ("reward", "action", "terminated", "truncated", "action_index"):
        np.testing.assert_array_equal(
            _f32(getattr(trep.storage["rest"], f)), _f32(getattr(jrep.storage["rest"], f)), err_msg=f
        )
    trunc = trep.storage["rest"].truncated.numpy()
    assert trunc.sum() >= B
    np.testing.assert_array_equal(
        _f32(trep.storage["frame_t"])[trunc], _f32(jrep.storage["frame_t"])[trunc]
    )

    # One learn on the JAX agent's own rows (pearl_agent.py:416,
    # policy_learner.py:182, visual.py:277-282). Sampled frames are promoted
    # to float32 and learning is float32 in both dtype settings.
    learn_key = jax.random.PRNGKey(7)
    k_l, _ = jax.random.split(learn_key)
    oldest, n_valid = tagent.replay_buffer._sample_range(trep)
    q = np.array(jax.random.randint(jax.random.split(k_l, 1)[0], (VIS["batch"],), 0, n_valid))
    jastate, jmetrics = jagent.learn(jastate, learn_key)
    tastate, tmetrics = tagent.learn(tastate, None, indices=torch.from_numpy(q)[None])
    np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5, atol=1e-6)
    assert tastate.learner.step == int(jastate.learner.step) == 1

    module = tastate.learner.params
    reference = tagent.policy_learner.q_network.init(torch.Generator(), 0, 0, A)
    load_flax_cnn_q_params(reference, jax.tree.map(np.asarray, jastate.learner.params))
    moved = 0.0
    for (name, got), want, before in zip(
        module.named_parameters(), reference.parameters(), tastate.learner.target_params.parameters()
    ):
        # One AdamW step of size ~lr = 1e-3 on float32 gradients that agree
        # to ~1e-4 relative.
        np.testing.assert_allclose(
            got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=2e-6, err_msg=name
        )
        moved = max(moved, (got.detach() - before).abs().max().item())
    assert moved > 5e-4  # the weights did move, and the target is a copy that did not
    if act_dtype:
        # The learn step wrote the params, so the next act recasts its copy.
        cast_module = tagent.policy_learner._act_module(tastate.learner)
        for cast, p in zip(cast_module.parameters(), module.parameters()):
            assert torch.equal(cast, p.detach().to(torch.bfloat16))
        assert tagent.policy_learner._act_module(tastate.learner)._cast_of == tuple(
            (id(p), p._version) for p in module.parameters()
        )


def _tiny_visual_agent(num_envs, **net_options):
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(
                input_shape=(20, 20, 4), time_major_stack=True, hidden_dims=(16,), **net_options
            ),
            training_rounds=1, batch_size=16, act_dtype="bfloat16",
            history_summarizer=FrameRingHistorySummarization(history_length=4, dtype=torch.bfloat16),
        ),
        replay_buffer=VisualReplayBuffer(
            capacity=8 * num_envs, stack=4, num_envs=num_envs, frame_dtype=torch.bfloat16,
            dedup_next=True,
        ),
    )
    env = SyntheticAtari(height=20, width=20, frames=1, obs_dtype=torch.bfloat16, episode_len=5)
    return agent, env


def _drive_tiny_visual_runner(agent, env, num_envs, spl=4, lpc=3):
    """Two runner calls on the CPU; returns the final agent state."""
    init_fn, run_fn = make_compiled_runner(
        agent, env, num_envs=num_envs, steps_per_learn=spl, learns_per_call=lpc, device="cpu"
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, CPU)
    wrappers = (ring_write, ring_write_where, copy_fence, masked_scale_fence4, cache_write, ring_conv1)
    before = [w.launches for w in wrappers]
    for call in range(2):
        astate, env_states, stats = run_fn(astate, env_states, gen)
        assert 0 <= stats["reward_sum"].item() <= spl * lpc * num_envs
    steps = 2 * spl * lpc
    assert [w.launches for w in wrappers] == before  # CPU tensors run the plain versions
    # 24 lockstep steps with episodes of 5: resets after steps 5, 10, 15, 20.
    assert stats["episodes"].item() == 2 * num_envs
    assert astate.replay.push_count == steps and astate.replay.size == 8 * num_envs
    assert astate.replay.cursor == 0 and astate.learner.step == 2 * lpc
    view = astate.history_carry
    assert view.cursor == (1 + steps) % 4 and view.ring.dtype == torch.bfloat16
    assert view.valid.sum(1).tolist() == [4] * num_envs  # 5 frames into the episode
    assert all(torch.isfinite(p).all() for p in astate.learner.params.parameters())
    return astate


def test_visual_runner_runs_on_cpu_at_a_tiny_size():
    num_envs = 8
    agent, env = _tiny_visual_agent(num_envs)
    astate = _drive_tiny_visual_runner(agent, env, num_envs)
    assert astate.history_carry.cache is None

    res = online_learning(
        agent, env, num_envs=num_envs, max_steps=20 * num_envs, learn_every_k_steps=2,
        seed=1, device="cpu",
    )
    assert res.total_steps == 20 * num_envs and res.total_episodes == 4 * num_envs
    assert res.agent_state.replay.push_count == 20
    with pytest.raises(ValueError, match="min_pushes_before_sample"):
        online_learning(agent, env, num_envs=num_envs, max_steps=64, device="cpu")


@pytest.mark.parametrize("option", ["conv1_cache", "ring_conv"])
def test_visual_runner_opt_in_act_paths_run_on_cpu_at_a_tiny_size(option, monkeypatch):
    # The same tiny runner with each opt-in act path of the network; the
    # branch's entry function is counted on its way through.
    import pearl_tpu_torch.neural_networks.q_value_networks as qvn

    name = {"conv1_cache": "gather_sum", "ring_conv": "ring_conv1"}[option]
    calls, real = [], getattr(qvn, name)
    monkeypatch.setattr(qvn, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    num_envs = 8
    agent, env = _tiny_visual_agent(num_envs, **{option: True})
    astate = _drive_tiny_visual_runner(agent, env, num_envs)
    assert len(calls) == 2 * 4 * 3  # once per env step: the act path only
    view = astate.history_carry
    net = agent.policy_learner.q_network
    if option == "conv1_cache":
        assert view.cache.shape == (4, 4, num_envs, 16 * 4 * 4) and view.cache.dtype == torch.bfloat16
        # The runner's last act was a learn: the cache holds the new weights.
        scratch = net.refresh_cache(astate.learner.params, dataclasses.replace(view, cache=None))
        assert torch.equal(view.cache, scratch)
    else:
        assert view.cache is None
    # The opt-in Q agrees with the default branch on the final state
    # (bfloat16 forward, |Q| under 1: 3e-2).
    bound = agent.for_env(env)
    with torch.no_grad():
        q = bound.policy_learner._scores(astate.learner, bound.subjective_state(astate), None)
        plain = dataclasses.replace(net, conv1_cache=False, ring_conv=False)
        q_default = plain.q_all(
            bound.policy_learner._act_module(astate.learner),
            dataclasses.replace(view, cache=None), None,
        ).float()
    assert len(calls) == 2 * 4 * 3 + 1 and q_default.abs().max() < 1.0
    torch.testing.assert_close(q, q_default, rtol=0, atol=3e-2)

    # `online_learning` drives the same path, and resumes on fresh envs with
    # a cache seeded from the learned weights.
    res = online_learning(
        agent, env, num_envs=num_envs, max_steps=20 * num_envs, learn_every_k_steps=2,
        seed=1, device="cpu",
    )
    assert res.total_steps == 20 * num_envs and res.agent_state.replay.push_count == 20
    again = online_learning(
        agent, env, num_envs=num_envs, max_steps=2 * num_envs, exploit=True, learn=False,
        agent_state=res.agent_state, seed=2, device="cpu",
    )
    assert again.total_steps == 2 * num_envs
    assert (again.agent_state.history_carry.cache is not None) == (option == "conv1_cache")


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
