"""The history summarizers of the PyTorch port
(pearl_tpu_torch/history_summarization_modules/modules.py) against the JAX
package's: the stacking window exactly, the LSTM and the transformer forward
and parameter gradients against flax with the same weights (carried across by
`utils/jax_params.py`), and DQN and continuous SAC with an LSTM summarizer
over three learn steps against the JAX learners on the same batches. The
inputs are made with numpy from a seed; the JAX side is jitted.

Tolerances: the summarizers' forward rtol 1e-5 / atol 1e-6, their gradients
the same plus twice JAX's own float32 error (see the test); the learners'
parameters after
three AdamW steps rtol 1e-4 / atol 1e-5, as every learner parity test of the
port.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.envs import Pendulum as JaxPendulum
from pearl_tpu.history_summarization_modules import modules as jax_modules
from pearl_tpu.policy_learners.sequential_decision_making import (
    ContinuousSoftActorCritic as JaxCSAC,
)
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole, PartialObservabilityWrapper, Pendulum
from pearl_tpu_torch.history_summarization_modules import (
    LSTMHistorySummarization,
    StackingHistorySummarization,
    TransformerHistorySummarization,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    ContinuousSoftActorCritic,
    DeepQLearning,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils.jax_params import (
    load_flax_lstm_params,
    load_flax_q_params,
    load_flax_transformer_params,
)
from tests.test_torch_actor_critic import _assert_states_close as assert_actor_critic_states_close
from tests.test_torch_actor_critic import _carry_weights as carry_actor_critic_weights
from tests.test_torch_actor_critic import _learn_noise

torch.set_num_threads(1)

CPU = torch.device("cpu")
NET_TOL = dict(rtol=1e-5, atol=1e-6)
LEARN_TOL = dict(rtol=1e-4, atol=1e-5)
T, OBS, REP = 4, 3, 2  # window, observation width, action representation width


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_modules_close(ours, ref, **tol):
    """Every tensor of two port modules of one architecture (`ref` made by
    loading a flax tree into a copy), parameters and buffers."""
    mine, theirs = ours.state_dict(), ref.state_dict()
    assert set(mine) == set(theirs)
    for name in mine:
        np.testing.assert_allclose(
            mine[name].numpy(), theirs[name].numpy(), err_msg=name, **(tol or NET_TOL)
        )


def _as_port(net, loader, flax_tree):
    """`flax_tree` (params or their gradients) in the port's layout: loaded
    into a copy of `net`."""
    return loader(copy.deepcopy(net), _np_tree(flax_tree))


# --------------------------------------------------------------- stacking
@pytest.mark.parametrize("include_action", [True, False])
def test_stacking_matches_jax_over_steps_with_done_masks(include_action):
    rng = np.random.default_rng(0)
    B = 5
    jm = jax_modules.StackingHistorySummarization(history_length=T, include_action=include_action)
    tm = StackingHistorySummarization(history_length=T, include_action=include_action)
    jc, tc = jm.init_carry(B, OBS, REP), tm.init_carry(B, OBS, REP, CPU)
    first = rng.normal(size=(B, OBS)).astype(np.float32)
    jc, tc = jm.observe(jc, jnp.asarray(first), None), tm.observe(tc, torch.from_numpy(first), None)
    for _ in range(7):
        obs = rng.normal(size=(B, OBS)).astype(np.float32)
        act = rng.normal(size=(B, REP)).astype(np.float32)
        done = rng.random(B) < 0.3
        jc = jm.observe(jc, jnp.asarray(obs), jnp.asarray(act))
        tc = tm.observe(tc, torch.from_numpy(obs), torch.from_numpy(act))
        np.testing.assert_array_equal(tm.stored(tc).numpy(), np.asarray(jm.stored(jc)))
        jc = jm.reset_envs(jc, jnp.asarray(done))
        tc = tm.reset_envs(tc, torch.from_numpy(done))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    stored = tm.stored(tc)
    assert stored.shape == (B, tm.stored_dim(OBS, REP)) == (B, tm.subjective_dim(OBS, REP))
    assert tm.forward({}, stored) is stored and not tm.has_params


# ------------------------------------------------------------ LSTM, transformer
def _net_pair(kind, **kw):
    if kind == "lstm":
        mods = jax_modules.LSTMHistorySummarization, LSTMHistorySummarization
        kw = {"hidden_dim": 8, **kw}
        loader = load_flax_lstm_params
    else:
        mods = jax_modules.TransformerHistorySummarization, TransformerHistorySummarization
        kw = {"dim": 8, "num_heads": 2, **kw}
        loader = load_flax_transformer_params
    jm, tm = (m(history_length=T, **kw) for m in mods)
    jparams = jm.init_params(jax.random.PRNGKey(1), OBS, REP)
    net = tm.init_params(torch.Generator().manual_seed(0), OBS, REP, CPU)
    loader(net, _np_tree(jparams))
    return jm, jparams, tm, net, loader


NETS = [("lstm", {"num_layers": 1}), ("lstm", {"num_layers": 2})] + [
    ("transformer", {"num_layers": n, "positional_encoding": pe})
    for pe in ("learned", "sinusoidal")
    for n in (1, 2)
]


@pytest.mark.parametrize("kind,kw", NETS, ids=lambda v: str(v))
def test_summarizer_forward_and_grads_match_flax(kind, kw):
    jm, jparams, tm, net, loader = _net_pair(kind, **kw)
    assert tm.has_params and jm.has_params
    rng = np.random.default_rng(3)
    stored = rng.normal(size=(6, T * (OBS + REP))).astype(np.float32)
    w = rng.normal(size=(6, tm.subjective_dim(OBS, REP))).astype(np.float32)

    def jax_loss(params):
        return jnp.sum(jm.forward(params, jnp.asarray(stored)) * w)

    jout = jax.jit(jm.forward)(jparams, jnp.asarray(stored))
    jgrads = jax.jit(jax.grad(jax_loss))(jparams)
    out = tm.forward(net, torch.from_numpy(stored))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **NET_TOL)

    def port_grads(dtype):
        module = copy.deepcopy(net).to(dtype)
        out = tm.forward(module, torch.from_numpy(stored).to(dtype))
        (out * torch.from_numpy(w).to(dtype)).sum().backward()
        return {
            name: p.grad.numpy() for name, p in module.named_parameters() if p.requires_grad
        }

    ours, exact = port_grads(torch.float32), port_grads(torch.float64)
    ref = _as_port(net, loader, jgrads).state_dict()
    for name, g in ours.items():
        # Both packages round in float32, in different orders: a gradient
        # that sums terms of magnitude ~10 is off its exact value by ~1e-6
        # in either. So the port is held to JAX within the tolerance plus
        # twice JAX's own float32 error, and JAX's error against the port's
        # float64 gradient is held first, so that a wrong formula cannot
        # widen the bound.
        jg, ex = ref[name].numpy(), exact[name]
        scale = max(1.0, float(np.abs(ex).max()))
        ref_err = float(np.abs(jg - ex).max())
        assert ref_err <= NET_TOL["rtol"] * scale, (name, ref_err, scale)
        np.testing.assert_allclose(
            g, jg, rtol=NET_TOL["rtol"], atol=NET_TOL["atol"] + 2 * ref_err, err_msg=name
        )


def test_transformer_refuses_an_unknown_positional_encoding():
    with pytest.raises(ValueError, match="positional_encoding"):
        TransformerHistorySummarization(positional_encoding="bogus").init_params(
            torch.Generator().manual_seed(0), 2, 2
        )


def test_lstm_init_draws_flax_distributions_and_trains_one_bias_per_gate():
    """The reference's default two layers: flax's cell names, orthogonal
    recurrent kernels per gate, zero biases, and the input biases held at
    zero outside `parameters()` (the module's trainable set)."""
    H = 16
    jparams = jax_modules.LSTMHistorySummarization(
        history_length=T, hidden_dim=H
    ).init_params(jax.random.PRNGKey(0), OBS, REP)
    assert set(jparams) == {"LSTMCell_0", "LSTMCell_1"}
    net = LSTMHistorySummarization(history_length=T, hidden_dim=H).init_params(
        torch.Generator().manual_seed(0), OBS, REP, CPU
    )
    for k in range(2):
        for g in range(4):
            block = net.weight_hh(k)[g * H:(g + 1) * H].detach()
            np.testing.assert_allclose((block @ block.T).numpy(), np.eye(H), atol=1e-5)
        assert not net.bias_hh(k).any() and not net.bias_ih(k).any()
    trainable = {id(p) for p in net.parameters()}
    assert len(trainable) == 6
    assert all(id(net.bias_ih(k)) not in trainable for k in range(2))
    # lecun-normal input kernel: variance 1 / fan_in.
    w = torch.cat([net.weight_ih(k).detach().flatten() for k in range(1)])
    assert abs(float(w.var()) * (OBS + REP) - 1.0) < 0.3


# --------------------------------------------------------------- learners
def _window_batch(seed, B, obs_dim, rep_dim, discrete):
    rng = np.random.default_rng(seed)
    width = T * (obs_dim + rep_dim)
    idx = rng.integers(0, 2, B).astype(np.int32)
    action = idx[:, None].astype(np.float32) if discrete else rng.uniform(-2, 2, (B, 1))
    data = dict(
        state=rng.normal(size=(B, width)).astype(np.float32),
        action=action.astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        next_state=rng.normal(size=(B, width)).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.1,
        action_index=idx,
    )
    return (
        JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}),
        TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}),
    )


def _lstm(cls):
    return cls(history_length=T, hidden_dim=8, num_layers=1)


def _transformer(cls):
    return cls(history_length=T, dim=8, num_layers=1, num_heads=2)


def _assert_summarizer_close_where_adam_is_conditioned(summ, jstate, loader, lr, shaky):
    """The summarizer at LEARN_TOL, except where optax's Adam step has been
    ill-conditioned so far (`shaky`, masks kept across steps): where
    sqrt(nu_hat) is within 100x of Adam's eps, the step is about lr / eps
    times a near-zero gradient, and float32 noise in that gradient (summed in
    another order) moves the parameter by up to lr. The attention's key bias
    is such a tensor: adding one vector to every key adds one number to all
    of a query's logits, which the softmax takes away, so its exact gradient
    is 0 and the bias changes no output. Only key biases may be exceptions,
    and they are held to lr per step."""
    adam = jstate.opt_state[0]
    count = int(adam.count)
    nu = _as_port(summ, loader, adam.nu["summ"]).state_dict()
    ref = _as_port(summ, loader, jstate.summarizer_params).state_dict()
    for name, mine in summ.state_dict().items():
        v = nu[name].numpy()
        now = (v > 0) & (np.sqrt(v / (1 - 0.999**count)) < 100 * 1e-8)
        mask = shaky[name] = shaky.get(name, False) | now
        assert not mask.any() or name.endswith("key.bias"), name
        got, want = mine.numpy(), ref[name].numpy()
        np.testing.assert_allclose(got[~mask], want[~mask], err_msg=name, **LEARN_TOL)
        assert (np.abs(got - want)[mask] <= lr * count).all(), name


def _dqn_trains_its_summarizer_like_jax(make_summarizer, loader, n_params):
    """Three DQN learn steps on the same batches from carried weights: the
    losses, the Q-network, its target and the summarizer against JAX's."""
    kw = dict(training_rounds=1, batch_size=32, target_update_freq=2)
    jl = JaxDQN(history_summarizer=make_summarizer("jax"), **kw).bind(JaxCartPole().action_space)
    tl = DeepQLearning(history_summarizer=make_summarizer("torch"), **kw).bind(
        CartPole().action_space
    )
    jstate = jl.init(jax.random.PRNGKey(0), 2, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), 2, tl.action_space, 1, CPU)
    load_flax_q_params(tstate.params, _np_tree(jstate.params))
    load_flax_q_params(tstate.target_params, _np_tree(jstate.target_params))
    loader(tstate.summarizer_params, _np_tree(jstate.summarizer_params))
    summ0 = copy.deepcopy(tstate.summarizer_params)
    jax_learn = jax.jit(jl.learn_batch)
    shaky = {}
    for step in range(3):
        jbatch, tbatch = _window_batch(step, 32, 2, 2, discrete=True)
        jstate, jaux = jax_learn(jstate, jbatch)
        tstate, taux = tl.learn_batch(tstate, tbatch)
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), **LEARN_TOL)
        for mine, ref, load in (
            (tstate.params, jstate.params, load_flax_q_params),
            (tstate.target_params, jstate.target_params, load_flax_q_params),
        ):
            _assert_modules_close(mine, _as_port(mine, load, ref), **LEARN_TOL)
        _assert_summarizer_close_where_adam_is_conditioned(
            tstate.summarizer_params, jstate, loader, tl.learning_rate, shaky
        )
    moved = [
        not torch.equal(a, b)
        for a, b in zip(summ0.parameters(), tstate.summarizer_params.parameters())
    ]
    assert all(moved) and len(moved) == n_params


def test_dqn_trains_its_lstm_summarizer_like_jax_over_three_steps():
    """One AdamW over the Q-network and the summarizer, as optax's over the
    reference's {"q", "summ"} tree; the target stays the Q-network's."""
    pick = {"jax": jax_modules.LSTMHistorySummarization, "torch": LSTMHistorySummarization}
    _dqn_trains_its_summarizer_like_jax(lambda p: _lstm(pick[p]), load_flax_lstm_params, 3)


def test_dqn_trains_its_transformer_summarizer_like_jax_over_three_steps():
    """The transformer's twin of the LSTM test: the learn path the
    partial-observability anchor runs."""
    pick = {
        "jax": jax_modules.TransformerHistorySummarization,
        "torch": TransformerHistorySummarization,
    }
    net = _transformer(TransformerHistorySummarization).init_params(
        torch.Generator().manual_seed(0), 2, 2
    )
    _dqn_trains_its_summarizer_like_jax(
        lambda p: _transformer(pick[p]), load_flax_transformer_params,
        len(list(net.parameters())),
    )


def test_csac_trains_its_lstm_summarizer_like_jax_over_three_steps():
    """Actor, critic and summarizer (the sum of both losses' gradients) after
    three steps on the same batches and the same policy draws."""
    kw = dict(training_rounds=1, batch_size=32)
    jl = JaxCSAC(history_summarizer=_lstm(jax_modules.LSTMHistorySummarization), **kw).bind(
        JaxPendulum().action_space
    )
    tl = ContinuousSoftActorCritic(history_summarizer=_lstm(LSTMHistorySummarization), **kw).bind(
        Pendulum().action_space
    )
    jstate = jl.init(jax.random.PRNGKey(0), OBS, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), OBS, tl.action_space, 1, CPU)
    carry_actor_critic_weights(jstate, tstate)
    load_flax_lstm_params(tstate.summarizer_params, _np_tree(jstate.summarizer_params))
    jax_learn = jax.jit(jl.learn_batch)
    for step in range(3):
        # A continuous action reaches no window entry (representation width 0).
        jbatch, tbatch = _window_batch(step, 32, OBS, 0, discrete=False)
        noise = _learn_noise(jstate.key, 32)
        jstate, jmetrics = jax_learn(jstate, jbatch)
        tstate, tmetrics = tl.learn_batch(tstate, tbatch, noise=noise)
        for k in jmetrics:
            np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), **LEARN_TOL)
        assert_actor_critic_states_close(jstate, tstate)
        summ = tstate.summarizer_params
        _assert_modules_close(
            summ, _as_port(summ, load_flax_lstm_params, jstate.summarizer_params), **LEARN_TOL
        )


# ------------------------------------------------------------------- agent
@pytest.mark.parametrize("summarizer", ["lstm", "transformer"])
def test_subjective_state_records_no_graph(summarizer):
    """Acting trains nothing: the summary the agent acts on carries no
    autograd graph, though the summarizer's weights require grad."""
    summ = (
        LSTMHistorySummarization(history_length=T, hidden_dim=8, num_layers=1)
        if summarizer == "lstm"
        else TransformerHistorySummarization(history_length=T, dim=8, num_layers=1, num_heads=2)
    )
    env = PartialObservabilityWrapper(env=CartPole(), observed_indices=(0, 2))
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=8, history_summarizer=summ),
        replay_buffer=BasicReplayBuffer(capacity=64),
    ).for_env(env)
    _, obs = env.reset(4, torch.Generator().manual_seed(0), CPU)
    astate = agent.init(0, 2, 4, obs, device="cpu")
    assert all(p.requires_grad for p in astate.learner.summarizer_params.parameters())
    subjective = agent.subjective_state(astate)
    assert subjective.shape == (4, summ.subjective_dim(2, 2))
    assert not subjective.requires_grad and subjective.grad_fn is None


def test_online_learning_trains_an_lstm_on_partially_observed_cartpole():
    """The twin of the reference's `test_lstm_summarizer_partial_obs_cartpole`
    at its size: replay stores the flattened windows, the summarizer moves."""
    env = PartialObservabilityWrapper(env=CartPole(), observed_indices=(0, 2))
    learner = DeepQLearning(
        training_rounds=1, batch_size=16,
        history_summarizer=LSTMHistorySummarization(history_length=4, hidden_dim=16, num_layers=1),
    )
    agent = PearlAgent(policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=256))
    init = agent.for_env(env).init(
        0, 2, 4, env.reset(4, torch.Generator().manual_seed(0), CPU)[1], device="cpu"
    )
    before = [p.detach().clone() for p in init.learner.summarizer_params.parameters()]
    res = online_learning(
        agent, env, num_envs=4, max_steps=128, learn_every_k_steps=8, learning_starts=32,
        seed=0, device="cpu",
    )
    ls = res.agent_state.learner
    assert ls.step > 0
    after = list(ls.summarizer_params.parameters())
    assert all(torch.isfinite(p).all() for p in after)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    assert res.agent_state.replay.storage.state.shape[-1] == 4 * (2 + 2)
