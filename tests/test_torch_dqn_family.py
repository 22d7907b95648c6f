"""The rest of the DQN family's first half in the PyTorch port against the JAX
package: the Dueling and Quantile Q-networks (forwards and gradients, with
and without a mask, on carried weights), the two risk metrics, the QR-DQN
loss, QR-DQN, deep SARSA and Dueling DQN over three AdamW steps against
optax, the SARSA buffer's push sequence, the greedy index's tie-breaking
strategies, Boltzmann exploration and `Warmup` on JAX's own draws, and the
agent's injection of a risk-sensitive safety module.

JAX draws from keys and the port from `torch.Generator`s; the tests draw the
Gumbel noise, the permutation and the uniform index from the very keys the
JAX code uses and hand them to the port's seams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.neural_networks.q_value_networks import (
    DuelingQValueNetwork as JaxDueling,
    QuantileQValueNetwork as JaxQuantile,
)
from pearl_tpu.policy_learners.exploration_modules import common as jax_common
from pearl_tpu.policy_learners.sequential_decision_making import (
    DeepQLearning as JaxDQN,
    DeepSARSA as JaxSARSA,
    QuantileRegressionDeepQLearning as JaxQR,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.replay_buffers.sarsa import SARSAReplayBuffer as JaxSARSABuffer
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.safety_modules import IdentitySafetyModule as JaxIdentity
from pearl_tpu.safety_modules.identity import SafetyModule as JaxSafetyModule
from pearl_tpu.safety_modules.risk_sensitive import (
    QuantileNetworkMeanVarianceSafetyModule as JaxMeanVariance,
    RiskNeutralSafetyModule as JaxNeutral,
)
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.neural_networks import DuelingQValueNetwork, QuantileQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules import (
    BoltzmannExploration,
    EGreedyExploration,
    ExplorationModuleWrapper,
    NoExploration,
    TiebreakingStrategy,
    Warmup,
    masked_argmax_random_ties,
    masked_argmax_random_ties_batch,
    model_action_index,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    DeepQLearning,
    DeepSARSA,
    QuantileRegressionDeepQLearning,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, SARSAReplayBuffer, TransitionBatch
from pearl_tpu_torch.safety_modules import (
    IdentitySafetyModule,
    QuantileNetworkMeanVarianceSafetyModule,
    RiskNeutralSafetyModule,
    SafetyModule,
)
from pearl_tpu_torch.utils.jax_params import load_flax_dueling_q_params, load_flax_q_params

torch.set_num_threads(1)

# float32 forwards and gradients, summed in other orders.
TOL = dict(rtol=1e-5, atol=1e-6)
# Three AdamW steps: Adam's m / sqrt(v) passes those differences on.
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _module_tree(module, grad=False):
    """A network of `MLP`s (the port's `_DuelingNet`, `_PairQNet`) as a flax
    tree of numpy arrays: its weights, or their gradients."""
    tree = {}
    for name, mlp in module.named_children():
        tree[name] = {}
        for layer_name, layer in zip(mlp.layer_names, mlp.layers()):
            w, b = (layer.weight.grad, layer.bias.grad) if grad else (layer.weight, layer.bias)
            tree[name][layer_name] = {"kernel": w.detach().numpy().T, "bias": b.detach().numpy()}
    return tree


def _assert_tree_close(ours, ref, tol=TOL):
    ref = _np_tree(ref)
    assert set(ours) == set(ref)
    for name in ref:
        for layer in ref[name]:
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(ours[name][layer][leaf], ref[name][layer][leaf], **tol)


def _net_inputs(B=17, state_dim=4, A=3, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((B, state_dim)).astype(np.float32)
    actions = np.broadcast_to(np.eye(A, dtype=np.float32), (B, A, A)).copy()
    mask = None
    if masked:
        mask = rng.random((B, A)) < 0.6
        mask[np.arange(B), rng.integers(0, A, B)] = True  # at least one available
        mask[0] = False  # a row with nothing available: the mean divides by 1
    weights = rng.standard_normal((B, A)).astype(np.float32)
    return state, actions, mask, weights


NETS = {
    "dueling": (lambda: JaxDueling(hidden_dims=(16, 12)),
                lambda: DuelingQValueNetwork(hidden_dims=(16, 12)), load_flax_dueling_q_params),
    "quantile": (lambda: JaxQuantile(hidden_dims=(16, 12), num_quantiles=5),
                 lambda: QuantileQValueNetwork(hidden_dims=(16, 12), num_quantiles=5),
                 load_flax_q_params),
}


def _carried(name, state_dim=4, A=3):
    jax_net, net, load = (f() if i < 2 else f for i, f in enumerate(NETS[name]))
    jparams = jax_net.init(jax.random.PRNGKey(1), state_dim, A, A)
    module = net.init(torch.Generator().manual_seed(0), state_dim, A, A)
    load(module, _np_tree(jparams))
    return jax_net, jparams, net, module


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(NETS))
def test_forward_and_gradients_match_jax(name, masked):
    jax_net, jparams, net, module = _carried(name)
    state, actions, mask, weights = _net_inputs(masked=masked)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    def jax_objective(params):
        q = jax_net.q_all(params, jnp.asarray(state), jnp.asarray(actions), jmask)
        return jnp.sum(q * weights), q

    (_, jq), jgrads = jax.value_and_grad(jax_objective, has_aux=True)(jparams)
    q = net.q_all(module, torch.from_numpy(state), torch.from_numpy(actions), tmask)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), **TOL)
    (q * torch.from_numpy(weights)).sum().backward()
    _assert_tree_close(_module_tree(module, grad=True), jgrads)
    if name == "quantile":
        jquant = jax_net.quantiles_all(jparams, jnp.asarray(state), jnp.asarray(actions), jmask)
        quant = net.quantiles_all(module, torch.from_numpy(state), torch.from_numpy(actions))
        assert quant.shape == (17, 3, 5)
        np.testing.assert_allclose(quant.detach().numpy(), np.asarray(jquant), **TOL)
        np.testing.assert_allclose(net.taus().numpy(), np.asarray(jax_net.taus()), atol=1e-7)
        np.testing.assert_allclose(net.midpoints().numpy(), np.asarray(jax_net.midpoints()),
                                   atol=1e-7)


def test_dueling_loader_checks_the_tree():
    _, jparams, net, module = _carried("dueling")
    assert _module_tree(module).keys() == {"state_arch", "value_arch", "advantage_arch"}
    with pytest.raises(ValueError, match="keys"):
        load_flax_dueling_q_params(module, {"MLP_0": {}})


@pytest.mark.parametrize("jax_module,module", [
    (JaxNeutral(), RiskNeutralSafetyModule()),
    (JaxMeanVariance(variance_weighting_coefficient=0.3),
     QuantileNetworkMeanVarianceSafetyModule(variance_weighting_coefficient=0.3)),
])
def test_risk_metrics_match_jax(jax_module, module):
    quantiles = np.random.default_rng(2).standard_normal((9, 3, 7)).astype(np.float32) * 3
    want = np.asarray(jax_module.q_values_under_risk_metric(jnp.asarray(quantiles)))
    got = module.q_values_under_risk_metric(torch.from_numpy(quantiles)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------------ learners

LEARNERS = {
    "qrdqn_neutral": (lambda: JaxQR(q_network=JaxQuantile(num_quantiles=5)),
                      lambda: QuantileRegressionDeepQLearning(
                          q_network=QuantileQValueNetwork(num_quantiles=5)),
                      load_flax_q_params),
    "qrdqn_meanvar": (lambda: JaxQR(q_network=JaxQuantile(num_quantiles=5),
                                    safety=JaxMeanVariance(variance_weighting_coefficient=0.5)),
                      lambda: QuantileRegressionDeepQLearning(
                          q_network=QuantileQValueNetwork(num_quantiles=5),
                          safety=QuantileNetworkMeanVarianceSafetyModule(
                              variance_weighting_coefficient=0.5)),
                      load_flax_q_params),
    "sarsa": (lambda: JaxSARSA(), lambda: DeepSARSA(), load_flax_q_params),
    "dueling_dqn": (lambda: JaxDQN(q_network=JaxDueling()),
                    lambda: DeepQLearning(q_network=DuelingQValueNetwork()),
                    load_flax_dueling_q_params),
}


def _learners(name):
    make_jax, make, load = LEARNERS[name]
    kw = {"training_rounds": 1, "batch_size": 64, "target_update_freq": 2}
    jl = dataclasses.replace(make_jax(), **kw).bind(JaxCartPole().action_space)
    tl = dataclasses.replace(make(), **kw).bind(CartPole().action_space)
    jstate = jl.init(jax.random.PRNGKey(0), 4, jl.action_space, 1)
    tstate = tl.init(torch.Generator().manual_seed(0), 4, tl.action_space, 1, CPU)
    weights = _np_tree(jstate.params)
    load(tstate.params, weights)
    load(tstate.target_params, weights)
    return jl, jstate, tl, tstate


def _assert_params_close_where_adam_is_conditioned(tstate, jstate, lr, shaky, rare):
    """The online and target parameters at STEP_TOL, except where optax's
    Adam step was ill-conditioned at some step so far (`shaky`, masks kept
    across steps): where sqrt(nu_hat) is within 100x of Adam's eps (1e-8),
    the step is about lr / eps times a near-zero gradient, so float32 noise
    in that gradient moves the parameter by up to lr. Those elements are held
    to lr per step (as in `tests/test_torch_discrete_actor_critic.py`), and
    they must stay under the share `rare` of all."""
    adam = jstate.opt_state[0]
    count = int(adam.count)
    nu = _np_tree(adam.nu["q"])
    pairs = [(_module_tree(tstate.params), _np_tree(jstate.params)),
             (_module_tree(tstate.target_params), _np_tree(jstate.target_params))]
    n_shaky = n_all = 0
    for name in nu:
        for layer in nu[name]:
            for leaf in ("kernel", "bias"):
                v = nu[name][layer][leaf]
                now = (v > 0) & (np.sqrt(v / (1 - 0.999**count)) < 100 * 1e-8)
                path = (name, layer, leaf)
                mask = shaky[path] = shaky.get(path, False) | now
                n_shaky, n_all = n_shaky + mask.sum(), n_all + mask.size
                for ours, ref in pairs:
                    got, want = ours[name][layer][leaf], ref[name][layer][leaf]
                    np.testing.assert_allclose(got[~mask], want[~mask], err_msg=str(path),
                                               **STEP_TOL)
                    assert (np.abs(got - want)[mask] <= lr * count).all(), path
    assert n_shaky <= rare * n_all, (n_shaky, n_all)


def _batch_data(B, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2, B).astype(np.int32)
    nxt = rng.integers(0, 2, B).astype(np.int32)
    return dict(
        state=rng.standard_normal((B, 4)).astype(np.float32) * 0.5,
        action=idx[:, None].astype(np.float32),
        reward=rng.standard_normal(B).astype(np.float32),
        next_state=rng.standard_normal((B, 4)).astype(np.float32) * 0.5,
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.05,
        action_index=idx,
        next_action=nxt[:, None].astype(np.float32),
        next_action_index=nxt,
    )


def _jax_loss_and_grads(jl, jstate, jbatch):
    """The JAX learner's own optimized loss and its gradient: `learn_batch`
    run with `_apply_gradients` replaced by a probe that differentiates the
    loss closure it is handed."""
    out = {}

    def probe(state, loss_fn):
        trainable = {"q": state.params, "summ": state.summarizer_params}
        out["value"] = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        return state, {}

    learner = dataclasses.replace(jl)
    object.__setattr__(learner, "_apply_gradients", probe)
    learner.learn_batch(jstate, jbatch)
    (loss, _), grads = out["value"]
    return loss, grads["q"]


@pytest.mark.parametrize("name", list(LEARNERS))
def test_learn_batch_matches_jax_over_three_adamw_steps(name):
    jl, jstate, tl, tstate = _learners(name)
    shaky = {}
    for step in range(3):
        data = _batch_data(64, seed=step)
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
        tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})

        jloss, jgrads = _jax_loss_and_grads(jl, jstate, jbatch)
        tloss, _ = tl.td_loss(tstate, tbatch)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        tstate.params.zero_grad()
        tloss.backward()
        _assert_tree_close(_module_tree(tstate.params, grad=True), jgrads, STEP_TOL)

        jstate, jaux = jl.learn_batch(jstate, jbatch)
        tstate, taux = tl.learn_batch(tstate, tbatch)
        assert tstate.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), **STEP_TOL)
        np.testing.assert_allclose(
            taux["per_sample_td"].numpy(), np.asarray(jaux["per_sample_td"]), **STEP_TOL
        )
        # The dueling head subtracts the advantages' mean: a hidden unit of
        # the advantage arch active for both actions gets two gradient
        # contributions that cancel, a few percent of its elements.
        rare = 0.05 if name == "dueling_dqn" else 0.01
        _assert_params_close_where_adam_is_conditioned(
            tstate, jstate, tl.learning_rate, shaky, rare
        )


@pytest.mark.parametrize("name", ["qrdqn_neutral", "qrdqn_meanvar"])
def test_qrdqn_acts_under_its_risk_metric(name):
    jl, jstate, tl, tstate = _learners(name)
    state = np.random.default_rng(4).standard_normal((32, 4)).astype(np.float32)
    _, jchoice = jl.act(jstate, jnp.asarray(state), None, jax.random.PRNGKey(0), exploit=True)
    _, choice = tl.act(tstate, torch.from_numpy(state), None, None, exploit=True)
    np.testing.assert_array_equal(choice.index.numpy(), np.asarray(jchoice.index))
    quantiles = tl.q_network.quantiles_all(tstate.params, torch.from_numpy(state),
                                           tl._candidates(tstate, 32))
    scores = tl.safety.q_values_under_risk_metric(quantiles)
    np.testing.assert_array_equal(choice.index.numpy(), scores.argmax(-1).numpy())


def test_sarsa_learner_is_on_policy_and_values_the_committed_action():
    _, _, tl, tstate = _learners("sarsa")
    assert tl.on_policy and not tl.is_distributional
    data = _batch_data(16, seed=9)
    batch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
    got = tl._next_state_values(tstate.params, tstate.target_params, None, batch, tstate)
    q_next = tl.q_network.q_all(tstate.target_params, batch.next_state,
                                tl._candidates(tstate, 16))
    torch.testing.assert_close(got, q_next[torch.arange(16), batch.next_action_index.long()])


# ------------------------------------------------------------ SARSA buffer


def _sarsa_batches(n_envs, pushes, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(pushes):
        idx = rng.integers(0, 2, n_envs).astype(np.int32)
        out.append(dict(
            state=rng.standard_normal((n_envs, 4)).astype(np.float32),
            action=idx[:, None].astype(np.float32),
            reward=rng.standard_normal(n_envs).astype(np.float32),
            next_state=rng.standard_normal((n_envs, 4)).astype(np.float32),
            terminated=rng.random(n_envs) < 0.3,
            truncated=np.zeros(n_envs, bool),
            action_index=idx,
        ))
    return out


def test_sarsa_buffer_push_sequence_matches_jax():
    n, cap = 4, 12
    batches = _sarsa_batches(n, pushes=5)
    extra = dict(next_action=np.zeros((1, 1), np.float32),
                 next_action_index=np.zeros((1,), np.int32))
    example = {k: v[:1] for k, v in batches[0].items()} | extra
    jbuf, buf = JaxSARSABuffer(capacity=cap, num_envs=n), SARSAReplayBuffer(capacity=cap, num_envs=n)
    jstate = jbuf.init(JaxBatch(**{k: jnp.asarray(v) for k, v in example.items()}))
    state = buf.init(TransitionBatch(**{k: torch.from_numpy(v) for k, v in example.items()}))
    assert not buf.supports_deferred_push and not state.pending_valid
    for i, data in enumerate(batches):
        jstate = jbuf.push(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}))
        state = buf.push(state, TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}))
        # The first push only fills the cache; each later one commits the
        # previous batch with this batch's action as its next action.
        assert state.size == int(jstate.size) == min(i, 3) * n
        assert state.cursor == int(jstate.cursor)
        for field in ("state", "action", "reward", "terminated", "action_index", "next_action",
                      "next_action_index"):
            np.testing.assert_array_equal(
                getattr(state.storage, field).numpy(), np.asarray(getattr(jstate.storage, field))
            )
    committed = state.storage
    # Push 4 committed batch 3 over rows 0-3 (a 12-row ring); rows 4-7 hold
    # batch 1 paired with batch 2's action.
    np.testing.assert_array_equal(committed.next_action_index[4:8].numpy(),
                                  batches[2]["action_index"])
    np.testing.assert_array_equal(committed.action_index[4:8].numpy(), batches[1]["action_index"])
    np.testing.assert_array_equal(committed.action_index[0:4].numpy(), batches[3]["action_index"])
    cleared = buf.clear(state)
    assert cleared.size == 0 and cleared.pending_valid and cleared.pending is state.pending


def test_agent_stores_sarsa_next_actions():
    agent = PearlAgent(policy_learner=DeepSARSA(training_rounds=1, batch_size=8),
                       replay_buffer=SARSAReplayBuffer(capacity=64, num_envs=4)).for_env(CartPole())
    jagent = JaxAgent(policy_learner=JaxSARSA(training_rounds=1, batch_size=8),
                      replay_buffer=JaxSARSABuffer(capacity=64, num_envs=4)).for_env(JaxCartPole())
    obs = torch.zeros((4, 4))
    astate = agent.init(0, 4, 4, obs, device="cpu")
    jstate = jagent.init(jax.random.PRNGKey(0), 4, 4, jnp.zeros((4, 4)))
    assert astate.replay.storage.next_action.shape == jstate.replay.storage.next_action.shape
    assert astate.replay.storage.next_action_index.dtype == torch.int32


# ------------------------------------------------------------ exploration


def _tied_scores(B=64, A=5, seed=5, masked=True):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 3, (B, A)).astype(np.float32)  # many exact ties
    mask = None
    if masked:
        mask = rng.random((B, A)) < 0.7
        mask[np.arange(B), rng.integers(0, A, B)] = True
    return scores, mask


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("epsilon", [0.0, 1e-6])
def test_per_row_ties_match_jax_on_its_gumbel_noise(epsilon, masked):
    scores, mask = _tied_scores(masked=masked)
    key = jax.random.PRNGKey(7)
    want = jax_common.masked_argmax_random_ties(_j(scores), _j(mask), key, epsilon)
    noise = _t(jax.random.gumbel(key, scores.shape))
    got = masked_argmax_random_ties(_t(scores), _t(mask), None, epsilon, noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) > 1


@pytest.mark.parametrize("masked", [False, True])
def test_batch_ties_match_jax_on_its_permutation(masked):
    scores, mask = _tied_scores(masked=masked)
    key = jax.random.PRNGKey(8)
    want = jax_common.masked_argmax_random_ties_batch(_j(scores), _j(mask), key)
    perm = _t(jax.random.permutation(key, scores.shape[1]))
    got = masked_argmax_random_ties_batch(_t(scores), _t(mask), None, perm=perm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strategy", list(TiebreakingStrategy))
def test_model_action_index_matches_jax(strategy):
    scores, mask = _tied_scores()
    key = jax.random.PRNGKey(9)
    jstrategy = jax_common.TiebreakingStrategy[strategy.name]
    want = jax_common.model_action_index(_j(scores), _j(mask), jstrategy, key)
    got = model_action_index(
        _t(scores), _t(mask), strategy, None,
        noise=_t(jax.random.gumbel(key, scores.shape)),
        perm=_t(jax.random.permutation(key, scores.shape[1])),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    available = np.take_along_axis(mask, got.long().numpy()[:, None], 1)
    assert available.all()


def _dqn(tiebreaking=None, exploration=None):
    learner = DeepQLearning(tiebreaking=tiebreaking,
                            exploration=exploration or EGreedyExploration(epsilon=0.5))
    return learner.bind(CartPole().action_space)


def test_tiebreaking_keeps_the_weights_and_the_exploration_stream():
    default, ties = _dqn(), _dqn(TiebreakingStrategy.PER_ROW_TIEBREAKING)
    s0 = default.init(torch.Generator().manual_seed(0), 4, default.action_space, 8, CPU)
    s1 = ties.init(torch.Generator().manual_seed(0), 4, ties.action_space, 8, CPU)
    assert s0.tie_generator is None and s1.tie_generator is not None
    for a, b in zip(s0.params.parameters(), s1.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    state = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32))
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    (_, c0), (_, c1) = (learner.act(s, state, None, g)
                        for learner, s, g in zip((default, ties), (s0, s1), gens))
    # Random float Q-values do not tie: the same actions, and the
    # exploration stream is where it was.
    torch.testing.assert_close(c0.index, c1.index, rtol=0, atol=0)
    torch.testing.assert_close(gens[0].get_state(), gens[1].get_state(), rtol=0, atol=0)


def test_tiebreaking_spreads_exact_ties_in_act():
    ties = _dqn(TiebreakingStrategy.PER_ROW_TIEBREAKING)
    s = ties.init(torch.Generator().manual_seed(0), 4, ties.action_space, 64, CPU)
    with torch.no_grad():
        for p in s.params.parameters():
            p.zero_()  # every Q is 0: both actions tie on every row
    _, choice = ties.act(s, torch.zeros((64, 4)), None, None, exploit=True)
    assert set(choice.index.tolist()) == {0, 1}
    _, first = _dqn().act(dataclasses.replace(s, tie_generator=None), torch.zeros((64, 4)),
                          None, None, exploit=True)
    assert set(first.index.tolist()) == {0}


@pytest.mark.parametrize("masked", [False, True])
def test_boltzmann_matches_jax_on_its_gumbel_noise(masked):
    rng = np.random.default_rng(6)
    scores = rng.standard_normal((64, 4)).astype(np.float32)
    mask = (rng.random((64, 4)) < 0.7) | np.eye(4, dtype=bool)[rng.integers(0, 4, 64)]
    mask = mask if masked else None
    key = jax.random.PRNGKey(10)
    ei = jnp.zeros((64,), jnp.int32)
    _, want = jax_common.BoltzmannExploration(temperature=0.5).act((), _j(scores), ei, _j(mask),
                                                                   key)
    _, got = BoltzmannExploration(temperature=0.5).act(
        (), _t(scores), torch.zeros(64, dtype=torch.int32), _t(mask), None,
        noise=_t(jax.random.gumbel(key, scores.shape)),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_warmup_matches_jax_across_its_end(masked):
    B, A, warmup = 8, 4, 12
    rng = np.random.default_rng(11)
    jmod = jax_common.Warmup(base=jax_common.BoltzmannExploration(temperature=2.0),
                             warmup_steps=warmup)
    mod = Warmup(base=BoltzmannExploration(temperature=2.0), warmup_steps=warmup)
    jstate, state = jmod.init(B), mod.init(B)
    for call in range(4):  # counts 0 and 8 in the warm-up, 16 and 24 past it
        scores = rng.standard_normal((B, A)).astype(np.float32)
        mask = ((rng.random((B, A)) < 0.6) | np.eye(A, dtype=bool)[rng.integers(0, A, B)]
                if masked else None)
        key = jax.random.PRNGKey(20 + call)
        k_uniform, k_base = jax.random.split(key)
        ei = jnp.zeros((B,), jnp.int32)
        jstate, want = jmod.act(jstate, _j(scores), ei, _j(mask), key)
        state, got = mod.act(
            state, _t(scores), torch.zeros(B, dtype=torch.int32), _t(mask), None,
            random_index=_t(jax_common._uniform_index(k_uniform, B, A, _j(mask))),
            noise=_t(jax.random.gumbel(k_base, (B, A))),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert state[0] == int(jstate[0].step) == B * (call + 1)


def test_warmup_draws_from_its_generator_only_in_the_warmup():
    mod = Warmup(base=NoExploration(), warmup_steps=8)
    gen = torch.Generator().manual_seed(0)
    scores = torch.zeros((8, 3))
    exploit = torch.full((8,), 2, dtype=torch.int32)
    state, index = mod.act(mod.init(8), scores, exploit, None, gen)
    assert index.dtype == torch.int32 and index.tolist() != [2] * 8
    before = gen.get_state()
    state, index = mod.act(state, scores, exploit, None, gen)
    assert index.tolist() == [2] * 8 and torch.equal(before, gen.get_state())
    wrapper = ExplorationModuleWrapper(base=EGreedyExploration(epsilon=0.0))
    assert wrapper.init(8) == 0
    assert wrapper.act(0, scores, exploit, None, gen)[1].tolist() == [2] * 8


def test_dqn_with_warmup_boltzmann_learns_on_cpu():
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=1, batch_size=16, tiebreaking=TiebreakingStrategy.BATCH_TIEBREAKING,
            exploration=Warmup(base=BoltzmannExploration(temperature=1.0), warmup_steps=64)),
        replay_buffer=BasicReplayBuffer(capacity=256),
    )
    res = online_learning(agent, CartPole(), num_envs=8, max_steps=512, learn_every_k_steps=4,
                          seed=0, device="cpu")
    assert res.total_steps == 512 and len(res.episode_returns) > 0
    assert res.agent_state.learner.explore_state[0] == 512


# ------------------------------------------------------------ the agent


def test_agent_injects_a_risk_sensitive_module_like_jax():
    mv = QuantileNetworkMeanVarianceSafetyModule(variance_weighting_coefficient=0.2)
    agent = PearlAgent(policy_learner=QuantileRegressionDeepQLearning(), safety_module=mv)
    jmv = JaxMeanVariance(variance_weighting_coefficient=0.2)
    jagent = JaxAgent(policy_learner=JaxQR(), safety_module=jmv)
    assert agent.policy_learner.safety is mv and jagent.policy_learner.safety is jmv
    # The default module resolves to the learner's own.
    agent = PearlAgent(policy_learner=QuantileRegressionDeepQLearning())
    jagent = JaxAgent(policy_learner=JaxQR())
    assert isinstance(agent.safety_module, RiskNeutralSafetyModule)
    assert agent.safety_module is agent.policy_learner.safety
    assert jagent.safety_module is jagent.policy_learner.safety
    # A non-distributional learner keeps what it is given.
    assert isinstance(PearlAgent(policy_learner=DeepQLearning()).safety_module,
                      IdentitySafetyModule)
    assert isinstance(JaxAgent(policy_learner=JaxDQN()).safety_module, JaxIdentity)


def test_agent_rejects_a_module_without_a_risk_metric_like_jax():
    with pytest.raises(TypeError, match="risk-sensitive"):
        JaxAgent(policy_learner=JaxQR(), safety_module=JaxSafetyModule())
    with pytest.raises(TypeError, match="risk-sensitive"):
        PearlAgent(policy_learner=QuantileRegressionDeepQLearning(), safety_module=SafetyModule())


def test_qrdqn_agent_runs_through_the_driver_on_cpu():
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=QuantileRegressionDeepQLearning(training_rounds=1, batch_size=16),
        replay_buffer=BasicReplayBuffer(capacity=256),
        safety_module=QuantileNetworkMeanVarianceSafetyModule(),
    )
    res = online_learning(agent, CartPole(), num_envs=8, max_steps=256, learn_every_k_steps=4,
                          seed=0, stats="summary", device="cpu")
    assert res.total_episodes > 0 and res.agent_state.learner.step == 8
