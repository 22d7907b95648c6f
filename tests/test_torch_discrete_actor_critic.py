"""Discrete actor-critic in the PyTorch port against the JAX package: the
discrete actors and `CNNTwinCritic` (forward and grads), `PropensityExploration`
and the discrete `act` on the same Gumbel noise, discrete SAC's `learn_batch`
over three steps on carried weights (MLP and CNN networks, with and without
temperature tuning) with the actor's learning-rate decay at an
`episode_reset`, and the runner at a tiny size on the CPU.

JAX draws its categorical actions as argmax(logits + gumbel(key)); the tests
draw the same Gumbel noise from the same keys and hand it to the port.
Discrete SAC draws nothing in `learn_batch`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.api.spaces import DiscreteActionSpace as JaxDiscrete
from pearl_tpu.neural_networks.actor_networks import (
    CNNActorNetwork as JaxCNNActor,
    DynamicActionActorNetwork as JaxDynamicActor,
    VanillaActorNetwork as JaxActor,
)
from pearl_tpu.neural_networks.twin_critic import CNNTwinCritic as JaxCNNTwin
from pearl_tpu.neural_networks.twin_critic import TwinCritic as JaxTwin
from pearl_tpu.policy_learners.exploration_modules.common import (
    PropensityExploration as JaxPropensity,
)
from pearl_tpu.policy_learners.sequential_decision_making import SoftActorCritic as JaxSAC
from pearl_tpu.policy_learners.sequential_decision_making.sac import twin_q_all as jax_twin_q_all
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.spaces import DiscreteActionSpace
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.neural_networks import (
    CNNActorNetwork,
    CNNTwinCritic,
    DynamicActionActorNetwork,
    TwinCritic,
    VanillaActorNetwork,
)
from pearl_tpu_torch.policy_learners.exploration_modules import PropensityExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    SoftActorCritic,
    twin_q_all,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import make_compiled_runner
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import (
    load_flax_cnn_twin_critic_params,
    load_flax_discrete_actor_params,
    load_flax_twin_critic_params,
)
from test_torch_on_policy import (
    CNN,
    CNN_OBS,
    NET_TOL,
    TOL,
    assert_adam_close,
    assert_leaves_close,
    flax_leaves,
    np_tree,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
A = 3  # actions
B = 8


def _one_hot_candidates(n):
    eye = np.eye(A, dtype=np.float32)
    return np.broadcast_to(eye[None], (n, A, A)).copy()


def _mask(n, seed=0):
    mask = np.random.default_rng(seed).random((n, A)) < 0.7
    mask[:, 0] = True  # every row keeps an available action
    return mask


# --------------------------------------------------------------- networks
ACTORS = {
    "vanilla": (JaxActor(hidden_dims=(8, 8)), VanillaActorNetwork(hidden_dims=(8, 8)), 4, 1.0),
    "dynamic": (JaxDynamicActor(hidden_dims=(8, 8)), DynamicActionActorNetwork(hidden_dims=(8, 8)),
                4, 1.0),
    "cnn": (JaxCNNActor(**CNN), CNNActorNetwork(**CNN), CNN_OBS, 255.0),
}


@pytest.mark.parametrize("kind", list(ACTORS))
def test_discrete_actors_match_jax_forward_and_grads(kind):
    jnet, tnet, dim, scale = ACTORS[kind]
    jparams = jnet.init(jax.random.PRNGKey(0), dim, A, A)
    params = load_flax_discrete_actor_params(tnet.init(torch.Generator(), dim, A, A),
                                             np_tree(jparams))
    rng = np.random.default_rng(1)
    x = (rng.uniform(size=(B, dim)) * scale).astype(np.float32)
    cands, mask = _one_hot_candidates(B), _mask(B)
    w = rng.normal(size=(B, A)).astype(np.float32)
    jx, jc, jm = jnp.asarray(x), jnp.asarray(cands), jnp.asarray(mask)

    @jax.jit
    def jax_side(p):  # one compile: the logits, and the grads of sum(probs * w)
        grads = jax.grad(lambda q: jnp.sum(jnet.get_policy_distribution(q, jx, jc, jm) * w))(p)
        return jnet.logits(p, jx, jc, jm), grads

    jlogits, jgrads = jax_side(jparams)
    tx, tc, tm = torch.from_numpy(x), torch.from_numpy(cands), torch.from_numpy(mask)
    logits = tnet.logits(params, tx, tc, tm)
    assert logits.shape == (B, A) and torch.isneginf(logits[~tm]).all()
    np.testing.assert_array_equal(np.isneginf(np.asarray(jlogits)), ~mask)
    np.testing.assert_allclose(logits[tm].detach().numpy(), np.asarray(jlogits)[mask], **NET_TOL)
    probs = tnet.get_policy_distribution(params, tx, tc, tm)
    (probs * torch.from_numpy(w)).sum().backward()
    assert (probs[~tm] == 0).all()
    assert_leaves_close(flax_leaves(params, lambda p: p.grad), jgrads, **NET_TOL)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_twin_critics_score_every_action_like_jax(kind):
    if kind == "cnn":
        jnet, tnet, dim, scale = JaxCNNTwin(**CNN), CNNTwinCritic(**CNN), CNN_OBS, 255.0
        load = load_flax_cnn_twin_critic_params
    else:
        jnet, tnet, dim, scale = JaxTwin(hidden_dims=(8, 8)), TwinCritic(hidden_dims=(8, 8)), 4, 1.0
        load = load_flax_twin_critic_params
    jparams = jnet.init(jax.random.PRNGKey(0), dim, A)
    params = load(tnet.init(torch.Generator(), dim, A), np_tree(jparams))
    rng = np.random.default_rng(2)
    x = (rng.uniform(size=(B, dim)) * scale).astype(np.float32)
    cands = _one_hot_candidates(B)
    actions = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    w = rng.normal(size=(2, B, A)).astype(np.float32)
    jx, jc = jnp.asarray(x), jnp.asarray(cands)

    def jloss(p):
        q1, q2 = jax_twin_q_all(jnet, p, jx, jc)
        return jnp.sum(q1 * w[0]) + jnp.sum(q2 * w[1]), (q1, q2)

    @jax.jit
    def jax_side(p):  # one compile: Q of every action, its grads, and q_both
        (_, q_all), grads = jax.value_and_grad(jloss, has_aux=True)(p)
        return q_all, grads, jnet.q_both(p, jx, jnp.asarray(actions))

    (jq1, jq2), jgrads, (jb1, jb2) = jax_side(jparams)
    q1, q2 = twin_q_all(tnet, params, torch.from_numpy(x), torch.from_numpy(cands))
    assert q1.shape == q2.shape == (B, A)
    ((q1 * torch.from_numpy(w[0])).sum() + (q2 * torch.from_numpy(w[1])).sum()).backward()
    for ours, ref in ((q1, jq1), (q2, jq2)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **NET_TOL)
    assert_leaves_close(flax_leaves(params, lambda p: p.grad), jgrads, **NET_TOL)
    b1, b2 = tnet.q_both(params, torch.from_numpy(x), torch.from_numpy(actions))
    for ours, ref in ((b1, jb1), (b2, jb2)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **NET_TOL)


# ------------------------------------------------------------ exploration
def test_propensity_exploration_matches_jax_on_the_same_gumbel_noise():
    n = 64
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(A), n).astype(np.float32)
    probs[:4] = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.5, 0.5, 0.0], [0.2, 0.3, 0.5]]
    mask = _mask(n, 4)
    key = jax.random.PRNGKey(5)
    for m in (None, mask):
        _, ref = JaxPropensity().act((), jnp.asarray(probs), None,
                                     None if m is None else jnp.asarray(m), key)
        noise = torch.tensor(np.asarray(jax.random.gumbel(key, (n, A))))
        _, ours = PropensityExploration().act(
            (), torch.from_numpy(probs), None, None if m is None else torch.from_numpy(m), None,
            noise=noise,
        )
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        if m is not None:
            assert m[np.arange(n), ours.numpy()].all()


def test_propensity_exploration_draws_follow_the_probabilities():
    n = 60_000
    probs = torch.tensor([[0.6, 0.3, 0.1], [0.05, 0.0, 0.95]]).repeat_interleave(n // 2, 0)
    mask = torch.ones(n, A, dtype=torch.bool)
    mask[n // 4: n // 2, 0] = False  # renormalised over the other two: 0.75 / 0.25
    _, index = PropensityExploration().act((), probs, None, mask, torch.Generator().manual_seed(0))
    want = [(slice(0, n // 4), [0.6, 0.3, 0.1]), (slice(n // 4, n // 2), [0.0, 0.75, 0.25]),
            (slice(n // 2, n), [0.05, 0.0, 0.95])]
    for rows, p in want:
        freq = torch.bincount(index[rows].long(), minlength=A).double() / index[rows].numel()
        # Five standard errors of a 15000-row frequency.
        sigma = np.sqrt(np.array(p) * (1 - np.array(p)) / index[rows].numel())
        assert (np.abs(freq.numpy() - p) <= 5 * sigma + 1e-12).all(), (freq, p)


# ---------------------------------------------------------------- learners
def _sac_learners(nets="mlp", **overrides):
    kw = dict(training_rounds=1, batch_size=B, actor_learning_rate=3e-3,
              critic_learning_rate=3e-3, **overrides)
    if nets == "cnn":
        jkw = dict(actor_network=JaxCNNActor(**CNN), critic_network=JaxCNNTwin(**CNN))
        tkw = dict(actor_network=CNNActorNetwork(**CNN), critic_network=CNNTwinCritic(**CNN))
        dim = CNN_OBS
    else:
        jkw = dict(actor_network=JaxActor(hidden_dims=(8, 8)),
                   critic_network=JaxTwin(hidden_dims=(8, 8)))
        tkw = dict(actor_network=VanillaActorNetwork(hidden_dims=(8, 8)),
                   critic_network=TwinCritic(hidden_dims=(8, 8)))
        dim = 4
    jl = JaxSAC(**kw, **jkw).bind(JaxDiscrete.create(jnp.arange(A)))
    tl = SoftActorCritic(**kw, **tkw).bind(DiscreteActionSpace.discrete(A))
    jstate = jl.init(jax.random.PRNGKey(0), dim, jl.action_space, B)
    tstate = tl.init(torch.Generator().manual_seed(0), dim, tl.action_space, B, CPU)
    load_flax_discrete_actor_params(tstate.actor_params, np_tree(jstate.actor_params))
    load_critic = (load_flax_cnn_twin_critic_params if nets == "cnn"
                   else load_flax_twin_critic_params)
    load_critic(tstate.critic_params, np_tree(jstate.critic_params))
    load_critic(tstate.critic_target_params, np_tree(jstate.critic_target_params))
    return jl, jstate, tl, tstate, dim


def _sac_batch(seed, dim, scale):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, A, B).astype(np.int32)
    data = dict(
        state=(rng.uniform(size=(B, dim)) * scale).astype(np.float32),
        action=idx[:, None].astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        next_state=(rng.uniform(size=(B, dim)) * scale).astype(np.float32),
        terminated=rng.random(B) < 0.25,
        truncated=np.zeros(B, bool),
        action_index=idx,
    )
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()}))


def assert_params_close_where_adam_is_conditioned(module, ref, jopt, lr, shaky):
    """Parameters at TOL, except where optax's Adam step was ill-conditioned
    at some step so far (`shaky`, a dict of masks kept across steps): where
    sqrt(nu_hat) is within 100x of Adam's eps (1e-8), the step
    lr * m / (sqrt(nu) + eps) is about lr / eps times a near-zero gradient, so
    float32 noise in that gradient (summed in another order) moves the
    parameter by up to lr. There the moments hold the gradient
    (`assert_adam_close`, at TOL) and the parameter is held to lr per step."""
    from flax import traverse_util

    adam = jopt.inner_state[0] if hasattr(jopt, "inner_state") else jopt[0]
    count = int(adam.count)
    nu = traverse_util.flatten_dict(jax.tree.map(np.asarray, adam.nu))
    ours = flax_leaves(module)
    n_shaky = n_all = 0
    for path, want in traverse_util.flatten_dict(jax.tree.map(np.asarray, ref)).items():
        # A gradient that was exactly 0 at every step (a dead unit) is no
        # exception: both steps are exactly 0.
        now = (nu[path] > 0) & (np.sqrt(nu[path] / (1 - 0.999**count)) < 100 * 1e-8)
        mask = shaky[path] = shaky.get(path, False) | now
        n_shaky, n_all = n_shaky + mask.sum(), n_all + mask.size
        np.testing.assert_allclose(ours[path][~mask], want[~mask], err_msg=str(path), **TOL)
        assert (np.abs(ours[path] - want)[mask] <= lr * count).all(), path
    assert n_shaky <= 0.01 * n_all, (n_shaky, n_all)  # the exception stays rare


def _assert_sac_close(jstate, tstate, lr, shaky):
    assert tstate.step == int(jstate.step)
    assert_params_close_where_adam_is_conditioned(
        tstate.actor_params, jstate.actor_params, jstate.actor_opt, lr, shaky["actor"])
    assert_params_close_where_adam_is_conditioned(
        tstate.critic_params, jstate.critic_params, jstate.critic_opt, lr, shaky["critic"])
    assert_leaves_close(flax_leaves(tstate.critic_target_params), jstate.critic_target_params)
    assert_adam_close(tstate.actor_opt, tstate.actor_params, jstate.actor_opt)
    assert_adam_close(tstate.critic_opt, tstate.critic_params, jstate.critic_opt)
    np.testing.assert_allclose(
        tstate.actor_opt.param_groups[0]["lr"].item(),
        float(jstate.actor_opt.hyperparams["learning_rate"]), rtol=1e-6,
    )
    assert (tstate.extra is None) == (jstate.extra is None)
    if jstate.extra is not None:
        np.testing.assert_allclose(tstate.extra.log_alpha.item(), float(jstate.extra.log_alpha),
                                   **TOL)


@pytest.mark.parametrize("nets,autotune", [("mlp", True), ("mlp", False), ("cnn", True)])
def test_discrete_sac_learn_batch_matches_jax_over_three_steps(nets, autotune):
    jl, jstate, tl, tstate, dim = _sac_learners(nets, entropy_autotune=autotune)
    jax_learn_batch = jax.jit(jl.learn_batch)
    scale = 255.0 if nets == "cnn" else 1.0
    done = np.zeros(B, bool)
    done[[1, 4, 6]] = True  # 3 of 8 envs end an episode
    shaky = {"actor": {}, "critic": {}}
    for step in range(3):
        jbatch, tbatch = _sac_batch(step, dim, scale)
        jstate, jmetrics = jax_learn_batch(jstate, jbatch)
        tstate, tmetrics = tl.learn_batch(tstate, tbatch)
        assert set(tmetrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), err_msg=k, **TOL)
        if step == 0:
            # The actor's learning rate decays by 0.99 ** (3 / 8), on the device.
            jstate = jl.episode_reset(jstate, jnp.asarray(done), jax.random.PRNGKey(0))
            tstate = tl.episode_reset(tstate, torch.from_numpy(done), None)
            np.testing.assert_allclose(tstate.actor_opt.param_groups[0]["lr"].item(),
                                       3e-3 * 0.99 ** (3 / 8), rtol=1e-6)
        _assert_sac_close(jstate, tstate, 3e-3, shaky)
    lr = tstate.actor_opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.device == CPU
    assert ("alpha" in tmetrics) == autotune


@pytest.mark.parametrize("exploit", [False, True])
def test_discrete_act_matches_jax_with_the_same_gumbel_noise(exploit):
    jl, jstate, tl, tstate, _ = _sac_learners()
    rng = np.random.default_rng(6)
    subj, mask = rng.normal(size=(B, 4)).astype(np.float32), _mask(B, 7)
    key = jax.random.PRNGKey(8)
    noise = torch.tensor(np.asarray(jax.random.gumbel(key, (B, A))))
    _, jchoice = jl.act(jstate, jnp.asarray(subj), jnp.asarray(mask), key, exploit=exploit)
    _, tchoice = tl.act(tstate, torch.from_numpy(subj), torch.from_numpy(mask), None,
                        exploit=exploit, noise=noise)
    assert tchoice.index.dtype == torch.int32 and tchoice.action.shape == (B, 1)
    np.testing.assert_array_equal(tchoice.index.numpy(), np.asarray(jchoice.index))
    np.testing.assert_array_equal(tchoice.action.numpy(), np.asarray(jchoice.action))
    assert mask[np.arange(B), tchoice.index.numpy()].all()


def test_runner_drives_discrete_sac_on_cpu_at_a_tiny_size():
    n, spl, lpc = 16, 2, 2
    agent = PearlAgent(
        policy_learner=SoftActorCritic(training_rounds=2, batch_size=16),
        replay_buffer=BasicReplayBuffer(capacity=64),
    )
    init_fn, run_fn = make_compiled_runner(
        agent, CartPole(), num_envs=n, steps_per_learn=spl, learns_per_call=lpc, device="cpu"
    )
    astate, env_states = init_fn(0)
    lr = astate.learner.actor_opt.param_groups[0]["lr"]
    astate, env_states, stats = run_fn(astate, env_states, make_generator(0, "cpu"))
    assert astate.learner.step == 2 * lpc and astate.replay.size == spl * lpc * n
    episodes = stats["episodes"].item()
    # Every observe decays the learning rate in place by 0.99 ** (done / n).
    assert lr is astate.learner.actor_opt.param_groups[0]["lr"]
    np.testing.assert_allclose(lr.item(), 1e-3 * 0.99 ** (episodes / n), rtol=1e-5)
    assert torch.isfinite(astate.learner.extra.log_alpha).all()
