"""The contextual bandits of the PyTorch port against the JAX package's:
`LinearRegression` and `NeuralLinearRegression`, the bandit exploration
modules, `BinaryActionRepresentation`, the activation table, the three bandit
envs, `LinearBandit`, `NeuralBandit`, `NeuralLinearBandit` and the disjoint
container in all its modes, on numpy-made inputs with the JAX side jitted.
JAX's weights are carried into the port (`utils.jax_params`), and where JAX
draws, its draws are fed to the port (`noise=`, the envs' `_transition`).
Then the reference's ground truths and anchors on the port at a tiny size.

Tolerances: statistics A and b rtol 1e-5 (over learned features TOL, the
networks' tolerance); coefficients, sigma, scores and
losses rtol 1e-4 / atol 1e-5; network parameters after AdamW steps the same,
except where optax's step is ill-conditioned
(`assert_params_close_where_adam_is_conditioned`); probabilities atol 1e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pearl_tpu.action_representation_modules import (
    BinaryActionRepresentation as JaxBinary,
)
from pearl_tpu.api.spaces import DiscreteActionSpace as JaxDiscrete
from pearl_tpu.envs import bandit as jax_bandit
from pearl_tpu.neural_networks import common as jax_common
from pearl_tpu.neural_networks.contextual_bandit import LinearRegression as JaxLinReg
from pearl_tpu.neural_networks.contextual_bandit import (
    NeuralLinearRegression as JaxNeuralLinReg,
)
from pearl_tpu.policy_learners import contextual_bandits as jcb
from pearl_tpu.policy_learners.exploration_modules import contextual_bandits as jexp
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.action_representation_modules import BinaryActionRepresentation
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.spaces import DiscreteActionSpace
from pearl_tpu_torch.envs import (
    CBState,
    ClassificationBanditEnvironment,
    LinearSyntheticBanditEnvironment,
    RewardIsTenTimesActionMABEnvironment,
    SLCBState,
)
from pearl_tpu_torch.neural_networks import ACTIVATIONS, resolve_activation
from pearl_tpu_torch.neural_networks.contextual_bandit import (
    LinearRegression,
    NeuralLinearRegression,
    append_ones,
)
from pearl_tpu_torch.policy_learners.contextual_bandits import (
    DisjointBanditContainer,
    DisjointLinearBandit,
    LinearBandit,
    NeuralBandit,
    NeuralLinearBandit,
)
from pearl_tpu_torch.policy_learners.exploration_modules import (
    FastCBExploration,
    SquareCBExploration,
    ThompsonSamplingExplorationLinear,
    UCBExploration,
    VanillaUCBExploration,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import (
    load_flax_disjoint_models,
    load_flax_linreg_state,
    load_flax_mlp,
    load_flax_neural_linear_state,
)
from test_torch_discrete_actor_critic import assert_params_close_where_adam_is_conditioned
from test_torch_on_policy import TOL, assert_adam_close, assert_leaves_close, flax_leaves

torch.set_num_threads(1)

STATS_TOL = dict(rtol=1e-5, atol=1e-6)
P_TOL = dict(rtol=0, atol=1e-6)
CPU = torch.device("cpu")


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _np(x):
    return np.asarray(x)


def _assert_stats_close(ours, theirs, tol=STATS_TOL):
    for name in ("A", "b", "sum_weight", "weight_since_discount"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), _np(getattr(theirs, name)),
                                   err_msg=name, **tol)


# ---------------------------------------------------------- LinearRegression
def _regression_stream(seed, d, steps, n=16):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=n).astype(np.float32),
               (rng.uniform(0.5, 1.5, n) * (rng.random(n) > 0.2)).astype(np.float32))


@pytest.mark.parametrize("discount", [False, True])
def test_linear_regression_matches_jax_over_weighted_updates(discount):
    d = 5
    cfg = dict(feature_dim=d, l2_reg_lambda=0.5,
               **(dict(gamma=0.8, apply_discounting_interval=20.0) if discount else {}))
    jlr, lr = JaxLinReg(**cfg), LinearRegression(**cfg)
    jstate, state = jlr.init(), lr.init(CPU)
    update = jax.jit(jlr.update)
    x_query = np.random.default_rng(9).normal(size=(3, 7, d)).astype(np.float32)
    for x, y, w in _regression_stream(1, d, 8):
        jstate = update(jstate, x, y, w)
        state = lr.update(state, _t(x), _t(y), _t(w))
        _assert_stats_close(state, jstate)
        np.testing.assert_allclose(lr.coefs(state).numpy(), _np(jlr.coefs(jstate)), **TOL)
        np.testing.assert_allclose(lr.predict(state, _t(x_query)).numpy(),
                                   _np(jlr.predict(jstate, x_query)), **TOL)
        np.testing.assert_allclose(lr.calculate_sigma(state, _t(x_query)).numpy(),
                                   _np(jlr.calculate_sigma(jstate, x_query)), **TOL)
    if discount:  # the discount fired: less weight since it than in all
        assert state.weight_since_discount.item() < state.sum_weight.item()


def test_sample_coefs_matches_jax_with_its_eps():
    d = 4
    jlr, lr = JaxLinReg(feature_dim=d), LinearRegression(feature_dim=d)
    x, y, w = next(_regression_stream(2, d, 1))
    jstate = jlr.update(jlr.init(), x, y, w)
    state = load_flax_linreg_state(jstate)
    key = jax.random.PRNGKey(3)
    eps = _t(jax.random.normal(key, (d + 1,)))
    np.testing.assert_allclose(lr.sample_coefs(state, noise=eps).numpy(),
                               _np(jlr.sample_coefs(jstate, key)), **TOL)
    # The port's own draws: the sample's covariance is A^-1.
    gen = make_generator(0, CPU)
    samples = torch.stack([lr.sample_coefs(state, gen) for _ in range(4000)])
    cov = torch.cov(samples.T).numpy()
    np.testing.assert_allclose(cov, np.linalg.inv(state.A.double().numpy()), atol=0.02)


def test_linear_regression_matches_closed_form():
    """The reference's ground truth (tests/test_bandits.py:31-53) on the port."""
    rng = np.random.RandomState(0)
    X = rng.randn(200, 3).astype(np.float32)
    w_true = np.array([0.5, -1.0, 2.0, 0.3], np.float32)
    y = append_ones(_t(X)) @ _t(w_true)
    weights = _t(rng.uniform(0.5, 2.0, 200).astype(np.float32))
    lr = LinearRegression(feature_dim=3, l2_reg_lambda=0.0)
    state = lr.update(lr.init(CPU), _t(X[:120]), y[:120], weights[:120])
    state = lr.update(state, _t(X[120:]), y[120:], weights[120:])
    np.testing.assert_allclose(lr.coefs(state).numpy(), w_true, atol=1e-3)
    lr_r = LinearRegression(feature_dim=3, l2_reg_lambda=1.0)
    s0 = lr_r.init(CPU)
    s1 = lr_r.update(s0, _t(X), y, weights)
    x0 = _t(X[:1])
    assert lr_r.calculate_sigma(s1, x0)[0] < lr_r.calculate_sigma(s0, x0)[0]


def test_linear_regression_discounting_matches_reference_ground_truth():
    """The reference's discounting protocol replayed in numpy
    (tests/test_bandits.py:56-85) against the port."""
    rng = np.random.RandomState(7)
    gamma, interval, lam, d = 0.8, 10.0, 1.0, 3
    lr = LinearRegression(feature_dim=d, l2_reg_lambda=lam, gamma=gamma,
                          apply_discounting_interval=interval)
    state = lr.init(CPU)
    A_ref, b_ref = np.zeros((d + 1, d + 1)), np.zeros(d + 1)
    sum_w = last_discount_w = 0.0
    for _ in range(12):
        X = rng.randn(4, d).astype(np.float32)
        y = rng.randn(4).astype(np.float32)
        w = rng.uniform(0.5, 1.5, 4).astype(np.float32)
        state = lr.update(state, _t(X), _t(y), _t(w))
        Xe = np.concatenate([np.ones((4, 1)), X], axis=1)
        A_ref += (Xe * w[:, None]).T @ Xe
        b_ref += (Xe * w[:, None]).T @ y
        sum_w += w.sum()
        if sum_w - last_discount_w >= interval:
            A_ref *= gamma
            b_ref *= gamma
            last_discount_w = sum_w
    coefs_ref = np.linalg.solve(A_ref + lam * np.eye(d + 1), b_ref)
    np.testing.assert_allclose(lr.coefs(state).numpy(), coefs_ref, atol=1e-4)
    np.testing.assert_allclose(state.sum_weight.item(), sum_w, rtol=1e-5)


def test_a_stack_of_regressions_equals_each_alone():
    """A state with a leading arm axis (the disjoint container's) is each
    arm's regression: shared or per-arm features, per-arm weights."""
    d, arms = 3, 4
    lr = LinearRegression(feature_dim=d)
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(arms, 10, d)).astype(np.float32))
    y = _t(rng.normal(size=10).astype(np.float32))
    w = _t(rng.uniform(0, 1, (arms, 10)).astype(np.float32))
    q = _t(rng.normal(size=(arms, 6, d)).astype(np.float32))
    for feats in (x, x[0]):
        stack = lr.update(lr.init(CPU, batch_shape=(arms,)), feats, y, w)
        mu, sigma = lr.predict(stack, q), lr.calculate_sigma(stack, q)
        for i in range(arms):
            one = lr.update(lr.init(CPU), feats[i] if feats.dim() == 3 else feats, y, w[i])
            np.testing.assert_allclose(stack.A[i].numpy(), one.A.numpy(), **STATS_TOL)
            np.testing.assert_allclose(mu[i].numpy(), lr.predict(one, q[i]).numpy(), **TOL)
            np.testing.assert_allclose(sigma[i].numpy(), lr.calculate_sigma(one, q[i]).numpy(),
                                       **TOL)


def test_statistics_stay_positive_definite_on_a_rank_deficient_batch():
    """The runner's first learn: 131072 rows, every env on the same arm, so
    the arm's columns repeat and only the ridge holds those directions. In
    float32 such a batch left A with a least eigenvalue of -0.67 on an H100
    (its factor failed and the coefficients were NaN); the port's float64
    statistics keep the ridge's 1."""
    n, arm = 131_072, np.array([0.3, -0.9, 0.5, 0.7], np.float32)
    ctx = np.random.default_rng(0).uniform(-1, 1, (n, 4)).astype(np.float32)
    x = _t(np.concatenate([ctx, np.broadcast_to(arm, (n, 4))], axis=1))
    lr = LinearRegression(feature_dim=8)
    state = lr.update(lr.init(CPU), x, x[:, :4].sum(-1) + 1.0)
    assert state.A.dtype == torch.float64
    assert torch.linalg.cholesky_ex(state.A).info.item() == 0
    assert torch.linalg.eigvalsh(state.A).min().item() > 0.99
    assert torch.isfinite(lr.coefs(state)).all()
    sigma = lr.calculate_sigma(state, x[:8])
    assert sigma.dtype == torch.float32 and torch.isfinite(sigma).all()


def test_pmean_axis_raises_for_item_20():
    # A `pmean_axis` is a mesh axis of `parallel.make_mesh`: a bare name
    # outside a mesh is a TypeError that says so.
    for make in (lambda: LinearRegression(feature_dim=2, pmean_axis="dp"),
                 lambda: LinearBandit(pmean_axis="dp").bind(DiscreteActionSpace.discrete(2))
                 .init(None, 2, DiscreteActionSpace.discrete(2), 1, CPU),
                 lambda: NeuralLinearBandit(pmean_axis="dp")):
        with pytest.raises(TypeError, match="make_mesh"):
            make()


# --------------------------------------------------------------- exploration
def _mu_sigma_mask(seed, B=64, A=6, ties=True):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(B, A)).astype(np.float32)
    if ties:  # two arms tied at the top on a quarter of the rows
        mu[: B // 4, 1] = mu[: B // 4].max(-1)
        mu[: B // 4, 3] = mu[: B // 4, 1]
    sigma = rng.uniform(0, 1, (B, A)).astype(np.float32)
    sigma[0, 2] = np.nan
    mask = rng.random((B, A)) < 0.8
    mask[:, 0] = True
    return mu, sigma, mask


def test_ucb_matches_jax_with_nan_sigma_and_masks():
    mu, sigma, mask = _mu_sigma_mask(0)
    for m in (None, mask):
        _, jidx = jexp.UCBExploration(alpha=0.7).act_scores((), mu, sigma, m, None)
        _, idx = UCBExploration(alpha=0.7).act_scores(
            (), _t(mu), _t(sigma), None if m is None else _t(m), None)
        np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_allclose(UCBExploration(alpha=0.7).scores(_t(mu), _t(sigma)).numpy(),
                               _np(jexp.UCBExploration(alpha=0.7).scores(mu, sigma)), **TOL)


CB_MODULES = [
    ("squarecb", dict(gamma=10.0)),
    ("squarecb", dict(gamma=50.0, clamp_min=-0.5, clamp_max=0.8)),
    ("fastcb", dict(gamma=10.0)),
]


def _cb_pair(kind, cfg):
    if kind == "squarecb":
        return jexp.SquareCBExploration(**cfg), SquareCBExploration(**cfg)
    return jexp.FastCBExploration(**cfg), FastCBExploration(**cfg)


@pytest.mark.parametrize("kind,cfg", CB_MODULES)
def test_squarecb_and_fastcb_match_jax_probabilities_and_draws(kind, cfg):
    """Probabilities to 1e-6 with and without masks (ties and clamps in the
    inputs), and the index of JAX's categorical given its Gumbel noise."""
    jmod, mod = _cb_pair(kind, cfg)
    mu, _, mask = _mu_sigma_mask(1)
    if kind == "fastcb":
        mu = np.abs(mu)  # FastCB's gap is relative to a positive maximum
        mu[-1] = -1.0  # ...and a row whose maximum is not
    for m in (None, mask):
        tm = None if m is None else _t(m)
        p = mod._probabilities(_t(mu), tm).numpy()
        np.testing.assert_allclose(p, _np(jmod._probabilities(mu, m)), **P_TOL)
        np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-6)
        key = jax.random.PRNGKey(4)
        _, jidx = jmod.act_scores((), mu, None, m, key)
        noise = _t(jax.random.gumbel(key, mu.shape))
        _, idx = mod.act_scores((), _t(mu), None, tm, None, noise=noise)
        np.testing.assert_array_equal(idx.numpy(), _np(jidx))
        if m is not None:
            assert m[np.arange(len(mu)), idx.numpy()].all()


@pytest.mark.parametrize("kind,cfg", CB_MODULES[:1] + CB_MODULES[2:])
def test_squarecb_and_fastcb_own_draws_follow_their_probabilities(kind, cfg):
    """A chi-square over 100000 of the port's own draws from one row."""
    _, mod = _cb_pair(kind, cfg)
    mu = torch.tensor([[0.9, 0.5, 0.85, 0.1, 0.7]])
    p = mod._probabilities(mu, None)[0].double().numpy()
    n = 100_000
    _, idx = mod.act_scores((), mu.expand(n, -1), None, None, make_generator(1, CPU))
    counts = np.bincount(idx.numpy(), minlength=5)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 18.47, (chi2, counts, n * p)  # 4 dof, p = 0.001


def test_thompson_sampling_matches_jax_with_its_eps():
    mu, sigma, mask = _mu_sigma_mask(2)
    key = jax.random.PRNGKey(5)
    _, jidx = jexp.ThompsonSamplingExplorationLinear().act_scores((), mu, sigma, mask, key)
    eps = _t(jax.random.normal(key, mu.shape))
    _, idx = ThompsonSamplingExplorationLinear().act_scores(
        (), _t(mu), _t(sigma), _t(mask), None, noise=eps)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))


def test_vanilla_ucb_matches_jax_over_five_calls():
    """Five acts of 64 envs: indices and counts equal, the bonus of each act
    to JAX's (whose float32 total is exact below 2^24)."""
    A = 6
    jmod, mod = jexp.VanillaUCBExploration(num_actions=A), VanillaUCBExploration(num_actions=A)
    jstate, state = jmod.init(64), mod.init(64, CPU)
    act = jax.jit(lambda s, mu, m: jmod.act_scores(s, mu, None, m, None))
    for i in range(5):
        mu, _, mask = _mu_sigma_mask(10 + i, A=A, ties=False)
        mu *= 0.1
        # JAX's bonus, as its act_scores computes it from its state.
        t = jnp.maximum(jstate.total, 1.0)
        jbonus = jnp.sqrt(2.0 * jnp.log(t) / jnp.maximum(jstate.action_counts, 1e-3))
        np.testing.assert_allclose(mod.bonus(state).numpy(), _np(jbonus), rtol=1e-6)
        jstate, jidx = act(jstate, mu, mask)
        state, idx = mod.act_scores(state, _t(mu), None, _t(mask), None)
        np.testing.assert_array_equal(idx.numpy(), _np(jidx))
        np.testing.assert_array_equal(state.action_counts.numpy(), _np(jstate.action_counts))
        assert state.total == int(jstate.total) == 64 * (i + 1)
        assert state.action_counts.dtype == torch.int64


def test_vanilla_ucb_counts_stay_exact_past_two_to_the_24():
    """Where JAX's float32 counters stop (2^24 + 1 rounds to 2^24), the
    port's int64 counts and host total go on counting."""
    mod = VanillaUCBExploration(num_actions=2)
    big = 2**24
    state = dataclasses.replace(mod.init(4, CPU), total=2 * big,
                                action_counts=torch.tensor([big, big]))
    mu = torch.tensor([[1.0, 0.0]] * 4)
    state, idx = mod.act_scores(state, mu, None, None, None)
    assert (idx == 0).all() and state.action_counts[0].item() == big + 4
    assert state.total == 2 * big + 4
    assert np.float32(big) + np.float32(1) == np.float32(big)  # the JAX counter's stop


# ----------------------------------------- action representation, activations
@pytest.mark.parametrize("bits", [0, 1, 3, 5])
def test_binary_action_representation_matches_jax_for_every_index(bits):
    jrep, rep = JaxBinary(bits=bits), BinaryActionRepresentation(bits=bits)
    n = 2 ** (bits or 8)
    actions = np.arange(n, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(rep.apply(_t(actions)).numpy(), _np(jrep.apply(actions)))
    assert rep.representation_dim(1, 10) == jrep.representation_dim(1, 10)
    for k in (2, 3, 10, 26, 300):
        assert rep.resolve(1, k) == BinaryActionRepresentation(bits=jrep.resolve(1, k).bits)
    with pytest.raises(ValueError, match="action_dim=1"):
        rep.resolve(3, 10)


def test_activation_table_matches_jax():
    x = np.linspace(-30, 30, 241).astype(np.float32)
    assert set(ACTIVATIONS) == set(jax_common.ACTIVATIONS)
    for name in ACTIVATIONS:
        np.testing.assert_allclose(resolve_activation(name)(_t(x)).numpy(),
                                   _np(jax_common.resolve_activation(name)(x)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert resolve_activation(torch.tanh) is torch.tanh


# ----------------------------------------------------------------------- envs
B = 64


def _keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_linear_synthetic_env_matches_jax_with_its_draws():
    jenv, env = jax_bandit.LinearSyntheticBanditEnvironment(seed=3), \
        LinearSyntheticBanditEnvironment(seed=3)
    np.testing.assert_array_equal(env.arm_features.numpy(), _np(jenv._arm_features))
    np.testing.assert_array_equal(env.linear_mapping.numpy(), _np(jenv._linear_mapping))
    rng = np.random.default_rng(0)
    context = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    actions = _np(jenv._arm_features)[rng.integers(0, 5, B)]
    keys = _keys(B)
    _, jres = jax.jit(jax.vmap(jenv.step))(jax_bandit.CBState(context=context), actions, keys)
    split = jax.vmap(jax.random.split)(keys)
    k_noise, k_ctx = split[:, 0], split[:, 1]
    noise = _t(jax.vmap(jax.random.normal)(k_noise))
    new_ctx = _t(jax.vmap(lambda k: jax.random.uniform(k, (4,), minval=-1, maxval=1))(k_ctx))
    _, res = env._transition(CBState(context=_t(context)), _t(actions), noise, new_ctx)
    np.testing.assert_allclose(res.reward.numpy(), _np(jres.reward), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res.info["regret"].numpy(), _np(jres.info["regret"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(res.observation.numpy(), _np(jres.observation))
    np.testing.assert_array_equal(res.terminated.numpy(), _np(jres.terminated))
    np.testing.assert_array_equal(res.truncated.numpy(), _np(jres.truncated))
    np.testing.assert_allclose(env._mean_rewards(_t(context)).numpy(),
                               _np(jax.vmap(jenv._mean_rewards)(context)), rtol=1e-6, atol=1e-6)
    # The port's own draws: contexts uniform on [-1, 1), rewards around the mean.
    state, obs = env.reset(20_000, make_generator(0, CPU), CPU)
    assert obs.min() >= -1 and obs.max() < 1 and abs(obs.mean().item()) < 0.02
    arms = env.arm_features[torch.zeros(20_000, dtype=torch.long)]
    _, res = env.step(state, arms)
    resid = res.reward - env._mean_rewards(state.context)[:, 0]
    assert abs(resid.std().item() - 0.1) < 0.005 and res.terminated.all()


def test_ten_times_mab_matches_jax():
    jenv, env = jax_bandit.RewardIsTenTimesActionMABEnvironment(), \
        RewardIsTenTimesActionMABEnvironment()
    actions = np.random.default_rng(1).integers(0, 4, (B, 1)).astype(np.float32)
    jstate, jobs = jax.vmap(jenv.reset)(_keys(B))
    state, obs = env.reset(B, make_generator(0, CPU), CPU)
    np.testing.assert_array_equal(obs.numpy(), _np(jobs))
    _, jres = jax.vmap(jenv.step)(jstate, actions, _keys(B))
    _, res = env.step(state, _t(actions))
    for name in ("observation", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), _np(getattr(jres, name)))


def test_classification_env_matches_jax_with_its_draws():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(50, 3)).astype(np.float32)
    y = rng.integers(0, 4, 50).astype(np.int32)
    jenv, env = jax_bandit.ClassificationBanditEnvironment(features=X, labels=y), \
        ClassificationBanditEnvironment(features=X, labels=y)
    assert env.action_space.n == jenv.action_space.n == 4
    rows = rng.integers(0, 50, B).astype(np.int32)
    actions = rng.integers(0, 4, (B, 1)).astype(np.float32)
    actions[:16, 0] = y[rows[:16]]  # some right
    keys = _keys(B, 3)
    _, jres = jax.jit(jax.vmap(jenv.step))(jax_bandit._SLCBState(row=rows), actions, keys)
    next_row = _t(jax.vmap(lambda k: jax.random.randint(k, (), 0, 50))(keys))
    state, res = env._transition(SLCBState(row=_t(rows).long()), _t(actions), next_row)
    for name in ("observation", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), _np(getattr(jres, name)))
    np.testing.assert_array_equal(res.info["regret"].numpy(), _np(jres.info["regret"]))
    assert (res.reward[:16] == 1).all()
    np.testing.assert_array_equal(state.row.numpy(), next_row.numpy())
    # The port's own rows: uniform over the dataset.
    state, obs = env.reset(50_000, make_generator(0, CPU), CPU)
    counts = np.bincount(state.row.numpy(), minlength=50)
    chi2 = float(((counts - 1000) ** 2 / 1000).sum())
    assert chi2 < 85.35, chi2  # 49 dof, p = 0.001
    np.testing.assert_array_equal(obs.numpy(), X[state.row.numpy()])


# ------------------------------------------------------------------- learners
def _rows(seed, n, obs_dim, num_actions, reward="normal"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, num_actions, n).astype(np.int32)
    r = (rng.random(n) < 0.5) if reward == "binary" else rng.normal(size=n)
    return dict(
        state=rng.normal(size=(n, obs_dim)).astype(np.float32),
        action_index=idx,
        reward=r.astype(np.float32),
        weight=(rng.uniform(0.5, 1.5, n) * (rng.random(n) > 0.1)).astype(np.float32),
    )


def _batches(rows, elements):
    """(JAX batch, port batch) of `rows`; the stored action is the arm's
    element of `elements` (A, a)."""
    n = len(rows["reward"])
    action = elements[rows["action_index"]]
    common = dict(state=rows["state"], action=action, reward=rows["reward"],
                  next_state=rows["state"], action_index=rows["action_index"],
                  weight=rows["weight"])
    jb = JaxBatch(terminated=np.ones(n, bool), truncated=np.zeros(n, bool), **common)
    tb = TransitionBatch(terminated=torch.ones(n, dtype=torch.bool),
                         truncated=torch.zeros(n, dtype=torch.bool),
                         **{k: _t(v) for k, v in common.items()})
    return jb, tb


def _pair(jlearner, learner, space, jspace, obs_dim, num_envs=8):
    jlearner, learner = jlearner.bind(jspace), learner.bind(space)
    jstate = jlearner.init(jax.random.PRNGKey(0), obs_dim, jspace, num_envs)
    state = learner.init(make_generator(0, CPU), obs_dim, space, num_envs, CPU)
    return jlearner, learner, jstate, state


def _synthetic_spaces(seed=3):
    jenv = jax_bandit.LinearSyntheticBanditEnvironment(seed=seed)
    env = LinearSyntheticBanditEnvironment(seed=seed)
    return jenv, env


def test_linear_bandit_ten_act_and_learn_steps_match_jax():
    """LinUCB on the synthetic env's arms: ten acts of 8 envs (the same
    indices), each followed by `learn` over a 16-slot buffer that holds the
    step's 8 rows (8 slots unwritten, weighted 0): A and b equal."""
    jenv, env = _synthetic_spaces()
    jlearner, learner, jstate, state = _pair(
        jcb.LinearBandit(exploration=jexp.UCBExploration(alpha=1.0), l2_reg_lambda=0.5),
        LinearBandit(exploration=UCBExploration(alpha=1.0), l2_reg_lambda=0.5),
        env.action_space, jenv.action_space, 4)
    jbuf, buf = JaxBuffer(capacity=16), BasicReplayBuffer(capacity=16)
    elements = env.arm_features.numpy()
    jact = jax.jit(lambda s, x: jlearner.act(s, x, None, jax.random.PRNGKey(0)))

    @jax.jit
    def jlearn(s, batch):
        bstate = jbuf.push(jbuf.init(jax.tree.map(lambda x: x[:1], batch)), batch)
        return jlearner.learn(s, jbuf, bstate, jax.random.PRNGKey(0))[0]

    rng = np.random.default_rng(0)
    for i in range(10):
        ctx = rng.uniform(-1, 1, (8, 4)).astype(np.float32)
        jstate, jchoice = jact(jstate, ctx)
        state, choice = learner.act(state, _t(ctx), None, None)
        np.testing.assert_array_equal(choice.index.numpy(), _np(jchoice.index))
        np.testing.assert_array_equal(choice.action.numpy(), _np(jchoice.action))
        rows = dict(state=ctx, action_index=_np(jchoice.index),
                    reward=rng.normal(size=8).astype(np.float32),
                    weight=np.ones(8, np.float32))
        jb, tb = _batches(rows, elements)
        jb = jb.replace(weight=None)
        tb = dataclasses.replace(tb, weight=None)
        jstate = jlearn(jstate, jb)
        bstate = buf.push(buf.init(tb), tb, None)
        assert bstate.size == 8
        state, _, metrics = learner.learn(state, buf, bstate, None)
        _assert_stats_close(state.model, jstate.model)
    assert state.model.sum_weight.item() == 80


def test_linear_bandit_learn_refuses_resampling_and_reweighting():
    env = LinearSyntheticBanditEnvironment()
    learner = LinearBandit().bind(env.action_space)
    state = learner.init(None, 4, env.action_space, 2, CPU)
    _, tb = _batches(_rows(0, 4, 4, 5), env.arm_features.numpy())
    buf = BasicReplayBuffer(capacity=4)
    bstate = buf.push(buf.init(tb), tb, None)
    with pytest.raises(ValueError, match="twice"):
        learner.learn(state, buf, bstate, None, indices=torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="batch_transform"):
        learner.learn(state, buf, bstate, None, batch_transform=lambda b: b)
    container = DisjointLinearBandit().bind(env.action_space)
    with pytest.raises(ValueError, match="twice"):
        container.learn(container.init(None, 4, env.action_space, 2, CPU), buf, bstate, None,
                        indices=torch.zeros((1, 4), dtype=torch.long))


def _assert_net_close(module, optimizer, jparams, jopt, lr, shaky):
    """Parameters after AdamW steps against optax's (at TOL where its step
    is well conditioned), and the moments and count. A stacked optax state
    (the container's arms) has one count an arm, all equal."""
    adam = jopt[0]
    count = np.asarray(adam.count).reshape(-1)
    assert (count == count[0]).all()
    single = (types.SimpleNamespace(count=int(count[0]), mu=adam.mu, nu=adam.nu),)
    assert_params_close_where_adam_is_conditioned(module, jparams, single, lr, shaky)
    assert_adam_close(optimizer, module, single)


@pytest.mark.parametrize("loss_type", ["mse", "mae", "cross_entropy"])
def test_neural_bandit_three_learn_steps_match_optax(loss_type):
    space, jspace = DiscreteActionSpace.discrete(5), JaxDiscrete.discrete(5)
    cfg = dict(hidden_dims=(16, 8), learning_rate=0.01, loss_type=loss_type)
    jlearner, learner, jstate, state = _pair(
        jcb.NeuralBandit(action_representation=JaxBinary(), **cfg),
        NeuralBandit(action_representation=BinaryActionRepresentation(), **cfg),
        space, jspace, 6)
    np_params = jax.tree.map(np.asarray, jstate.params)
    load_flax_mlp(state.params, np_params)
    assert_leaves_close(flax_leaves(state.params), np_params)
    learn = jax.jit(jlearner.learn_batch)
    elements = space.elements.numpy()
    shaky = {}
    for i in range(3):
        jb, tb = _batches(_rows(i, 32, 6, 5, "binary" if loss_type == "cross_entropy"
                                else "normal"), elements)
        jstate, jm = learn(jstate, jb)
        state, m = learner.learn_batch(state, tb)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)
        _assert_net_close(state.params, state.optimizer, jstate.params, jstate.opt_state, 0.01,
                          shaky)
    ctx = np.random.default_rng(7).normal(size=(4, 6)).astype(np.float32)
    feats = learner.arm_features(state, _t(ctx))
    np.testing.assert_allclose(learner.mu_sigma(state, feats)[0].detach().numpy(),
                               _np(jlearner.mu_sigma(jstate, jlearner.arm_features(ctx))[0]),
                               **TOL)


NLB_CASES = [(e2e, act, sep) for e2e in (True, False) for act in ("linear", "sigmoid")
             for sep in (False, True)]


@pytest.mark.parametrize("nn_e2e,activation,separate", NLB_CASES)
def test_neural_linear_bandit_three_steps_match_jax(nn_e2e, activation, separate):
    """Three `learn_batch` steps (one AdamW step on the activated head, then
    the statistics on the updated features), then mu, sigma, `get_scores`
    and the acts of UCB and of Thompson sampling on JAX's draws."""
    jenv, env = _synthetic_spaces()
    cfg = dict(hidden_dims=(16,), linear_feature_dim=6, learning_rate=0.01, nn_e2e=nn_e2e,
               output_activation=activation, separate_uncertainty=separate)
    jlearner, learner, jstate, state = _pair(
        jcb.NeuralLinearBandit(exploration=jexp.UCBExploration(alpha=2.0), **cfg),
        NeuralLinearBandit(exploration=UCBExploration(alpha=2.0), **cfg),
        env.action_space, jenv.action_space, 4)
    state = load_flax_neural_linear_state(state, jax.tree.map(np.asarray, dict(
        mlp=jstate.mlp_params, head=jstate.head_params, linreg=jstate.linreg)))
    trainable = nn.ModuleDict({"mlp": state.mlp_params, "head": state.head_params})
    learn = jax.jit(jlearner.learn_batch)
    elements = env.arm_features.numpy()
    shaky = {}
    for i in range(3):
        rows = _rows(20 + i, 32, 4, 5, "binary" if activation == "sigmoid" else "normal")
        jb, tb = _batches(rows, elements)
        jstate, jm = learn(jstate, jb)
        state, m = learner.learn_batch(state, tb)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)
        _assert_net_close(trainable, state.optimizer,
                          {"mlp": jstate.mlp_params, "head": jstate.head_params},
                          jstate.opt_state, 0.01, shaky)
        # The statistics sum products of the updated MLP's outputs, which carry
        # its float32 rounding (b loses 2e-5 of an element to cancellation):
        # they are held at the networks' TOL, not at STATS_TOL.
        _assert_stats_close(state.linreg, jstate.linreg, TOL)
    ctx = np.random.default_rng(8).normal(size=(16, 4)).astype(np.float32)
    feats = learner.arm_features(state, _t(ctx))
    mu, sigma = learner.mu_sigma(state, feats)
    jmu, jsigma = jlearner.mu_sigma(jstate, jlearner.arm_features(ctx))
    np.testing.assert_allclose(mu.detach().numpy(), _np(jmu), **TOL)
    np.testing.assert_allclose(sigma.detach().numpy(), _np(jsigma), **TOL)
    np.testing.assert_allclose(learner.get_scores(state, _t(ctx)).numpy(),
                               _np(jlearner.get_scores(jstate, ctx)), **TOL)
    _, choice = learner.act(state, _t(ctx), None, None)
    _, jchoice = jlearner.act(jstate, ctx, None, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(choice.index.numpy(), _np(jchoice.index))
    ts, jts = (dataclasses.replace(x, exploration=e) for x, e in (
        (learner, ThompsonSamplingExplorationLinear()),
        (jlearner, jexp.ThompsonSamplingExplorationLinear())))
    key = jax.random.PRNGKey(9)
    _, jchoice = jts.act(jstate, ctx, None, key)
    _, choice = ts.act(state, _t(ctx), None, None, noise=_t(jax.random.normal(key, (16, 5))))
    np.testing.assert_array_equal(choice.index.numpy(), _np(jchoice.index))


@pytest.mark.parametrize("nn_e2e", [True, False])
def test_neural_linear_regression_features_match_jax(nn_e2e):
    """`features` is the MLP's output (relu last activation), and
    `forward_with_intermediate_values` returns it as its third value."""
    cfg = dict(feature_dim=6, hidden_dims=(16, 8), linear_feature_dim=4, nn_e2e=nn_e2e)
    jmodel, model = JaxNeuralLinReg(**cfg), NeuralLinearRegression(**cfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    load_flax_mlp(params.mlp, jax.tree.map(np.asarray, jparams["mlp"]))
    load_flax_mlp(params.head, jax.tree.map(np.asarray, jparams["head"]))
    x = np.random.default_rng(6).normal(size=(11, 6)).astype(np.float32)
    with torch.no_grad():
        feats = model.features(params, _t(x))
        third = model.forward_with_intermediate_values(params, _t(x))[2]
    ref = _np(jmodel.features(jparams, jnp.asarray(x)))
    assert feats.shape == ref.shape == (11, 4) and (ref >= 0).all()
    np.testing.assert_allclose(feats.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(third, feats)


# -------------------------------------------------------- disjoint container
def _ground_truth(num_arms=3, feat=4, n=512, seed=0, per_arm_states=False):
    """Per-arm linear rewards r = w_arm . x (tests/test_bandits.py:150-174)."""
    rng = np.random.RandomState(seed)
    W = rng.uniform(-1, 1, (num_arms, feat)).astype(np.float32)
    shape = (n, num_arms, feat) if per_arm_states else (n, feat)
    state = rng.uniform(-1, 1, shape).astype(np.float32)
    idx = rng.randint(0, num_arms, (n,)).astype(np.int32)
    x_taken = state[np.arange(n), idx] if per_arm_states else state
    reward = np.einsum("nf,nf->n", x_taken, W[idx]).astype(np.float32)
    rows = dict(state=state, action_index=idx, reward=reward,
                weight=np.ones(n, np.float32))
    return W, rows


def _container_pair(arm_learners, num_arms=3, **kw):
    space, jspace = DiscreteActionSpace.discrete(num_arms), JaxDiscrete.discrete(num_arms)
    jarms, arms = arm_learners
    return _pair(
        jcb.DisjointBanditContainer(arm_learner=jarms, exploration=jexp.UCBExploration(alpha=0.5),
                                    **kw),
        DisjointBanditContainer(arm_learner=arms, exploration=UCBExploration(alpha=0.5), **kw),
        space, jspace, 4)


def _assert_acts_match(jlearner, learner, jstate, state, seed=1, n=32, **tol):
    ctx = np.random.RandomState(seed).uniform(-1, 1, (n, 4)).astype(np.float32)
    mu, sigma = learner.mu_sigma(state, learner.arm_features(state, _t(ctx)))
    jmu, jsigma = jlearner.mu_sigma(jstate, jlearner.arm_features(ctx))
    np.testing.assert_allclose(mu.detach().numpy(), _np(jmu), **(tol or TOL))
    np.testing.assert_allclose(sigma.detach().numpy(), _np(jsigma), **(tol or TOL))
    for exploit in (True, False):
        _, choice = learner.act(state, _t(ctx), None, None, exploit=exploit)
        _, jchoice = jlearner.act(jstate, ctx, None, jax.random.PRNGKey(0), exploit=exploit)
        np.testing.assert_array_equal(choice.index.numpy(), _np(jchoice.index))
    return ctx


def test_disjoint_linear_arms_match_jax_and_recover_the_ground_truth():
    W, rows = _ground_truth()
    jlearner, learner, jstate, state = _container_pair((jcb.LinearBandit(), LinearBandit()),
                                                       l2_reg_lambda=1e-4)
    assert state.models.A.shape == (3, 5, 5)
    elements = np.arange(3, dtype=np.float32)[:, None]
    jb, tb = _batches(rows, elements)
    jstate, _ = jax.jit(jlearner.learn_batch)(jstate, jb)
    state, _ = learner.learn_batch(state, tb)
    _assert_stats_close(state.models, jstate.models)
    coefs = LinearRegression(feature_dim=4).coefs(state.models)
    np.testing.assert_allclose(coefs[:, 1:].numpy(), W, atol=0.02)
    ctx = _assert_acts_match(jlearner, learner, jstate, state)
    _, choice = learner.act(state, _t(ctx), None, None, exploit=True)
    np.testing.assert_array_equal(choice.index.numpy(), (ctx @ W.T).argmax(1))


def test_disjoint_neural_arms_match_optax_over_three_steps_with_an_idle_arm():
    """Stacked NeuralBandit arms, three AdamW steps; in the second step arm
    2 has no row, so it takes a zero-gradient step (weight decay and moment
    decay only), exactly as its optax step does."""
    hidden, lr = (8,), 3e-3
    jlearner, learner, jstate, state = _container_pair(
        (jcb.NeuralBandit(hidden_dims=hidden, learning_rate=lr),
         NeuralBandit(hidden_dims=hidden, learning_rate=lr)))
    state = load_flax_disjoint_models(learner, state, jax.tree.map(np.asarray, jstate.models))
    arms = state.models
    learn = jax.jit(jlearner.learn_batch)
    shaky = {}
    elements = np.arange(3, dtype=np.float32)[:, None]
    for i in range(3):
        _, rows = _ground_truth(n=64, seed=10 + i)
        if i == 1:
            rows["action_index"] = rows["action_index"] % 2  # arm 2 idle
        jb, tb = _batches(rows, elements)
        before = arms.params.dense_0.kernel[2].detach().clone()
        jstate, _ = learn(jstate, jb)
        state, _ = learner.learn_batch(state, tb)
        _assert_net_close(arms.params, arms.optimizer, jstate.models["params"],
                          jstate.models["opt"], lr, shaky)
        assert int(np.asarray(jstate.models["opt"][0].count)[0]) == i + 1
        if i == 1:  # the idle arm still moved: decay of weights and moments
            assert not torch.equal(before, arms.params.dense_0.kernel[2])
    _assert_acts_match(jlearner, learner, jstate, state)


def test_disjoint_heterogeneous_arms_keep_their_groups_and_order():
    """[linear, linear, neural]: two stacks, [0, 1] and [2]; the columns put
    back in arm order; two learn steps against JAX."""
    lin = dict(l2_reg_lambda=1e-4)
    neural = dict(hidden_dims=(8,), learning_rate=3e-3)
    jarms = [jcb.LinearBandit(**lin), jcb.NeuralBandit(**neural), jcb.LinearBandit(**lin)]
    arms = [LinearBandit(**lin), NeuralBandit(**neural), LinearBandit(**lin)]
    jlearner, learner, jstate, state = _container_pair((jarms, arms))
    assert [idxs for _, idxs in learner._groups()] == [[0, 2], [1]]
    assert [idxs for _, idxs in jlearner._groups()] == [[0, 2], [1]]
    np.testing.assert_array_equal(state.inverse.numpy(), [0, 2, 1])
    state = load_flax_disjoint_models(learner, state, jax.tree.map(np.asarray, jstate.models))
    learn = jax.jit(jlearner.learn_batch)
    elements = np.arange(3, dtype=np.float32)[:, None]
    shaky = {}
    for i in range(2):
        _, rows = _ground_truth(n=128, seed=20 + i)
        jb, tb = _batches(rows, elements)
        jstate, _ = learn(jstate, jb)
        state, _ = learner.learn_batch(state, tb)
        _assert_stats_close(state.models[0], jstate.models[0])
        _assert_net_close(state.models[1].params, state.models[1].optimizer,
                          jstate.models[1]["params"], jstate.models[1]["opt"], 3e-3, shaky)
    _assert_acts_match(jlearner, learner, jstate, state)


def test_disjoint_per_arm_3d_states_match_jax():
    W, rows = _ground_truth(per_arm_states=True, seed=4)
    jlearner, learner, jstate, state = _container_pair((jcb.LinearBandit(), LinearBandit()),
                                                       l2_reg_lambda=1e-4)
    jb, tb = _batches(rows, np.arange(3, dtype=np.float32)[:, None])
    jstate, _ = jlearner.learn_batch(jstate, jb)
    state, _ = learner.learn_batch(state, tb)
    _assert_stats_close(state.models, jstate.models)
    coefs = LinearRegression(feature_dim=4).coefs(state.models)
    np.testing.assert_allclose(coefs[:, 1:].numpy(), W, atol=0.03)


def test_disjoint_arm_count_mismatch_raises():
    space = DiscreteActionSpace.discrete(3)
    learner = DisjointBanditContainer(arm_learner=[LinearBandit(), LinearBandit()]).bind(space)
    with pytest.raises(ValueError, match="arm learners"):
        learner.init(None, 4, space, 8, CPU)


# ----------------------------------------------------------- the slice, tiny
def _run(learner, env, steps, num_envs=16):
    agent = PearlAgent(policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=num_envs))
    return online_learning(agent, env, num_envs=num_envs, max_steps=steps,
                           learn_every_k_steps=1, seed=0, device="cpu")


def test_linucb_anchor_on_the_synthetic_env():
    """tests/test_bandits.py:108-122 on the port: LinUCB through
    `online_learning`, then greedy regret below 0.1 on 256 contexts."""
    env = LinearSyntheticBanditEnvironment(seed=3)
    res = _run(LinearBandit(exploration=UCBExploration(alpha=1.0)), env, 4096)
    assert res.agent_state.replay.size == 0  # cleared after every learn
    assert res.agent_state.learner.model.sum_weight.item() == 4096
    learner = LinearBandit(exploration=UCBExploration(alpha=1.0)).bind(env.action_space)
    gen = make_generator(42, CPU)
    ctx = torch.rand((256, 4), generator=gen) * 2 - 1
    _, choice = learner.act(res.agent_state.learner, ctx, None, gen, exploit=True)
    means = env._mean_rewards(ctx)
    regret = (means.max(1).values - means.gather(1, choice.index.long()[:, None])[:, 0]).mean()
    assert regret.item() < 0.1, regret.item()


def test_mab_anchor_with_the_disjoint_container():
    """tests/test_bandits.py:132-147: UCB(alpha=40) arms on the ten-times
    MAB pick arm 3 greedily everywhere."""
    env = RewardIsTenTimesActionMABEnvironment(num_arms=4)
    res = _run(DisjointBanditContainer(exploration=UCBExploration(alpha=40.0)), env, 2048)
    learner = DisjointBanditContainer(exploration=UCBExploration(alpha=40.0)).bind(
        env.action_space)
    _, choice = learner.act(res.agent_state.learner, torch.zeros((8, 1)), None, None,
                            exploit=True)
    assert (choice.index == 3).all()


def test_neural_linear_sigmoid_head_fits_its_ground_truth():
    """tests/test_bandits.py:389-424 on the port, both placements: the
    activated head's loss below 0.01 after 300 batches."""
    w = torch.tensor([1.5, -2.0, 0.8, 0.0])
    space = DiscreteActionSpace.create(torch.eye(2))
    for separate in (False, True):
        learner = NeuralLinearBandit(
            exploration=UCBExploration(alpha=0.1), output_activation="sigmoid",
            separate_uncertainty=separate, hidden_dims=(32,), linear_feature_dim=8,
            learning_rate=3e-3, state_features_only=True).bind(space)
        state = learner.init(make_generator(0, CPU), 4, space, 1, CPU)
        gen = torch.Generator().manual_seed(3)
        for _ in range(300):
            x = torch.randn((64, 4), generator=gen)
            batch = TransitionBatch(
                state=x, action=torch.zeros((64, 1)), reward=torch.sigmoid(x @ w),
                next_state=x, terminated=torch.ones(64, dtype=torch.bool),
                truncated=torch.zeros(64, dtype=torch.bool),
                action_index=torch.zeros(64, dtype=torch.int32))
            state, metrics = learner.learn_batch(state, batch)
        assert metrics["loss"].item() < 0.01, (separate, metrics["loss"].item())
