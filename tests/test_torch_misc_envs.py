"""The mean-variance bandit, the fixed-length env, the recommender and the
wrappers `SparseRewardWrapper`, `FlattenObservations`,
`FlattenDictObservations` and `OneHotObservationsFromDiscrete` of the
PyTorch port against the JAX package's: numpy-made states and actions
through one step, the JAX step under `jax.vmap`, with JAX's own draws fed to
the port's `_transition` (the bandit's noise, the recommender's click and
slate). The recommender's catalog and user model come from the JAX env
(`recommender_env_from_jax`). Then the port's own slates (a chi-square over
the item frequencies), the exports, and the slice at a tiny size: DQN on the
recommender and QR-DQN on the bandit through `online_learning`.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pearl_tpu.envs as jax_envs
import pearl_tpu_torch.envs as port_envs
from pearl_tpu.api.spaces import BoxSpace as JaxBox
from pearl_tpu.api.spaces import DiscreteSpace as JaxDiscrete
from pearl_tpu.api.types import ActionResult as JaxResult
from pearl_tpu.envs import misc as jax_misc
from pearl_tpu.envs import puckworld as jax_puckworld
from pearl_tpu.envs import recsys as jax_recsys
from pearl_tpu.envs import wrappers as jax_wrappers
from pearl_tpu_torch.action_representation_modules import IdentityActionRepresentation
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteSpace
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs import (
    CartPole,
    FixedNumberOfStepsEnvironment,
    FlattenDictObservations,
    FlattenObservations,
    FrozenLake,
    FrozenLakeState,
    MeanVarBanditEnvironment,
    OneHotObservationsFromDiscrete,
    PuckWorld,
    PuckWorldState,
    RecSysState,
    SparseRewardWrapper,
    StepCountState,
)
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    DeepQLearning,
    QuantileRegressionDeepQLearning,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.safety_modules import RiskNeutralSafetyModule
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import recommender_env_from_jax

torch.set_num_threads(1)
B = 64


def _keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _vmap_step(jenv, jstate, actions, keys):
    return jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(actions), keys)


# ----------------------------------------------------------- the misc envs
def test_mean_var_bandit_step_matches_jax_with_its_draws():
    actions = np.random.default_rng(0).integers(0, 2, (B, 1)).astype(np.float32)
    keys = _keys(B)
    jenv = jax_misc.MeanVarBanditEnvironment()
    _, jres = _vmap_step(jenv, jax_misc._ScalarState(t=jnp.zeros(B, jnp.int32)), actions, keys)
    noise = torch.from_numpy(np.array(jax.vmap(jax.random.normal)(keys)))
    env = MeanVarBanditEnvironment()
    _, res = env._transition(StepCountState(t=torch.zeros(B, dtype=torch.int32)),
                             torch.from_numpy(actions), noise)
    np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward), rtol=1e-6, atol=1e-6)
    for name in ("observation", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(jres, name)))
    assert (res.reward[actions[:, 0] == 0] == 1.0).all()
    # The port's own draws: N(2, 16) on the risky arm.
    state, obs = env.reset(100_000, make_generator(0, "cpu"), "cpu")
    assert obs.shape == (100_000, 1)
    _, res = env.step(state, torch.ones((100_000, 1)))
    assert abs(res.reward.mean().item() - 2.0) < 0.05 and abs(res.reward.std().item() - 4.0) < 0.05


def test_fixed_number_of_steps_env_matches_jax_over_an_episode():
    n = 5
    jenv, env = jax_misc.FixedNumberOfStepsEnvironment(n), FixedNumberOfStepsEnvironment(n)
    actions = np.random.default_rng(1).integers(0, 2, (n, 8, 1)).astype(np.float32)
    jstate, _ = jax.vmap(jenv.reset)(_keys(8))
    state, obs = env.reset(8, make_generator(0, "cpu"), "cpu")
    assert obs.shape == (8, 1) and env.max_episode_steps == n == jenv.max_episode_steps
    for i in range(n):
        jstate, jres = _vmap_step(jenv, jstate, actions[i], _keys(8, i))
        state, res = env.step(state, torch.from_numpy(actions[i]))
        for name in ("observation", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
    assert res.truncated.all()


# ------------------------------------------------------------- the wrappers
def test_sparse_reward_wrapper_matches_jax():
    """Success within 0.1 of the target (configs.py:681-685) over a PuckWorld
    step that relocates nothing, so the step's draws are not used."""
    rng = np.random.default_rng(2)
    f = dict(pos=rng.uniform(0, 1, (B, 2)), vel=rng.uniform(-0.01, 0.01, (B, 2)),
             bad=rng.uniform(0, 1, (B, 2)))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["good"] = (f["pos"] + rng.uniform(-0.12, 0.12, (B, 2))).astype(np.float32)
    f["t"] = rng.integers(0, 250, B).astype(np.int32)
    actions = np.zeros((B, 1), np.float32)
    jenv = jax_wrappers.SparseRewardWrapper(
        jax_puckworld.PuckWorld(),
        success_fn=lambda o: jnp.linalg.norm(o[..., 0:2] - o[..., 4:6], axis=-1) < 0.1)
    _, jres = _vmap_step(jenv, jax_puckworld.PuckWorldState(
        **{k: jnp.asarray(v) for k, v in f.items()}), actions, _keys(B))
    env = SparseRewardWrapper(PuckWorld(), success_fn=lambda o: torch.linalg.vector_norm(
        o[..., 0:2] - o[..., 4:6], dim=-1) < 0.1)
    state = PuckWorldState(**{k: torch.from_numpy(v) for k, v in f.items()},
                           generator=make_generator(0, "cpu"))
    _, res = env.step(state, torch.from_numpy(actions))
    np.testing.assert_array_equal(res.reward.numpy(), np.asarray(jres.reward))
    assert 0 < res.reward.sum() < B and res.reward.dtype == torch.float32


@dataclasses.dataclass(frozen=True)
class _DictObsEnv(Environment):
    """A (B, ...) dict observation, nested, of Box and Discrete parts."""

    @property
    def action_space(self):
        return port_envs.CartPole().action_space

    @property
    def observation_space(self):
        return {"b": BoxSpace.create([-1.0, -2.0], [1.0, 2.0]),
                "a": {"y": DiscreteSpace.range(3), "x": BoxSpace.create([0.0], [5.0])}}

    @staticmethod
    def _obs(t):
        t = t.to(torch.float32)
        return {"b": torch.stack([t, -t], -1), "a": {"y": t % 3, "x": t[:, None] * 0.5}}

    def reset(self, num_envs, generator, device):
        t = torch.arange(num_envs, dtype=torch.int32, device=device)
        return StepCountState(t=t), self._obs(t)

    def step(self, state, action):
        t = state.t + 1
        return StepCountState(t=t), ActionResult(
            observation=self._obs(t), reward=torch.zeros(t.shape), terminated=t > 99,
            truncated=torch.zeros_like(t, dtype=torch.bool))


class _JaxDictObsEnv(jax_envs.CartPole):
    """The same env, one instance, for the JAX wrappers."""

    @property
    def observation_space(self):
        return {"b": JaxBox.create(jnp.array([-1.0, -2.0]), jnp.array([1.0, 2.0])),
                "a": {"y": JaxDiscrete.range(3), "x": JaxBox.create(jnp.zeros(1), 5 * jnp.ones(1))}}

    @staticmethod
    def _dict_obs(t):
        t = t.astype(jnp.float32)
        return {"b": jnp.stack([t, -t]), "a": {"y": t % 3, "x": t[None] * 0.5}}

    def reset(self, key):
        return jax_misc._ScalarState(t=jnp.zeros((), jnp.int32)), self._dict_obs(jnp.zeros(()))

    def step(self, state, action, key):
        t = state.t + 1
        return jax_misc._ScalarState(t=t), JaxResult(
            observation=self._dict_obs(t), reward=jnp.zeros(()), terminated=t > 99,
            truncated=jnp.zeros((), bool))


def test_flatten_dict_observations_matches_jax_order_and_bounds():
    env, jenv = FlattenDictObservations(_DictObsEnv()), jax_wrappers.FlattenDictObservations(
        _JaxDictObsEnv())
    space, jspace = env.observation_space, jenv.observation_space
    # Sorted keys, recursively: a.x, a.y, b; Discrete(3) gives [0, 2].
    np.testing.assert_array_equal(space.low.numpy(), np.asarray(jspace.low))
    np.testing.assert_array_equal(space.high.numpy(), np.asarray(jspace.high))
    np.testing.assert_array_equal(space.low.numpy(), [0.0, 0.0, -1.0, -2.0])
    np.testing.assert_array_equal(space.high.numpy(), [5.0, 2.0, 1.0, 2.0])
    state, obs = env.reset(6, make_generator(0, "cpu"), "cpu")
    jstate = jax_misc._ScalarState(t=jnp.arange(6, dtype=jnp.int32))
    _, jres = _vmap_step(jenv, jstate, np.zeros((6, 1), np.float32), _keys(6))
    _, res = env.step(state, torch.zeros((6, 1)))
    np.testing.assert_array_equal(res.observation.numpy(), np.asarray(jres.observation))
    assert obs.shape == (6, 4) and obs[4].tolist() == [2.0, 1.0, 4.0, -4.0]
    # Flattening a tuple keeps its order, as a JAX pytree does.
    flat = FlattenObservations._flatten((torch.ones(2, 3), {"z": torch.zeros(2), "a": torch.ones(2)}))
    assert flat.tolist() == [[1.0, 1.0, 1.0, 1.0, 0.0]] * 2
    with pytest.raises(ValueError, match="needs flat_dim"):
        FlattenDictObservations(CartPole()).observation_space
    with pytest.raises(ValueError, match="needs flat_dim"):
        jax_wrappers.FlattenDictObservations(jax_envs.CartPole()).observation_space
    assert FlattenObservations(CartPole(), flat_dim=3).observation_space.dim == 3
    assert FlattenDictObservations(CartPole(), flat_dim=7).observation_dim == 7


def test_one_hot_observations_from_discrete_matches_jax():
    env = OneHotObservationsFromDiscrete(FrozenLake(one_hot_obs=False, slippery=False))
    jenv = jax_wrappers.OneHotObservationsFromDiscrete(
        jax_envs.FrozenLake(one_hot_obs=False, slippery=False))
    assert env._n == jenv._n == 16 and env.observation_dim == 16
    pos = np.random.default_rng(3).integers(0, 16, B).astype(np.int32)
    t = np.zeros(B, np.int32)
    actions = np.random.default_rng(4).integers(0, 4, (B, 1)).astype(np.float32)
    _, jres = _vmap_step(jenv, jax_envs.frozen_lake.FrozenLakeState(
        pos=jnp.asarray(pos), t=jnp.asarray(t)), actions, _keys(B))
    _, res = env.step(FrozenLakeState(pos=torch.from_numpy(pos), t=torch.from_numpy(t)),
                      torch.from_numpy(actions))
    np.testing.assert_array_equal(res.observation.numpy(), np.asarray(jres.observation))
    _, obs = env.reset(3, make_generator(0, "cpu"), "cpu")
    assert obs.shape == (3, 16) and (obs[:, 0] == 1).all() and obs.sum() == 3
    # Values at the edges: a negative one counts from the end; past it, none.
    edges = np.array([[-1.0], [-16.0], [-17.0], [15.0], [16.0], [3.7]], np.float32)
    np.testing.assert_array_equal(env._one_hot(torch.from_numpy(edges)).numpy(),
                                  np.asarray(jax.vmap(jenv._one_hot)(jnp.asarray(edges))))
    assert OneHotObservationsFromDiscrete(CartPole(), num_values=5).observation_dim == 5
    for wrapped in (OneHotObservationsFromDiscrete(CartPole()),
                    jax_wrappers.OneHotObservationsFromDiscrete(jax_envs.CartPole())):
        with pytest.raises(ValueError, match="needs `num_values`"):
            wrapped.observation_space


# -------------------------------------------------------------- recommender
def _jax_recsys():
    return jax_recsys.RecommenderEnvironment.create(
        jax.random.PRNGKey(7), num_items=50, item_dim=8, slate_size=2)


def test_recommender_step_matches_jax_with_its_draws():
    jenv = _jax_recsys()
    env = recommender_env_from_jax(jenv, "cpu")
    rng = np.random.default_rng(5)
    history = rng.normal(size=(B, jenv.history_length, jenv.item_dim)).astype(np.float32)
    slate = np.zeros((B, jenv.num_items), bool)
    t = rng.integers(0, 20, B).astype(np.int32)
    t[:3] = 19  # the episode ends
    items = rng.integers(0, jenv.num_items, B)
    actions = np.asarray(jenv.items)[items]
    keys = _keys(B)
    jstate = jax_recsys.RecSysState(history=jnp.asarray(history), slate_mask=jnp.asarray(slate),
                                    last_click=jnp.zeros(B), t=jnp.asarray(t))
    jnew, jres = _vmap_step(jenv, jstate, actions, keys)

    def draws(key):
        k_click, k_slate = jax.random.split(key)
        return jax.random.uniform(k_click, ()), jenv._slate(k_slate)

    click_u, jslate = (np.array(x) for x in jax.vmap(draws)(keys))
    state = RecSysState(history=torch.from_numpy(history), slate_mask=torch.from_numpy(slate),
                        last_click=torch.zeros(B), t=torch.from_numpy(t))
    new, res = env._transition(state, torch.from_numpy(actions), torch.from_numpy(click_u),
                               torch.from_numpy(jslate))
    p = env.click_probability(torch.from_numpy(history), torch.from_numpy(actions))
    jp = jax.vmap(jenv.click_probability)(jnp.asarray(history), jnp.asarray(actions))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(new.history.numpy(), np.asarray(jnew.history))
    np.testing.assert_array_equal(new.history[:, -1].numpy(), actions)
    for name in ("last_click", "t", "slate_mask"):
        np.testing.assert_array_equal(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)))
    for name in ("observation", "reward", "terminated", "truncated", "available_actions_mask"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(jres, name)))
    assert 0 < res.reward.sum() < B and res.terminated[:3].all()
    assert env.action_space.n == 50 and env.action_space.action_dim == 8
    assert env.max_episode_steps == 20


def test_recommender_slates_hold_slate_size_items_uniformly():
    """Top-k of uniform noise: every slate holds exactly `slate_size`
    distinct items; Pearson's chi-square of the 50 items' frequencies over
    20000 slates of 3 (49 degrees of freedom) below 85.35, its 0.001
    critical value."""
    env = dataclasses.replace(recommender_env_from_jax(_jax_recsys(), "cpu"), slate_size=3)
    gen = make_generator(0, "cpu")
    state, obs = env.reset(20_000, gen, "cpu")
    assert obs.shape == (20_000, 1) and (state.slate_mask.sum(-1) == 3).all()
    _, res = env.step(state, env.items[:1].expand(20_000, -1))
    mask = res.available_actions_mask
    assert mask.dtype == torch.bool and (mask.sum(-1) == 3).all()
    counts = mask.sum(0).numpy().astype(np.float64)
    expected = 20_000 * 3 / 50
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 85.35, chi2


def test_committed_recommender_catalog_is_the_references():
    """chip_smoke.py runs the recommender anchor on this file (it has no
    JAX): the arrays and fields of tests/test_recsys.py's env, exactly."""
    import tests.torch_port_convergence as conv

    jenv = _jax_recsys()
    with np.load(conv.RECSYS_CATALOG) as catalog:
        for name in ("items", "w1", "b1", "w2"):
            np.testing.assert_array_equal(catalog[name], np.asarray(getattr(jenv, name)))
        for name in ("slate_size", "episode_length", "history_length", "logit_scale"):
            assert catalog[name] == getattr(jenv, name), name
        env = recommender_env_from_jax(SimpleNamespace(**catalog), "cpu")
    assert env.num_items == 50 and env.item_dim == 8 and env.slate_size == 2


def test_recommender_create_draws_its_own_catalog():
    env = port_envs.RecommenderEnvironment.create(make_generator(7, "cpu"), num_items=20,
                                                  item_dim=4, hidden=8)
    assert env.items.shape == (20, 4) and env.w1.shape == (8, 8) and env.w2.shape == (8,)
    assert (env.b1 == 0).all() and abs(env.w1.std().item() - 1 / np.sqrt(8)) < 0.15


# ---------------------------------------------------------------- exports
def test_port_exports_every_on_device_env_and_wrapper_of_the_jax_package():
    """Every name of pearl_tpu.envs."""
    missing = set(jax_envs.__all__) - set(port_envs.__all__)
    assert not missing, missing
    for name in jax_envs.__all__:
        assert hasattr(port_envs, name), name


# ---------------------------------------------------- the slice, tiny
def test_recommender_dqn_and_bandit_qrdqn_drive_online_learning_at_a_tiny_size():
    env = recommender_env_from_jax(_jax_recsys(), "cpu")
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=1, batch_size=32, exploration=EGreedyExploration(epsilon=0.3),
            action_representation=IdentityActionRepresentation()),
        replay_buffer=BasicReplayBuffer(capacity=1024),
        track_available_masks=True,
    )
    res = online_learning(agent, env, num_envs=8, max_steps=8 * 40, learn_every_k_steps=4,
                          learning_starts=64, seed=3, device="cpu")
    replay = res.agent_state.replay
    chosen = replay.storage.curr_available_mask[:replay.size].gather(
        1, replay.storage.action_index[:replay.size].long()[:, None])
    assert chosen.all() and len(res.episode_returns) == 16
    assert (res.episode_returns >= 0).all() and (res.episode_returns <= 20).all()
    bandit = PearlAgent(
        policy_learner=QuantileRegressionDeepQLearning(
            training_rounds=1, batch_size=16, exploration=EGreedyExploration(epsilon=0.3),
            discount_factor=0.0),
        replay_buffer=BasicReplayBuffer(capacity=256), safety_module=RiskNeutralSafetyModule(),
    )
    res = online_learning(bandit, MeanVarBanditEnvironment(), num_envs=8, max_steps=8 * 20,
                          learn_every_k_steps=2, learning_starts=32, seed=0, device="cpu")
    assert len(res.episode_returns) == 160


@pytest.mark.cuda
def test_misc_resets_and_steps_make_no_host_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = make_generator(0, "cuda")
    recsys = port_envs.RecommenderEnvironment.create(make_generator(7, "cuda"))
    for env in (MeanVarBanditEnvironment(), FixedNumberOfStepsEnvironment(),
                OneHotObservationsFromDiscrete(FrozenLake(one_hot_obs=False)), recsys):
        action = (recsys.items[:1].expand(1024, -1) if env is recsys
                  else torch.zeros((1024, 1), device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = env.reset(1024, gen, "cuda")
            env.step(state, action)
        finally:
            torch.cuda.set_sync_debug_mode(0)
