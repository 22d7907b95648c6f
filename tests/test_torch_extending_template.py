"""Executable guard for `pearl_tpu_torch/EXTENDING.md` (the port's
counterpart of `tests/test_extending_template.py`): the document's two code
blocks, executed as written, give a `ClippedRewardDQN` subclass of the
port's `DeepQLearning` and its `Method` row. The row passes the row logic of
the registry, learning-signal and compare suites, and its `learn_batch`
learns as the JAX package's `ClippedRewardDQN` does over three steps. As in
the reference, the example is not enrolled in `METHODS`; the suites cover a
row once it is, since they parametrize over the registry."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_extending_template as jax_template
import test_torch_compare_matrix as compare_suite
import test_torch_learning_signal as signal_suite
import test_torch_registry as registry_suite
from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.benchmarks.configs import METHODS
from pearl_tpu_torch.benchmarks.guarantees import frozen_target_signal
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import TransitionBatch
from pearl_tpu_torch.utils.jax_params import load_flax_q_params

torch.set_num_threads(1)

# float32 products summed in other orders, through three Adam steps.
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.cache
def _example():
    """(ClippedRewardDQN, its Method row), built from the document's code
    blocks as written (as phase 47 of chip_smoke.py builds them)."""
    row = chip_smoke.extending_example()
    assert row.name == "ClippedDQN", row.name
    return type(row.make_agent(4).policy_learner), row


def test_example_subclasses_dqn_and_stays_out_of_the_registry():
    cls, row = _example()
    assert issubclass(cls, DeepQLearning) and cls is not DeepQLearning
    assert cls.__name__ == "ClippedRewardDQN" and cls().clip == 1.0
    assert row.name not in METHODS


def test_example_row_trains_and_roundtrips(tmp_path):
    _, row = _example()
    registry_suite.check_trains_and_roundtrips(row.name, row, tmp_path)


def test_example_row_shows_a_learning_signal():
    _, row = _example()
    report = frozen_target_signal(row.name, row, device="cpu")
    assert report.metric == "loss" and not report.failures(), (report, report.failures())


def test_example_row_compare_names_every_changed_leaf():
    _, row = _example()
    compare_suite.check_single_divergent_leaf(row.name, row)
    compare_suite.check_every_state_group(row.name, row)


def _batch(step, B=64):
    """A CartPole-shaped batch whose rewards reach past the clip of 1."""
    rng = np.random.default_rng(step)
    idx = rng.integers(0, 2, B).astype(np.int32)
    return dict(
        state=rng.standard_normal((B, 4)).astype(np.float32) * 0.5,
        action=idx[:, None].astype(np.float32),
        reward=(3.0 * rng.standard_normal(B)).astype(np.float32),
        next_state=rng.standard_normal((B, 4)).astype(np.float32) * 0.5,
        terminated=rng.random(B) < 0.25,
        truncated=rng.random(B) < 0.05,
        action_index=idx,
    )


def test_learn_batch_matches_the_jax_example_over_three_steps():
    cls, _ = _example()
    kw = dict(training_rounds=1, batch_size=64, target_update_freq=2, clip=1.0)
    jl = jax_template.ClippedRewardDQN(**kw).bind(JaxCartPole().action_space)
    tl = cls(**kw).bind(CartPole().action_space)
    plain = DeepQLearning(**{k: v for k, v in kw.items() if k != "clip"}).bind(
        CartPole().action_space)
    jstate = jl.init(jax.random.PRNGKey(0), 4, jl.action_space, 1)
    jax_learn = jax.jit(jl.learn_batch)  # eager flax dispatches op by op
    weights = jax.tree.map(np.asarray, jstate.params)
    states = []
    for learner in (tl, plain):
        state = learner.init(torch.Generator().manual_seed(0), 4, learner.action_space, 1,
                             torch.device("cpu"))
        load_flax_q_params(state.params, weights)
        load_flax_q_params(state.target_params, weights)
        states.append(state)
    tstate, pstate = states
    for step in range(3):
        data = _batch(step)
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
        tbatch = TransitionBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
        jstate, jaux = jax_learn(jstate, jbatch)
        tstate, taux = tl.learn_batch(tstate, tbatch)
        pstate, paux = plain.learn_batch(pstate, tbatch)
        np.testing.assert_allclose(taux["loss"].item(), float(jaux["loss"]), **TOL)
        np.testing.assert_allclose(taux["per_sample_td"].numpy(),
                                   np.asarray(jaux["per_sample_td"]), **TOL)
        # Unclipped, the targets and so the |TD| differ: the override bites.
        assert abs(paux["loss"].item() - taux["loss"].item()) > 0.1, step
        for layer, leaves in jax.tree.map(np.asarray, jstate.params["MLP_0"]).items():
            linear = getattr(tstate.params.MLP_0, layer)
            np.testing.assert_allclose(linear.weight.detach().numpy().T, leaves["kernel"], **TOL)
            np.testing.assert_allclose(linear.bias.detach().numpy(), leaves["bias"], **TOL)
    assert tstate.step == int(jstate.step) == 3


@pytest.mark.parametrize("test", [
    registry_suite.test_method_trains_and_roundtrips,
    signal_suite.test_method_loss_improves_on_frozen_targets,
    compare_suite.test_agent_state_compare_detects_single_divergent_leaf,
    compare_suite.test_compare_matrix_every_state_group,
], ids=lambda t: t.__name__)
def test_row_suites_parametrize_over_the_whole_registry(test):
    """Enrollment is coverage: each row test runs once for every row of
    `METHODS` (a hand-kept list would leave a new row untested)."""
    (mark,) = [m for m in test.pytestmark if m.name == "parametrize"]
    assert mark.args[0] == "name" and sorted(mark.args[1]) == sorted(METHODS), test.__name__
