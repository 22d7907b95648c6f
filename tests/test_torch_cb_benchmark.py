"""The CB benchmark of the PyTorch port against the JAX package's: the
datasets equal bit for bit (the port keeps its own copy of
`cb_datasets.py`), the UCI parser on the same file, each method row built
alike, the driver's per-step bookkeeping equal on a run with no draws; then
the reference's online and offline protocols on the port at the test's
sizes (tests/test_cb_benchmark.py:47-64), on the CPU.
"""

import numpy as np
import pytest
import torch

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.benchmarks import cb as jax_cb
from pearl_tpu.benchmarks import cb_datasets as jax_datasets
from pearl_tpu.envs.bandit import RewardIsTenTimesActionMABEnvironment as JaxMAB
from pearl_tpu.policy_learners.contextual_bandits import (
    DisjointBanditContainer as JaxContainer,
)
from pearl_tpu.policy_learners.exploration_modules.contextual_bandits import (
    UCBExploration as JaxUCB,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.benchmarks import cb, cb_datasets
from pearl_tpu_torch.envs import RewardIsTenTimesActionMABEnvironment
from pearl_tpu_torch.policy_learners.contextual_bandits import DisjointBanditContainer
from pearl_tpu_torch.policy_learners.exploration_modules import UCBExploration
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

torch.set_num_threads(1)


def test_datasets_equal_jax_bit_for_bit():
    assert cb_datasets.DATASET_SPECS == jax_datasets.DATASET_SPECS
    for name, (n, d, k) in cb_datasets.DATASET_SPECS.items():
        X, y = cb_datasets.synthetic_uci_dataset(name)
        jX, jy = jax_datasets.synthetic_uci_dataset(name)
        np.testing.assert_array_equal(X, jX)
        np.testing.assert_array_equal(y, jy)
        assert X.shape == (n, d) and X.dtype == np.float32 and y.max() == k - 1


def test_uci_parser_round_trip_matches_jax(tmp_path):
    """A tiny letter-format file (first column the alphabetic label) and a
    yeast-format one (whitespace, the name column dropped, the string label
    last, in column 9)."""
    (tmp_path / "letter-recognition.data").write_text("A,1,2,3\nB,4,5,6\nA,7,8,9\n")
    (tmp_path / "yeast.data").write_text(
        "ADT1_YEAST 0.58 0.61 0.47 0.13 0.50 0.00 0.48 0.22 MIT\n"
        "ADT2_YEAST 0.43 0.67 0.48 0.27 0.50 0.00 0.53 0.22 MIT\n"
        "ATP6_YEAST 0.42 0.44 0.48 0.54 0.50 0.00 0.48 0.22 CYT\n")
    X, y = cb_datasets.load_uci_dataset("letter", str(tmp_path))
    jX, jy = jax_datasets.load_uci_dataset("letter", str(tmp_path))
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    # yeast: the port reads the label from the file's last column; the JAX
    # package's rule points at a feature column and fails on the label.
    X, y = cb_datasets.load_uci_dataset("yeast", str(tmp_path))
    assert X.shape == (3, 8)
    np.testing.assert_array_equal(y, [1, 1, 0])
    with pytest.raises(ValueError, match="MIT"):
        jax_datasets.load_uci_dataset("yeast", str(tmp_path))
    X, y = cb_datasets.load_uci_dataset("letter", str(tmp_path))
    assert X.shape == (3, 3)
    np.testing.assert_array_equal(y, [0, 1, 0])
    assert cb_datasets.get_dataset("letter", str(tmp_path))[2] == "uci"
    assert cb_datasets.get_dataset("letter", None)[2] == "synthetic"
    with pytest.raises(KeyError):
        cb_datasets.get_dataset("iris")


@pytest.mark.parametrize("method", cb.CB_METHODS)
def test_each_method_row_is_built_as_in_jax(method):
    agent = cb.cb_benchmark_method(method, feature_dim=16, num_classes=26, T=5000)
    jagent = jax_cb.cb_benchmark_method(method, feature_dim=16, num_classes=26, T=5000)
    learner, jlearner = agent.policy_learner, jagent.policy_learner
    assert type(learner).__name__ == type(jlearner).__name__
    assert type(learner.exploration).__name__ == type(jlearner.exploration).__name__
    for field in ("hidden_dims", "learning_rate", "batch_size", "training_rounds"):
        assert getattr(learner, field) == getattr(jlearner, field), field
    assert learner.action_representation.bits == jlearner.action_representation.bits == 5
    assert getattr(learner.exploration, "gamma", None) == getattr(jlearner.exploration,
                                                                  "gamma", None)
    assert agent.replay_buffer.capacity == jagent.replay_buffer.capacity == 5000
    with pytest.raises(KeyError):
        cb.cb_benchmark_method("LinUCB", 16, 26, 5000)


def test_bandit_driver_matches_jax_on_a_run_without_draws():
    """UCB arms on the ten-times MAB draw nothing, so both drivers take the
    same acts: the per-step rewards and regrets equal, step for step."""
    jagent = JaxAgent(policy_learner=JaxContainer(exploration=JaxUCB(alpha=40.0)),
                      replay_buffer=JaxBuffer(capacity=8))
    agent = PearlAgent(policy_learner=DisjointBanditContainer(exploration=UCBExploration(
        alpha=40.0)), replay_buffer=BasicReplayBuffer(capacity=8))
    jout = jax_cb.run_bandit_benchmark(jagent, JaxMAB(), num_envs=8, steps=64)
    out = cb.run_bandit_benchmark(agent, RewardIsTenTimesActionMABEnvironment(), num_envs=8,
                                  steps=64, device="cpu")
    for name in ("reward", "regret", "cumulative_regret"):
        np.testing.assert_allclose(out[name], np.asarray(jout[name]), rtol=1e-6, err_msg=name)
    assert out["reward"][-1] == 30.0  # arm 3 everywhere by the end


def test_suite_refuses_a_t_that_the_envs_do_not_divide():
    for run in (cb.run_cb_benchmark_suite, jax_cb.run_cb_benchmark_suite):
        with pytest.raises(ValueError, match="multiple of num_envs"):
            run(datasets=("yeast",), T=1001, num_envs=10)


def test_online_suite_learns_the_yeast_cell():
    """tests/test_cb_benchmark.py:47-56 on the port: NeuralSquareCB on yeast,
    T = 1500 over 10 envs, final regret below 0.5 (uniform: 0.9)."""
    res = cb.run_cb_benchmark_suite(datasets=("yeast",), methods=("NeuralSquareCB",), T=1500,
                                    num_envs=10, device="cpu")
    cell = res["yeast"]["NeuralSquareCB"]
    assert cell["final_avg_regret"] < 0.5, cell["final_avg_regret"]
    assert res["yeast"]["_source"] == "synthetic"
    cum = cell["cumulative_regret"]
    assert cum.shape == (150,) and np.all(np.diff(cum) >= -1e-6)


def test_offline_protocol_learns_satimage():
    """tests/test_cb_benchmark.py:60-64 on the port (uniform: 0.83)."""
    out = cb.run_offline_cb_experiment("satimage", T=4000, train_batches=400,
                                       num_eval_steps=100, device="cpu")
    assert out["final_avg_regret"] < 0.4, out["final_avg_regret"]
    assert out["source"] == "synthetic" and out["cumulative_regret"].shape == (100,)

