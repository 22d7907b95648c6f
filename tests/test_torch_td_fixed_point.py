"""The discount against the analytic Bellman fixed point, on the port
(`tests/test_td_discount_calibration.py` on the JAX package). On a buffer
of one non-terminal self-loop transition (s0, a0, r = 1, s0), repeated 64
times, DQN, Double DQN and deep SARSA with hard target updates reach
Q* = 1 / (1 - gamma) = 10 at gamma 0.9; at gamma 0.45 DQN lands at 1.82,
nowhere near 10. Every row is the same, so sampling cannot tell the two
packages apart: each fitted Q is also held within 0.05 of the JAX package's
own, computed as its test computes it."""

import numpy as np
import pytest
import torch

import test_td_discount_calibration as jax_td
from pearl_tpu.policy_learners.sequential_decision_making import (
    DeepQLearning as JaxDQN,
    DeepSARSA as JaxSARSA,
    DoubleDQN as JaxDoubleDQN,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBasicBuffer
from pearl_tpu.replay_buffers.sarsa import SARSAReplayBuffer as JaxSARSABuffer
from pearl_tpu_torch.benchmarks.guarantees import fixed_point_q
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    DeepQLearning,
    DeepSARSA,
    DoubleDQN,
)

torch.set_num_threads(1)

LEARNERS = {
    "dqn": (DeepQLearning, JaxDQN),
    "double_dqn": (DoubleDQN, JaxDoubleDQN),
    "sarsa": (DeepSARSA, JaxSARSA),
}


def _jax_fitted_q(jax_cls, gamma):
    """`_fitted_q` of the JAX test, with the learner and buffer of its
    cases (:82-92, :107-127)."""
    sarsa = jax_cls is JaxSARSA
    learner = jax_cls(training_rounds=1, batch_size=32, learning_rate=3e-3,
                      discount_factor=gamma, target_update_freq=1, soft_update_tau=1.0)
    buffer = JaxSARSABuffer(capacity=64, num_envs=64) if sarsa else JaxBasicBuffer(capacity=64)
    return jax_td._fitted_q(learner, buffer, gamma, sarsa=sarsa)


@pytest.mark.parametrize("name", list(LEARNERS))
def test_reaches_the_analytic_fixed_point_like_jax(name):
    cls, jax_cls = LEARNERS[name]
    q = fixed_point_q(cls, 0.9, device="cpu")
    assert abs(q - 1.0 / (1.0 - 0.9)) < 0.5, (name, q)
    q_jax = _jax_fitted_q(jax_cls, 0.9)
    assert abs(q - q_jax) < 0.05, (name, q, q_jax)


def test_wrong_discount_is_detected():
    q = fixed_point_q(DeepQLearning, 0.45, device="cpu")
    assert abs(q - 1.0 / (1.0 - 0.45)) < 0.5, q
    assert abs(q - 10.0) > 5.0, q
    np.testing.assert_allclose(q, _jax_fitted_q(JaxDQN, 0.45), atol=0.05)
