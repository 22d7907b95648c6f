"""The learning signal of every registry row on the port
(`tests/test_learning_signal_matrix.py` on the JAX package): the replay
filled with real rollouts at 4 envs, every stored transition marked
terminated, then the learner's own `learn` 60 times (90 for visual rows) on
that data. The row's primary loss must start above 1e-3 and fall under the
reference's ratio of its start (0.15; 0.30 for CNNDQN and CQL), and a |TD|
metric must end under 0.5. A loss wired to zero, a gradient that does not
flow or an optimizer that does not step fails. The thresholds are the
reference's, unchanged (`benchmarks/guarantees.py`)."""

import pytest
import torch

from pearl_tpu_torch.benchmarks.configs import METHODS
from pearl_tpu_torch.benchmarks.guarantees import frozen_target_signal

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(METHODS.keys()))
def test_method_loss_improves_on_frozen_targets(name):
    report = frozen_target_signal(name, METHODS[name], device="cpu")
    assert not report.failures(), (report, report.failures())
