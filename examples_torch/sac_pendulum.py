"""Continuous control: Soft Actor-Critic on Pendulum, on the port (the twin
of examples/sac_pendulum.py).

Run from the repository's root: python -m examples_torch.sac_pendulum
"""

import argparse

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import Pendulum
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    ContinuousSoftActorCritic,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import online_learning


def main(device=None):
    agent = PearlAgent(
        policy_learner=ContinuousSoftActorCritic(training_rounds=1, batch_size=256),
        replay_buffer=BasicReplayBuffer(capacity=100_000),
    )
    result = online_learning(
        agent,
        Pendulum(),
        num_envs=16,
        max_steps=300_000,
        learn_every_k_steps=1,
        learning_starts=1_000,
        seed=0,
        target_return=-250.0,
        verbose=True,
        device=device,
    )
    print(
        f"reached={result.reached_target} "
        f"last-20 mean return={result.episode_returns[-20:].mean():.1f}"
    )
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
