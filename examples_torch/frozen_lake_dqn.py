"""FrozenLake tutorial on the port: DQN with one-hot observations on the 4x4
lake (the twin of examples/frozen_lake_dqn.py).

Discrete cell observations are one-hot encoded (built into the env; the
OneHotObservationsFromDiscrete wrapper does the same for any discrete-obs
env) and a plain DQN learns to reach the goal (return 1.0; the reference's
integration anchor is five consecutive 1.0 episodes).

Run from the repository's root: python -m examples_torch.frozen_lake_dqn
"""

import argparse

import numpy as np

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import FrozenLake
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import online_learning


def main(device=None):
    env = FrozenLake(one_hot_obs=True, slippery=False)
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=2,
            batch_size=64,
            exploration=EGreedyExploration(
                start_epsilon=0.5, end_epsilon=0.05, warmup_steps=10_000
            ),
        ),
        replay_buffer=BasicReplayBuffer(capacity=10_000),
    )
    res = online_learning(
        agent, env, num_envs=32, max_steps=60_000,
        learn_every_k_steps=4, learning_starts=1_000, seed=0, device=device,
    )
    r = np.asarray(res.episode_returns)
    n = max(len(r) // 10, 20)
    print(
        f"{len(r)} episodes; success rate first {r[:n].mean():.2f} -> "
        f"last {r[-n:].mean():.2f} (reference anchor: 1.0)"
    )
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
