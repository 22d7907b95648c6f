"""Quick start: DQN on CartPole, on the port (the twin of
examples/dqn_cartpole.py).

Run from the repository's root: python -m examples_torch.dqn_cartpole
(on the card; --device cpu runs it on the CPU)
"""

import argparse

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import online_learning


def main(device=None):
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=2,
            batch_size=128,
            exploration=EGreedyExploration(
                start_epsilon=0.5, end_epsilon=0.05, warmup_steps=20_000
            ),
        ),
        replay_buffer=BasicReplayBuffer(capacity=50_000),
    )
    result = online_learning(
        agent,
        CartPole(),
        num_envs=32,
        max_steps=150_000,
        learn_every_k_steps=4,
        learning_starts=2_000,
        seed=0,
        target_return=475.0,
        verbose=True,
        device=device,
    )
    print(
        f"reached={result.reached_target} steps={result.total_steps} "
        f"last-20 mean return={result.episode_returns[-20:].mean():.1f}"
    )
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
