"""Single-item recommender system with a dynamic action space, on the port
(the twin of examples/recommender_system.py).

Each step the agent picks one of two candidate items (synthetic
embeddings), a frozen user model emits a Bernoulli click, and the agent
only observes the click — the item/action history carries the state,
recovered by the LSTM history-summarization module. Demonstrates:

- dynamic action spaces as per-step availability masks over a fixed catalog,
- embedding-valued actions with IdentityActionRepresentation,
- LSTM history summarization,
- BootstrappedDQN + deep exploration as the tutorial's second agent.

The catalog is drawn on the CPU from seed 7, so it is the same on every
device.

Run from the repository's root: python -m examples_torch.recommender_system
"""

import argparse

import numpy as np
import torch

from pearl_tpu_torch.action_representation_modules import IdentityActionRepresentation
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import RecommenderEnvironment
from pearl_tpu_torch.history_summarization_modules import LSTMHistorySummarization
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    BootstrappedDQN,
    DeepQLearning,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, BootstrapReplayBuffer
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    env = RecommenderEnvironment.create(
        torch.Generator().manual_seed(7), num_items=100, item_dim=16, slate_size=2,
        device=device,
    )

    agents = {
        "DQN+LSTM": PearlAgent(
            policy_learner=DeepQLearning(
                training_rounds=2,
                batch_size=128,
                exploration=EGreedyExploration(
                    start_epsilon=0.3, end_epsilon=0.05, warmup_steps=20_000
                ),
                action_representation=IdentityActionRepresentation(),
                history_summarizer=LSTMHistorySummarization(
                    history_length=8, hidden_dim=64, num_layers=1
                ),
            ),
            replay_buffer=BasicReplayBuffer(capacity=50_000),
            track_available_masks=True,
        ),
        "BootstrappedDQN+LSTM": PearlAgent(
            policy_learner=BootstrappedDQN(
                training_rounds=2,
                batch_size=128,
                action_representation=IdentityActionRepresentation(),
                history_summarizer=LSTMHistorySummarization(
                    history_length=8, hidden_dim=64, num_layers=1
                ),
            ),
            replay_buffer=BootstrapReplayBuffer(capacity=50_000, ensemble_size=10),
            track_available_masks=True,
        ),
    }

    results = {}
    for name, agent in agents.items():
        res = results[name] = online_learning(
            agent, env, num_envs=64, max_steps=100_000,
            learn_every_k_steps=4, learning_starts=2_000, seed=0, device=device,
        )
        r = np.asarray(res.episode_returns)
        n = max(len(r) // 10, 20)
        print(
            f"{name}: {len(r)} episodes; "
            f"click-through first {r[:n].mean():.2f} -> last {r[-n:].mean():.2f} "
            f"of {env.episode_length} (random ~{0.47 * env.episode_length:.1f})"
        )
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
