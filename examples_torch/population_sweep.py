"""A 4-seed DQN sweep trained together on one card, on the port
(training/population.py; the twin of examples/population_sweep.py).

The reference runs this exact protocol — num_runs=4 seeds per method — as
four OS processes. Here the four members advance in lockstep in one process
on one card: each keeps its own envs, replay ring and learner, and each
chunk steps every member before the next chunk. `pop.member_state(i)` is
member i's state.

Run from the repository's root: python -m examples_torch.population_sweep
"""

import argparse

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import population_learning


def main(device=None):
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=2,
            batch_size=128,
            exploration=EGreedyExploration(
                start_epsilon=0.5, end_epsilon=0.05, warmup_steps=20_000
            ),
        ),
        replay_buffer=BasicReplayBuffer(capacity=49_984),
    )
    pop = population_learning(
        agent,
        CartPole(),
        num_members=4,
        seeds=[42, 43, 44, 45],  # the reference's num_runs=4 protocol
        num_envs=32,
        max_steps=150_000,
        learn_every_k_steps=4,
        learning_starts=2_000,
        # target_return=475.0 would stop when EVERY member's recent-episode
        # statistic is at target at once; that statistic (the mean over all
        # 32 envs' most recent episode) is stricter than a last-20-episode
        # window, so a fixed budget with per-seed reporting is the fairer
        # sweep protocol.
        verbose=True,
        device=device,
    )
    print(f"\nsteps/member: {pop.total_steps}")
    for m in range(pop.num_members):
        print(
            f"  seed {42 + m}: episodes={int(pop.total_episodes[m])} "
            f"recent_return={pop.recent_returns[m]:.1f}"
        )
    best = int(pop.recent_returns.argmax())
    print(f"best member: seed {42 + best} (its state: pop.member_state({best}))")
    return pop


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
