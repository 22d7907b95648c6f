"""Contextual bandits on the port: LinUCB / LinTS / Neural LinUCB on a
synthetic linear env with regret tracking (the twin of
examples/contextual_bandit_linucb.py).

Run from the repository's root: python -m examples_torch.contextual_bandit_linucb
"""

import argparse

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.benchmarks.cb import run_bandit_benchmark
from pearl_tpu_torch.envs import LinearSyntheticBanditEnvironment
from pearl_tpu_torch.policy_learners.contextual_bandits import (
    LinearBandit,
    NeuralLinearBandit,
)
from pearl_tpu_torch.policy_learners.exploration_modules.contextual_bandits import (
    ThompsonSamplingExplorationLinear,
    UCBExploration,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer


def main(device=None):
    env = LinearSyntheticBanditEnvironment(seed=0)
    methods = {
        "LinUCB": LinearBandit(exploration=UCBExploration(alpha=1.0)),
        "LinTS": LinearBandit(exploration=ThompsonSamplingExplorationLinear()),
        "NeuralLinUCB": NeuralLinearBandit(exploration=UCBExploration(alpha=1.0)),
    }
    results = {}
    for name, learner in methods.items():
        agent = PearlAgent(
            policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=16)
        )
        out = results[name] = run_bandit_benchmark(
            agent, env, num_envs=16, steps=2_000, seed=0, device=device
        )
        print(
            f"{name:14s} cumulative regret: {out['cumulative_regret'][-1]:8.1f}  "
            f"(final per-step regret {out['regret'][-100:].mean():.4f})"
        )
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
