"""Env steps each package needs to reach CartPole 500 with the configuration
of tests/integration/test_convergence.py:48-79 and the multi-head Q-network
(the learning phase of chip_smoke.py). Not collected by pytest; run it:

    python tests/torch_port_convergence.py --package jax --seeds 42
    python tests/torch_port_convergence.py --package torch --seeds 42 0 1 2 3

`--package torch` runs the port on the CPU unless `--device cuda` is given.
Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(
    num_envs=16, max_steps=250_000, learn_every_k_steps=2, learning_starts=500,
    target_return=500.0, target_window=20,
)


def run_jax(seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pearl_tpu.agent import PearlAgent
    from pearl_tpu.envs import CartPole
    from pearl_tpu.neural_networks.q_value_networks import MultiHeadQValueNetwork
    from pearl_tpu.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer
    from pearl_tpu.training import online_learning

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=4, batch_size=128,
            exploration=EGreedyExploration(epsilon=0.05),
        ),
        replay_buffer=BasicReplayBuffer(capacity=10_000),
    )
    return online_learning(agent, CartPole(), seed=seed, **CONFIG)


def run_torch(seed, device):
    import torch

    torch.set_num_threads(2)
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=4, batch_size=128,
            exploration=EGreedyExploration(epsilon=0.05),
        ),
        replay_buffer=BasicReplayBuffer(capacity=10_000),
    )
    return online_learning(agent, CartPole(), seed=seed, device=device, **CONFIG)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("jax", "torch"), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[42])
    parser.add_argument("--device", default="cpu", help="torch device (port only)")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.package == "jax":
            res = run_jax(seed)
        else:
            res = run_torch(seed, args.device)
        print(json.dumps({
            "package": args.package, "seed": seed, "reached_target": bool(res.reached_target),
            "env_steps": int(res.total_steps), "episodes": int(len(res.episode_returns)),
            "seconds": round(time.perf_counter() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
