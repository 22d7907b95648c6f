"""Data-parallel DQN over every rank of the world, through the production
driver, on the port (the twin of examples/multi_chip_dqn.py):
`online_learning(mesh=...)` with device-side episode accounting and early
stopping live, the learner replicated by a gradient all-reduce in every
learn.

One process per card. Under torchrun each process joins the world and
takes the card of its LOCAL_RANK; started alone, the script makes a world
of one in-process (and tears it down at the end). The replicas are checked
after the first learning dispatch (`check_replication=True`) and again at
the end, against rank 0's broadcast parameters (`replica_spread`).

Run from the repository's root:
    torchrun --nproc_per_node=N -m examples_torch.multi_chip_dqn
    python -m examples_torch.multi_chip_dqn   (one card)
"""

import argparse

import torch.distributed as dist

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.parallel import make_mesh, multihost, replica_spread
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import online_learning


def main(device=None, backend=None):
    joined = not dist.is_initialized()
    if joined:
        multihost.initialize(backend=backend)  # torchrun's world; a no-op alone
    try:
        with make_mesh(device=device, backend=backend) as mesh:
            return run(mesh)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()  # the world this script joined


def run(mesh):
    n = mesh.size
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=2,  # learn ratio ~2 samples/env-step, the
            batch_size=512,     # known-good CartPole recipe scaled to 128 envs
            exploration=EGreedyExploration(
                start_epsilon=0.5, end_epsilon=0.05, warmup_steps=20_000
            ),
        ),
        replay_buffer=BasicReplayBuffer(capacity=65_536),
    )
    res = online_learning(
        agent,
        CartPole(),
        mesh=mesh,
        num_envs=64 * n,  # global env count, split across ranks
        max_steps=400_000 * n,
        learn_every_k_steps=4,
        learning_starts=2_048 * n,
        stats="summary",
        target_return=450.0,
        seed=7,
        verbose=True,
        check_replication=True,
    )
    spread = replica_spread(res.agent_state.learner.params, mesh.axis("data"))
    if mesh.axis("data").rank == 0:
        print(
            f"devices={n} reached_target={res.reached_target} "
            f"steps={res.total_steps} episodes={res.total_episodes} "
            f"replica_spread={spread}"
        )
    return res, spread


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda:LOCAL_RANK (the default) or cpu")
    p.add_argument("--backend", default=None, help="nccl on cards, gloo on the CPU")
    main(**vars(p.parse_args()))
