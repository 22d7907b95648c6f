"""Reward-constrained (RCPO) safety on the port: SAC on Pendulum with a
torque-cost constraint (the twin of examples/rc_safety_pendulum.py).

`Pendulum(emit_torque_cost=True)` emits cost = mean(action^2), the RC safety
module learns a twin cost-critic and a Lagrange multiplier lambda, and the
actor-critic learner sees reward - lambda * cost. Tightening
`constraint_value` trades return for lower average torque.

Run from the repository's root: python -m examples_torch.rc_safety_pendulum
"""

import argparse

import numpy as np

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import Pendulum
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    ContinuousSoftActorCritic,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.safety_modules import RCSafetyModuleCostCriticContinuousAction
from pearl_tpu_torch.training import online_learning


def run(constraint_value, device=None):
    agent = PearlAgent(
        policy_learner=ContinuousSoftActorCritic(
            training_rounds=2, batch_size=100, entropy_coef=0.1,
            actor_learning_rate=1e-3, critic_learning_rate=1e-3,
        ),
        replay_buffer=BasicReplayBuffer(capacity=100_000),
        safety_module=RCSafetyModuleCostCriticContinuousAction(
            constraint_value=constraint_value, batch_size=100
        ),
        store_cost=True,
    )
    res = online_learning(
        agent, Pendulum(emit_torque_cost=True), num_envs=16, max_steps=60_000,
        learn_every_k_steps=1, learning_starts=1_000, seed=0, device=device,
    )
    n = max(len(res.episode_returns) // 10, 20)
    ret = np.asarray(res.episode_returns)[-n:].mean()
    cost = np.asarray(res.episode_costs)[-n:].mean()
    lam = res.agent_state.safety.lagrangian.item()  # a 0-dim device tensor
    print(
        f"constraint={constraint_value:.2f}: return {ret:8.1f}  "
        f"episode cost {cost:7.2f}  lambda {lam:.3f}"
    )
    return res


def main(device=None):
    # Loose vs tight torque budget: the tight run should spend less torque.
    return [run(constraint_value, device) for constraint_value in (0.5, 0.05)]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
