"""Offline-data collection (port of `pearl_tpu/training/collect.py`).

Rolls out an agent without learning and returns its transitions as one
columnar `TransitionBatch` (optionally saved as `.npz`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.agent.pearl_agent import PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.training.offline import save_offline_data
from pearl_tpu_torch.training.online import online_learning
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import tree_map


def collect_offline_data(
    agent: PearlAgent,
    env,
    *,
    num_transitions: int,
    num_envs: int = 16,
    seed: int = 0,
    learner_state=None,
    exploit: bool = False,
    save_path: Optional[str] = None,
    device: DeviceLike = None,
) -> TransitionBatch:
    """Run the agent's learner without learning on `device` (the card unless
    "cpu") into a `BasicReplayBuffer(num_transitions)` and return what it
    holds, `storage[:size]`. The driver runs whole chunks of 8 steps, so the
    ring may wrap over its first slots: the rows are then not in time order,
    exactly as in the reference. A trained `learner_state` is used with a
    fresh exploration state; with `exploit=True` the policy acts greedily."""
    device = resolve_device(device)
    collector = PearlAgent(
        policy_learner=agent.policy_learner,
        replay_buffer=BasicReplayBuffer(capacity=num_transitions),
        safety_module=agent.safety_module,
        track_available_masks=agent.track_available_masks,
        store_cost=agent.store_cost,
    ).for_env(env)
    astate = None
    if learner_state is not None:
        venv = VectorEnv(env, num_envs, device)
        _, obs = venv.reset(make_generator(seed + 1, device))
        astate = collector.init(seed + 1, venv.observation_dim, num_envs, obs, device=device)
        learner = collector.policy_learner
        fresh_explore = learner.init(
            torch.Generator().manual_seed(seed + 1), venv.observation_dim,
            learner.action_space, num_envs, device,
        ).explore_state
        astate = dataclasses.replace(
            astate, learner=dataclasses.replace(learner_state, explore_state=fresh_explore)
        )
    res = online_learning(
        collector,
        env,
        num_envs=num_envs,
        max_steps=num_transitions,
        learn_every_k_steps=8,
        learn=False,
        exploit=exploit,
        seed=seed,
        agent_state=astate,
        device=device,
    )
    replay = res.agent_state.replay
    n = replay.size
    batch = tree_map(lambda x: x[:n], replay.storage)
    if save_path:
        save_offline_data(save_path, batch)
    return batch
