"""Offline-RL benchmark pipeline (port of
`pearl_tpu/benchmarks/offline_rl.py`).

(a) Train a behaviour policy online, (b) collect a dataset from it at a
chosen quality (an expert share mixed with a random policy's), (c) train
each offline learner on the dataset and (d) evaluate it greedily, reporting
raw returns and returns normalized between the random and the expert
policy's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.training.collect import collect_offline_data
from pearl_tpu_torch.training.offline import (
    buffer_from_batch,
    offline_evaluation,
    offline_learning,
    save_offline_data,
)
from pearl_tpu_torch.training.online import online_learning
from pearl_tpu_torch.utils.device import DeviceLike, resolve_device
from pearl_tpu_torch.utils.metrics import normalized_score
from pearl_tpu_torch.utils.pytree import tree_map


def mix_datasets(
    parts: Sequence[TransitionBatch], fractions: Sequence[float], total: int,
) -> TransitionBatch:
    """The first round(f * total) rows of each part, concatenated in order
    (the last part takes what is left of `total`): the reference's
    data-quality knob, e.g. half random and half expert for "medium"."""
    assert len(parts) == len(fractions)
    takes = [int(round(f * total)) for f in fractions]
    takes[-1] = total - sum(takes[:-1])
    sliced = [tree_map(lambda x, n=n: x[:n], p) for p, n in zip(parts, takes)]
    fields = {}
    for f in dataclasses.fields(TransitionBatch):
        xs = [getattr(p, f.name) for p in sliced if getattr(p, f.name) is not None]
        fields[f.name] = torch.cat(xs) if xs else None
    return TransitionBatch(**fields)


@dataclasses.dataclass
class OfflineRLResult:
    raw_return: float
    normalized: float  # 0 = random anchor, 100 = expert anchor
    returns: np.ndarray


def run_offline_rl_benchmark(
    env_factory: Callable,
    behavior_agent_factory: Callable[[], PearlAgent],
    offline_agent_factories: Dict[str, Callable[[], PearlAgent]],
    *,
    behavior_steps: int = 100_000,
    dataset_size: int = 50_000,
    expert_fraction: float = 1.0,
    offline_batches: int = 2_000,
    offline_batch_size: int = 128,
    num_envs: int = 16,
    eval_steps: int = 10_000,
    seed: int = 0,
    save_dataset_path: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, OfflineRLResult]:
    """The whole pipeline on `device` (the card unless "cpu"). Returns a
    result per offline learner and the "__anchors__" entry with the measured
    random and expert returns."""
    device = resolve_device(device)
    env = env_factory()

    # (a) The behaviour policy, trained online.
    behavior = behavior_agent_factory()
    res = online_learning(
        behavior, env, num_envs=num_envs, max_steps=behavior_steps,
        learn_every_k_steps=4, learning_starts=min(2_000, behavior_steps // 4),
        seed=seed, device=device,
    )
    expert_state = res.agent_state.learner

    # The anchors: an untrained greedy agent and the trained behaviour agent.
    rand_returns = offline_evaluation(
        behavior_agent_factory().for_env(env), None, env,
        num_envs=num_envs, max_steps=eval_steps, seed=seed + 10, device=device,
    )
    expert_returns = offline_evaluation(
        behavior, res.agent_state, env,
        num_envs=num_envs, max_steps=eval_steps, seed=seed + 11, device=device,
    )
    random_score = float(np.mean(rand_returns)) if len(rand_returns) else 0.0
    expert_score = float(np.mean(expert_returns)) if len(expert_returns) else 0.0

    # (b) The dataset: an expert slice and a random slice, mixed.
    n_expert = int(round(expert_fraction * dataset_size))
    parts, fracs = [], []
    if n_expert:
        parts.append(
            collect_offline_data(
                behavior, env, num_transitions=n_expert, num_envs=num_envs,
                seed=seed + 1, learner_state=expert_state, device=device,
            )
        )
        fracs.append(expert_fraction)
    if dataset_size - n_expert:
        parts.append(
            collect_offline_data(
                behavior_agent_factory(), env, num_transitions=dataset_size - n_expert,
                num_envs=num_envs, seed=seed + 2, device=device,
            )
        )
        fracs.append(1.0 - expert_fraction)
    dataset = mix_datasets(parts, fracs, dataset_size)
    if save_dataset_path:
        save_offline_data(save_dataset_path, dataset)
    buffer, buf_state = buffer_from_batch(dataset)

    # (c) + (d) Each offline learner trained on the dataset, then evaluated.
    results: Dict[str, OfflineRLResult] = {}
    for name, factory in offline_agent_factories.items():
        agent = factory().for_env(env)
        obs0 = torch.zeros((num_envs, env.observation_dim), device=device)
        astate = agent.init(seed + 100, env.observation_dim, num_envs, obs0, device=device)
        astate = offline_learning(
            agent, astate, buffer, buf_state,
            number_of_batches=offline_batches, batch_size=offline_batch_size, seed=seed + 200,
        )
        returns = offline_evaluation(
            agent, astate, env, num_envs=num_envs, max_steps=eval_steps, seed=seed + 300,
            device=device,
        )
        raw = float(np.mean(returns)) if len(returns) else random_score
        results[name] = OfflineRLResult(
            raw_return=raw,
            normalized=normalized_score(raw, random_score, expert_score),
            returns=np.asarray(returns),
        )

    results["__anchors__"] = OfflineRLResult(
        raw_return=expert_score, normalized=100.0, returns=np.array([random_score, expert_score]),
    )
    return results
