"""Contextual-bandit benchmark driver (port of `pearl_tpu/benchmarks/cb.py`;
the reference's pearl/utils/scripts/cb_benchmark/run_cb_benchmarks.py:46-332).

`run_bandit_benchmark` runs act -> env step -> observe -> learn over
vectorized bandit envs for `steps` steps, as a Python loop on the device
(the JAX package's `lax.scan`); each step's mean regret and reward stay on
the device, fetched once at the end.

The reference's UCI CB protocol: SquareCB and FastCB over a NeuralBandit,
UCB and Thompson sampling over a NeuralLinearBandit, binary action
embeddings, online regret over T interactions on letter, pendigits,
satimage and yeast (`run_cb_benchmark_suite`); and its offline variant
(`run_offline_cb_experiment`), a greedy NeuralBandit trained on
uniform-logging data and evaluated without training. The datasets are the
synthetic twins of `cb_datasets.py` unless `data_dir` holds the real files.

Every entry point runs on `device` (the card unless `device="cpu"`).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from pearl_tpu_torch.action_representation_modules import BinaryActionRepresentation
from pearl_tpu_torch.agent.pearl_agent import PearlAgent
from pearl_tpu_torch.benchmarks.cb_datasets import get_dataset
from pearl_tpu_torch.envs.bandit import ClassificationBanditEnvironment
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.policy_learners.contextual_bandits import NeuralBandit, NeuralLinearBandit
from pearl_tpu_torch.policy_learners.exploration_modules.contextual_bandits import (
    FastCBExploration,
    SquareCBExploration,
    ThompsonSamplingExplorationLinear,
    UCBExploration,
)
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer
from pearl_tpu_torch.training.offline import (
    buffer_from_batch,
    offline_learning,
    transitions_from_arrays,
)
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device

CB_METHODS = ("NeuralSquareCB", "NeuralFastCB", "NeuralLinUCB", "NeuralLinTS")
CB_DATASETS = ("letter", "pendigits", "satimage", "yeast")


def run_bandit_benchmark(
    agent: PearlAgent,
    env,
    *,
    num_envs: int = 16,
    steps: int = 5_000,
    seed: int = 0,
    learn: bool = True,
    exploit: bool = False,
    agent_state=None,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Per-step mean regret and reward (length `steps`), their cumulative
    regret, and the agent state after the run. A given `agent_state` is used
    as it is, its per-env state included."""
    device = resolve_device(device)
    agent = agent.for_env(env)
    venv = VectorEnv(env, num_envs, device)
    generator = make_generator(seed, device)
    env_states, obs = venv.reset(generator)
    astate = agent_state
    if astate is None:
        astate = agent.init(seed, venv.observation_dim, num_envs, obs, device=device)
    per_step = torch.zeros((2, steps), device=device)  # mean regret, mean reward
    for i in range(steps):
        astate, choice = agent.act(astate, generator, exploit=exploit)
        env_states, result, next_obs = venv.step(env_states, choice.action, generator)
        astate = agent.observe(astate, result, next_obs, generator)
        if learn:
            astate, _ = agent.learn(astate, generator)
        regret = result.info.get("regret", torch.zeros_like(result.reward))
        per_step[:, i] = torch.stack([regret.mean(), result.reward.mean()])
    regrets, rewards = per_step.cpu().numpy()
    return {
        "regret": regrets,
        "reward": rewards,
        "cumulative_regret": np.cumsum(regrets),
        "agent_state": astate,
    }


def _bits(num_classes: int) -> int:
    return max(1, math.ceil(math.log2(max(num_classes, 2))))


def cb_benchmark_method(name: str, feature_dim: int, num_classes: int, T: int) -> PearlAgent:
    """The PearlAgent of one reference CB method row."""
    bits = _bits(num_classes)
    # gamma = 10 * sqrt(T * input_dim) (cb_benchmark_config.py:113-116).
    gamma = 10.0 * math.sqrt(T * (feature_dim + bits))
    common = dict(
        hidden_dims=(64, 16),
        learning_rate=0.01,
        batch_size=128,
        training_rounds=10,
        action_representation=BinaryActionRepresentation(bits=bits),
    )
    if name == "NeuralSquareCB":
        learner = NeuralBandit(exploration=SquareCBExploration(gamma=gamma), **common)
    elif name == "NeuralFastCB":
        learner = NeuralBandit(exploration=FastCBExploration(gamma=gamma), **common)
    elif name == "NeuralLinUCB":
        learner = NeuralLinearBandit(exploration=UCBExploration(alpha=1.0), **common)
    elif name == "NeuralLinTS":
        learner = NeuralLinearBandit(exploration=ThompsonSamplingExplorationLinear(), **common)
    else:
        raise KeyError(name)
    return PearlAgent(policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=T))


def run_cb_benchmark_suite(
    *,
    datasets=CB_DATASETS,
    methods=CB_METHODS,
    T: int = 5_000,
    num_envs: int = 10,
    seed: int = 0,
    data_dir=None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """Online regret over every (dataset, method) pair: T interactions
    spread over `num_envs` vectorized envs."""
    if T % num_envs != 0:
        raise ValueError(
            f"T={T} must be a multiple of num_envs={num_envs} (interactions "
            "are spread evenly over the vectorized env instances)"
        )
    results: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for ds in datasets:
        X, y, source = get_dataset(ds, data_dir)
        env = ClassificationBanditEnvironment(features=X, labels=y)
        k = int(y.max()) + 1
        results[ds] = {"_source": source}
        for m in methods:
            agent = cb_benchmark_method(m, X.shape[1], k, T)
            out = run_bandit_benchmark(agent, env, num_envs=num_envs, steps=T // num_envs,
                                       seed=seed, device=device)
            results[ds][m] = {
                "cumulative_regret": out["cumulative_regret"] * num_envs,
                "final_avg_regret": float(np.mean(out["regret"][-len(out["regret"]) // 5:])),
            }
            if verbose:
                print(
                    f"{ds:10s} {m:14s} source={source} cum_regret="
                    f"{results[ds][m]['cumulative_regret'][-1]:8.1f} "
                    f"final_avg_regret={results[ds][m]['final_avg_regret']:.3f}"
                )
    return results


def run_offline_cb_experiment(
    dataset: str,
    *,
    T: int = 10_000,
    train_batches: int = 2_000,
    num_eval_steps: int = 500,
    num_envs: int = 10,
    seed: int = 0,
    data_dir=None,
    device: DeviceLike = None,
):
    """The reference's offline CB protocol (run_cb_benchmarks.py:70-152):
    log T interactions of a uniform policy (25% forced correct, as the
    reference's coin_flip == 0 branch), train a greedy NeuralBandit on them
    through `offline_learning`, then measure online regret without
    training."""
    device = resolve_device(device)
    X, y, source = get_dataset(dataset, data_dir)
    env = ClassificationBanditEnvironment(features=X, labels=y)
    k = int(y.max()) + 1

    rng = np.random.RandomState(seed)
    rows = rng.randint(0, X.shape[0], T)
    actions = rng.randint(0, k, T).astype(np.int32)
    forced = rng.rand(T) < 0.25
    actions[forced] = y[rows[forced]]
    rewards = (actions == y[rows]).astype(np.float32)
    batch = transitions_from_arrays(
        state=X[rows], action=actions[:, None], reward=rewards, next_state=X[rows],
        terminated=np.ones((T,), bool), action_index=actions, weight=np.ones((T,), np.float32),
        device=device,
    )
    buffer, buf_state = buffer_from_batch(batch)

    agent = PearlAgent(
        policy_learner=NeuralBandit(
            hidden_dims=(64, 16),
            learning_rate=0.01,
            batch_size=128,
            training_rounds=1,
            exploration=UCBExploration(alpha=0.0),  # greedy
            action_representation=BinaryActionRepresentation(bits=_bits(k)),
        ),
        replay_buffer=BasicReplayBuffer(capacity=num_envs),
    ).for_env(env)
    astate = agent.init(seed, X.shape[1], num_envs, torch.from_numpy(X[:num_envs]),
                        device=device)
    astate = offline_learning(agent, astate, buffer, buf_state, number_of_batches=train_batches,
                              batch_size=128, seed=seed, log_every=min(500, train_batches))
    out = run_bandit_benchmark(agent, env, num_envs=num_envs, steps=num_eval_steps,
                               seed=seed + 1, learn=False, exploit=True, agent_state=astate,
                               device=device)
    return {
        "source": source,
        "final_avg_regret": float(np.mean(out["regret"])),
        "cumulative_regret": out["cumulative_regret"] * num_envs,
    }
