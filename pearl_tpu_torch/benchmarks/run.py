"""Benchmark runner (port of `pearl_tpu/benchmarks/run.py`; the reference
Pearl's benchmark.py:75-477).

Each (method, run) is one vectorized `online_learning` call on `device`
(the card unless `device="cpu"`), run one after another. The learning curves
(mean episode return in bins of finished episodes) are saved as .npy and,
with `plot`, drawn as mean +/- stderr across runs (matplotlib, imported only
then)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from pearl_tpu_torch.benchmarks.configs import METHODS, Method
from pearl_tpu_torch.training.online import online_learning
from pearl_tpu_torch.utils.device import DeviceLike


def run_single(
    method: Method,
    env,
    *,
    num_envs: int = 16,
    max_steps: int = 100_000,
    record_period: int = 1_000,
    seed: int = 0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Returns the learning curve: mean episode return per record bin."""
    agent = method.make_agent(num_envs)
    res = online_learning(
        agent,
        env,
        num_envs=num_envs,
        max_steps=max_steps,
        learn_every_k_steps=method.learn_every_k_steps,
        learning_starts=method.learning_starts,
        seed=seed,
        device=device,
    )
    returns = res.episode_returns
    bins = max(1, max_steps // record_period)
    if len(returns) == 0:
        return np.zeros(bins)
    # Bin by completion order, proportional to step budget.
    splits = np.array_split(returns, bins)
    return np.array([s.mean() if len(s) else np.nan for s in splits])


def run_benchmark(
    method_names: Sequence[str],
    env_factory,
    *,
    num_envs: int = 16,
    max_steps: int = 100_000,
    record_period: int = 1_000,
    num_runs: int = 4,
    out_dir: Optional[str] = None,
    plot: bool = False,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Run each method x num_runs seeds; returns {method: (runs, bins)}."""
    results: Dict[str, np.ndarray] = {}
    for name in method_names:
        method = METHODS[name]
        curves: List[np.ndarray] = []
        for run in range(num_runs):
            env = env_factory()
            curves.append(
                run_single(
                    method,
                    env,
                    num_envs=num_envs,
                    max_steps=max_steps,
                    record_period=record_period,
                    seed=run,
                    device=device,
                )
            )
        results[name] = np.stack(curves)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"{name}.npy"), results[name])
    if plot and out_dir:
        _plot(results, out_dir)
    return results


def _plot(results: Dict[str, np.ndarray], out_dir: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, curves in results.items():
        mean = np.nanmean(curves, axis=0)
        stderr = np.nanstd(curves, axis=0) / np.sqrt(curves.shape[0])
        x = np.arange(len(mean))
        ax.plot(x, mean, label=name)
        ax.fill_between(x, mean - stderr, mean + stderr, alpha=0.2)
    ax.set_xlabel("record period")
    ax.set_ylabel("episode return")
    ax.legend()
    fig.savefig(os.path.join(out_dir, "benchmark.png"), dpi=120)
    plt.close(fig)
