"""Online learning driver (port of `pearl_tpu/training/online.py`,
`stats="full"` on one device).

One chunk is `learn_every_k_steps` vectorized env steps followed by one
`agent.learn`; a dispatch runs `chunks_per_dispatch` chunks eagerly on the
device. Every step's (done, return, cost, risky) for every env is packed into
one (4, steps, B) tensor per dispatch and fetched once, read-behind: dispatch
i+1 is enqueued before dispatch i's stats are fetched, so early stopping on
the moving-average return lags one dispatch, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pearl_tpu_torch.agent.pearl_agent import AgentState, PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device


@dataclasses.dataclass
class OnlineResult:
    episode_returns: np.ndarray  # returns of finished episodes, in finish order
    total_steps: int  # total env steps executed (num_envs * steps)
    agent_state: AgentState
    env_states: object
    reached_target: bool = False
    episode_costs: np.ndarray = None  # aligned with episode_returns
    episode_risky_ratios: np.ndarray = None
    total_episodes: int = 0


def _make_chunk_fn(agent, venv, steps_per_chunk, do_learn, exploit, chunks_per_dispatch):
    """(astate, env_states, ep_ret, ep_aux, generator) -> (astate, env_states,
    ep_ret, ep_aux, stats (4, chunks*steps, B))."""

    def run_chunk(astate, env_states, ep_ret, ep_aux, generator):
        ep_cost, ep_risky, ep_len = ep_aux
        rows = []
        for _ in range(chunks_per_dispatch):
            for _ in range(steps_per_chunk):
                astate, choice = agent.act(astate, generator, exploit=exploit)
                env_states, result, next_obs = venv.step(env_states, choice.action, generator)
                astate = agent.observe(astate, result, next_obs, generator)
                ep_ret = ep_ret + result.reward
                cost = result.cost if result.cost is not None else torch.zeros_like(result.reward)
                risky = result.info["risky_sa"] if "risky_sa" in result.info else cost != 0
                ep_cost = ep_cost + cost
                ep_risky = ep_risky + risky.to(torch.float32)
                ep_len = ep_len + 1.0
                done = result.done
                risky_ratio = ep_risky / torch.clamp(ep_len, min=1.0)
                rows.append(torch.stack([done.to(torch.float32), ep_ret, ep_cost, risky_ratio]))
                ep_ret = torch.where(done, 0.0, ep_ret)
                ep_cost = torch.where(done, 0.0, ep_cost)
                ep_risky = torch.where(done, 0.0, ep_risky)
                ep_len = torch.where(done, 0.0, ep_len)
            if do_learn:
                astate, _ = agent.learn(astate, generator)
        stats = torch.stack(rows, dim=1)  # (4, chunks*steps, B), step-major
        return astate, env_states, ep_ret, (ep_cost, ep_risky, ep_len), stats

    return run_chunk


def online_learning(
    agent: PearlAgent,
    env,
    *,
    num_envs: int = 16,
    max_steps: int = 100_000,
    learn_every_k_steps: int = 1,
    chunks_per_dispatch: int = 1,
    learning_starts: int = 0,
    seed: int = 0,
    target_return: Optional[float] = None,
    target_window: int = 20,
    exploit: bool = False,
    learn: bool = True,
    agent_state: Optional[AgentState] = None,
    env_states=None,
    verbose: bool = False,
    stats: str = "full",
    mesh=None,
    deferred_push: Optional[bool] = None,
    device: DeviceLike = None,
) -> OnlineResult:
    """Run vectorized online learning on `device` (the card unless
    `device="cpu"`) until `max_steps` total env steps, or until the mean
    return of the last `target_window` finished episodes reaches
    `target_return`. Until `learning_starts` env steps the chunks do not
    learn. A given `agent_state` keeps its learned state and gets fresh
    per-env leaves for the new envs."""
    if stats != "full":
        raise NotImplementedError(
            f"stats={stats!r} is not ported yet; only 'full' (ROADMAP Queue A, item 9)"
        )
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP Queue A, item 20)")
    if deferred_push:
        raise NotImplementedError(
            "deferred (chunk-granular) pushes are not ported yet (ROADMAP Queue A, item 9)"
        )
    min_pushes = getattr(agent.replay_buffer, "min_pushes_before_sample", 1)
    if learn and min_pushes > 1 and learning_starts == 0 and learn_every_k_steps < min_pushes:
        # VisualReplayBuffer(dedup_next=True) excludes the newest resident
        # push from sampling; learning off a 1-push buffer would resample
        # that push with a zeroed next frame.
        raise ValueError(
            f"{type(agent.replay_buffer).__name__} needs {min_pushes} pushes before its "
            f"first sample (min_pushes_before_sample), but learning_starts=0 with "
            f"learn_every_k_steps={learn_every_k_steps} would learn after "
            f"{learn_every_k_steps}. Set learning_starts >= {min_pushes} * num_envs or "
            f"learn_every_k_steps >= {min_pushes}."
        )
    device = resolve_device(device)
    agent = agent.for_env(env)
    venv = VectorEnv(env, num_envs, device)
    generator = make_generator(seed, device)

    if env_states is None:
        env_states, obs = venv.reset(generator)
        if agent_state is None:
            agent_state = agent.init(seed, venv.observation_dim, num_envs, obs, device=device)
        else:
            agent_state = dataclasses.replace(
                agent_state,
                **agent.fresh_per_env_state(
                    venv.observation_dim, num_envs, obs, device,
                    params=agent.cache_params(agent_state.learner),
                ),
            )

    run_chunk = _make_chunk_fn(
        agent, venv, learn_every_k_steps, learn, exploit, chunks_per_dispatch
    )
    warm_chunk = (
        _make_chunk_fn(agent, venv, learn_every_k_steps, False, exploit, chunks_per_dispatch)
        if learning_starts > 0
        else None
    )

    ep_ret = torch.zeros((num_envs,), device=device)
    ep_aux = tuple(torch.zeros((num_envs,), device=device) for _ in range(3))
    finished: list = []
    finished_costs: list = []
    finished_risky: list = []
    total = 0
    reached = False

    def consume(stats_dev, steps_done):
        """Fetch one dispatch's stats and fold its finished episodes in."""
        nonlocal reached
        arr = stats_dev.cpu().numpy()
        d = arr[0].reshape(-1) > 0.5
        finished.extend(arr[1].reshape(-1)[d].tolist())
        finished_costs.extend(arr[2].reshape(-1)[d].tolist())
        finished_risky.extend(arr[3].reshape(-1)[d].tolist())
        if verbose and finished:
            window = finished[-target_window:]
            print(
                f"steps={steps_done} episodes={len(finished)} "
                f"avg_return={np.mean(window):.1f}"
            )
        if target_return is not None and len(finished) >= target_window:
            if np.mean(finished[-target_window:]) >= target_return:
                reached = True

    pending = None  # (stats on the device, total steps after that dispatch)
    while total < max_steps and not reached:
        learning_now = not (warm_chunk is not None and total < learning_starts)
        chunk = run_chunk if learning_now else warm_chunk
        agent_state, env_states, ep_ret, ep_aux, stats_dev = chunk(
            agent_state, env_states, ep_ret, ep_aux, generator
        )
        total += learn_every_k_steps * num_envs * chunks_per_dispatch
        if pending is not None:
            consume(*pending)
        pending = (stats_dev, total)
    if pending is not None:
        consume(*pending)
    return OnlineResult(
        episode_returns=np.asarray(finished),
        total_steps=total,
        agent_state=agent_state,
        env_states=env_states,
        reached_target=reached,
        episode_costs=np.asarray(finished_costs),
        episode_risky_ratios=np.asarray(finished_risky),
        total_episodes=len(finished),
    )
