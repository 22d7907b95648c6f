"""Online learning driver (port of `pearl_tpu/training/online.py` on one
device).

One chunk is `learn_every_k_steps` vectorized env steps followed by one
`agent.learn`; a dispatch runs `chunks_per_dispatch` chunks eagerly on the
device and hands the host one tensor of statistics, fetched read-behind:
dispatch i+1 is enqueued before dispatch i's statistics are fetched, so early
stopping lags one dispatch, as in the reference. Nothing inside a dispatch
reads a device value on the host.

Three statistics modes (`stats=`):

- "full": every step's (done, return, cost, risky ratio) of every env, one
  (4, steps, B) tensor per dispatch; exact per-episode curves.
- "summary": the accounting stays on the device: each env's last finished
  return, whether it has finished an episode, the finished-episode count
  (int64) and the float32 sums of return, cost and risky ratio. The host
  fetches one (C, 6) row block per dispatch, a row per chunk, and early
  stopping tests every row, gated on the count and on the number of envs
  behind the recent-return statistic. The reference keeps the count in
  float32, which stops being exact past 2^24 episodes; the int64 count
  equals it wherever it is exact.
- "curves": finished episodes' (return, cost, risky ratio) go into a (3, R)
  device ring (`curve_capacity` R) in finish order, step-major then env
  order as in "full", and the host drains it once per dispatch. More than R
  episodes in one dispatch: the oldest are dropped and counted in
  `episodes_dropped`. The ring has one more column, a dump slot for the
  envs that did not finish, so one `scatter_` with no duplicate target
  writes a step; where more than R envs finish in one step, only the last R
  in env order are written (those the drain reads), so no slot has two
  writers and the result does not depend on the order of a scatter.

`deferred_push=True` collects a chunk's transitions and writes them in one
step-major push of k * B rows; with capacity % (k * B) == 0 the ring holds
the same rows as k per-step pushes, and the run is the same bit for bit. The
reference measured it slower on its chip; it stays opt-in.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np
import torch

from pearl_tpu_torch.agent.pearl_agent import AgentState, PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import tree_map

# Columns of the summary mode's per-chunk row.
_S_TOTAL_FIN = 0  # finished episodes so far (cumulative)
_S_SUM_RET = 1  # sum of finished-episode returns (cumulative)
_S_RECENT = 2  # mean over envs of the most recent finished-episode return
_S_SUM_COST = 3  # sum of finished-episode costs (cumulative)
_S_SUM_RISKY = 4  # sum of finished-episode risky ratios (cumulative)
_S_ENVS_FIN = 5  # number of envs with >= 1 finished episode

_STATS_MODES = ("full", "summary", "curves")


@dataclasses.dataclass
class OnlineResult:
    episode_returns: np.ndarray  # returns of finished episodes, in finish order
    total_steps: int  # total env steps executed (num_envs * steps)
    agent_state: AgentState
    env_states: object
    reached_target: bool = False
    episode_costs: np.ndarray = None  # aligned with episode_returns
    episode_risky_ratios: np.ndarray = None
    # Summary mode: the per-chunk recent-return statistic and the cumulative
    # means; episode_returns is empty there.
    return_curve: np.ndarray = None
    total_episodes: int = 0
    mean_return: float = 0.0
    mean_cost: float = 0.0
    mean_risky_ratio: float = 0.0
    # Curves mode: episodes overwritten in the ring before the host drained it.
    episodes_dropped: int = 0


# ----------------------------------------------------------- device accounting
class _FullStats:
    """stats="full": one (4, steps, B) tensor per dispatch."""

    def __init__(self, num_envs: int, device):
        self.rows: List[torch.Tensor] = []

    def step(self, done, ep_ret, ep_cost, risky_ratio):
        self.rows.append(torch.stack([done.to(torch.float32), ep_ret, ep_cost, risky_ratio]))

    def end_chunk(self):
        pass

    def end_dispatch(self) -> torch.Tensor:
        stats, self.rows = torch.stack(self.rows, dim=1), []
        return stats


class _SummaryStats:
    """stats="summary": per-env last return and finished flag, the int64
    count and the float32 sums stay on the device; one float64 row of the six
    `_S_*` columns per chunk, stacked (C, 6) per dispatch."""

    def __init__(self, num_envs: int, device):
        self.last_ret = torch.zeros((num_envs,), device=device)
        self.envs_fin = torch.zeros((num_envs,), dtype=torch.bool, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.sums = torch.zeros((3,), device=device)  # return, cost, risky ratio
        self.rows: List[torch.Tensor] = []

    def step(self, done, ep_ret, ep_cost, risky_ratio):
        self.last_ret = torch.where(done, ep_ret, self.last_ret)
        self.envs_fin = self.envs_fin | done
        finished = torch.stack([ep_ret, ep_cost, risky_ratio]) * done.to(torch.float32)
        self.sums = self.sums + finished.sum(dim=1)
        self.count = self.count + done.sum()

    def end_chunk(self):
        n_fin = self.envs_fin.to(torch.float32).sum()
        recent = (self.last_ret * self.envs_fin).sum() / torch.clamp(n_fin, min=1.0)
        sums = self.sums.to(torch.float64)
        self.rows.append(torch.stack([
            self.count.to(torch.float64), sums[0], recent.to(torch.float64), sums[1], sums[2],
            n_fin.to(torch.float64),
        ]))

    def end_dispatch(self) -> torch.Tensor:
        stats, self.rows = torch.stack(self.rows), []
        return stats


class _CurveStats:
    """stats="curves": the (3, R + 1) ring, its write index mod R and the
    int64 lifetime count, all on the device. A dispatch ends with one int32
    snapshot: the ring's R columns (float32 bits) and the count (two words),
    so that the next dispatch's in-place writes cannot reach what the host
    reads."""

    def __init__(self, num_envs: int, device, capacity: int):
        self.R = capacity
        self.ring = torch.zeros((3, capacity + 1), device=device)
        self.count_mod = torch.zeros((), dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.collide = num_envs > capacity

    def step(self, done, ep_ret, ep_cost, risky_ratio):
        R = self.R
        ranks = torch.cumsum(done, dim=0)  # int64; finisher k has rank k
        K = ranks[-1]
        keep = done & (ranks > K - R) if self.collide else done
        slot = torch.where(keep, (ranks + (self.count_mod - 1)) % R, R)
        values = torch.stack([ep_ret, ep_cost, risky_ratio])
        self.ring.scatter_(1, slot[None].expand(3, -1), values)
        self.count_mod = (self.count_mod + K) % R
        self.count = self.count + K

    def end_chunk(self):
        pass

    def end_dispatch(self) -> torch.Tensor:
        ring = self.ring[:, : self.R].reshape(-1).view(torch.int32)
        return torch.cat([ring, self.count.reshape(1).view(torch.int32)])


class RingDrain:
    """The host side of the curves ring: the reference's drain arithmetic
    (`pearl_tpu/training/online.py`, `_drain_ring`). The device count is read
    modulo 2^32 and the exact lifetime total is rebuilt from deltas modulo
    2^32, as the reference does with its wrapping uint32 counter."""

    def __init__(self):
        self.drained = 0  # episodes drained so far, dropped ones included
        self.raw_prev = 0  # the last 32-bit count seen
        self.total = 0  # exact lifetime finished count
        self.dropped = 0

    def drain(self, count: int, ring: np.ndarray) -> np.ndarray:
        """(n, 3) rows of (return, cost, risky ratio) of the episodes finished
        since the last drain, in finish order, from the (3, R) `ring` and the
        device's lifetime `count`. The oldest beyond R are lost and counted."""
        R = ring.shape[1]
        raw = int(count) & 0xFFFFFFFF
        self.total += (raw - self.raw_prev) & 0xFFFFFFFF
        self.raw_prev = raw
        end = self.total
        new = end - self.drained
        if new <= 0:
            return np.zeros((0, 3), ring.dtype)
        lost = max(0, new - R)
        self.dropped += lost
        start = end - (new - lost)
        self.drained = end
        return ring.T[np.arange(start, end) % R]


def _make_chunk_fn(
    agent, venv, steps_per_chunk, do_learn, exploit, chunks_per_dispatch, stats, deferred_push,
):
    """(astate, env_states, ep_ret, ep_aux, generator) -> (astate, env_states,
    ep_ret, ep_aux, stats tensor of the dispatch); `stats` is the mode's
    device accounting, which the dispatch updates."""

    def run_chunk(astate, env_states, ep_ret, ep_aux, generator):
        ep_cost, ep_risky, ep_len = ep_aux
        for _ in range(chunks_per_dispatch):
            transitions = []
            for _ in range(steps_per_chunk):
                astate, choice = agent.act(astate, generator, exploit=exploit)
                env_states, result, next_obs = venv.step(env_states, choice.action, generator)
                if deferred_push:
                    astate, transition = agent.observe_deferred(astate, result, next_obs, generator)
                    transitions.append(transition)
                else:
                    astate = agent.observe(astate, result, next_obs, generator)
                ep_ret = ep_ret + result.reward
                cost = result.cost if result.cost is not None else torch.zeros_like(result.reward)
                risky = result.info["risky_sa"] if "risky_sa" in result.info else cost != 0
                ep_cost = ep_cost + cost
                ep_risky = ep_risky + risky.to(torch.float32)
                ep_len = ep_len + 1.0
                done = result.done
                stats.step(done, ep_ret, ep_cost, ep_risky / torch.clamp(ep_len, min=1.0))
                ep_ret = torch.where(done, 0.0, ep_ret)
                ep_cost = torch.where(done, 0.0, ep_cost)
                ep_risky = torch.where(done, 0.0, ep_risky)
                ep_len = torch.where(done, 0.0, ep_len)
            if deferred_push:
                # One step-major push of k * B rows.
                flat = tree_map(lambda *xs: torch.cat(xs), *transitions)
                astate = dataclasses.replace(
                    astate, replay=agent.replay_buffer.push(astate.replay, flat)
                )
            if do_learn:
                astate, _ = agent.learn(astate, generator)
            stats.end_chunk()
        return astate, env_states, ep_ret, (ep_cost, ep_risky, ep_len), stats.end_dispatch()

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
    curve_capacity: int = 4096,
    mesh=None,
    deferred_push: Optional[bool] = None,
    device: DeviceLike = None,
) -> OnlineResult:
    """Run vectorized online learning on `device` (the card unless
    `device="cpu"`) until `max_steps` total env steps, or until the mean
    return of the last `target_window` finished episodes reaches
    `target_return` (in "summary" mode: the mean over envs of each one's most
    recent finished return, once `target_window` episodes and as many envs
    have finished). Until `learning_starts` env steps the chunks do not
    learn. A given `agent_state` keeps its learned state and gets fresh
    per-env leaves for the new envs."""
    if stats not in _STATS_MODES:
        raise ValueError(f"stats must be one of {_STATS_MODES}, got {stats!r}")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP Queue A, item 20)")
    deferred_push = bool(deferred_push)
    if deferred_push and not agent.replay_buffer.supports_deferred_push:
        raise ValueError(
            f"{type(agent.replay_buffer).__name__} does not support deferred "
            "(chunk-granular) pushes"
        )
    if stats == "curves" and num_envs > curve_capacity:
        warnings.warn(
            f"stats='curves' with num_envs={num_envs} > curve_capacity={curve_capacity}: "
            "if more than curve_capacity episodes finish in one step, the oldest of them "
            "are dropped (counted in episodes_dropped). Raise curve_capacity to at least "
            "num_envs to rule this out.",
            stacklevel=2,
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

    if stats == "curves":
        accounting = _CurveStats(num_envs, device, curve_capacity)
    else:
        accounting = (_SummaryStats if stats == "summary" else _FullStats)(num_envs, device)

    def chunk_fn(do_learn):
        return _make_chunk_fn(agent, venv, learn_every_k_steps, do_learn, exploit,
                              chunks_per_dispatch, accounting, deferred_push)

    run_chunk = chunk_fn(learn)
    warm_chunk = chunk_fn(False) if learning_starts > 0 else None

    ep_ret = torch.zeros((num_envs,), device=device)
    ep_aux = tuple(torch.zeros((num_envs,), device=device) for _ in range(3))
    finished: list = []
    finished_costs: list = []
    finished_risky: list = []
    curve: list = []
    last_summary = np.zeros((6,))
    drain = RingDrain()
    total = 0
    reached = False

    def consume(stats_dev, steps_done):
        """Fetch one dispatch's stats (one device-to-host copy) and fold its
        finished episodes in."""
        nonlocal reached, last_summary
        arr = stats_dev.cpu().numpy()
        if stats == "summary":
            rows = arr
            curve.extend(rows[:, _S_RECENT].tolist())
            last_summary = rows[-1]
            if verbose:
                print(
                    f"steps={steps_done} episodes={int(last_summary[_S_TOTAL_FIN])} "
                    f"recent_return={last_summary[_S_RECENT]:.1f}"
                )
            if target_return is not None:
                hit = (
                    (rows[:, _S_TOTAL_FIN] >= target_window)
                    & (rows[:, _S_ENVS_FIN] >= min(target_window, num_envs))
                    & (rows[:, _S_RECENT] >= target_return)
                )
                reached = reached or bool(hit.any())
            return
        if stats == "curves":
            ring = arr[:-2].view(np.float32).reshape(3, curve_capacity)
            episodes = drain.drain(int(arr[-2:].view(np.int64)[0]), ring)
            ret, cost, risky = episodes[:, 0], episodes[:, 1], episodes[:, 2]
        else:
            d = arr[0].reshape(-1) > 0.5
            ret, cost, risky = (arr[i].reshape(-1)[d] for i in (1, 2, 3))
        finished.extend(ret.tolist())
        finished_costs.extend(cost.tolist())
        finished_risky.extend(risky.tolist())
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
    if stats == "summary":
        n_ep = int(last_summary[_S_TOTAL_FIN])
        return OnlineResult(
            episode_returns=np.zeros((0,)),
            total_steps=total,
            agent_state=agent_state,
            env_states=env_states,
            reached_target=reached,
            episode_costs=np.zeros((0,)),
            episode_risky_ratios=np.zeros((0,)),
            return_curve=np.asarray(curve),
            total_episodes=n_ep,
            mean_return=float(last_summary[_S_SUM_RET] / max(n_ep, 1)),
            mean_cost=float(last_summary[_S_SUM_COST] / max(n_ep, 1)),
            mean_risky_ratio=float(last_summary[_S_SUM_RISKY] / max(n_ep, 1)),
        )
    return OnlineResult(
        episode_returns=np.asarray(finished),
        total_steps=total,
        agent_state=agent_state,
        env_states=env_states,
        reached_target=reached,
        episode_costs=np.asarray(finished_costs),
        episode_risky_ratios=np.asarray(finished_risky),
        # curves: the lifetime count, dropped episodes included.
        total_episodes=drain.total if stats == "curves" else len(finished),
        episodes_dropped=drain.dropped,
    )
