"""Population training: a seed or hyperparameter sweep of M members run in
lockstep on one device (port of `pearl_tpu/training/population.py`).

The reference stacks the members' states on a leading axis and `vmap`s one
compiled chunk program over it. Eager PyTorch has no such program, so here
each member keeps its own `AgentState`, env states, device generator and
summary accounting, and a dispatch runs every member's chunks in turn, the
same chunk function `online_learning` runs (`training/online.py`). Member m
is seeded as a solo `online_learning(seed=seeds[m], stats="summary")` call
is, so it is that run, step for step. The host fetches one (M, C, 6) stack of
the members' summary rows per dispatch, read behind by one dispatch.

Hyperparameters that live in the state can differ per member
(`member_state_transform`), e.g. discrete SAC's actor learning rate, a
tensor in `actor_opt.param_groups[0]["lr"]`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from pearl_tpu_torch.agent.pearl_agent import AgentState, PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.replay_buffers.prioritized import PrioritizedReplayBuffer
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer
from pearl_tpu_torch.training.online import (
    _S_ENVS_FIN,
    _S_RECENT,
    _S_SUM_RET,
    _S_TOTAL_FIN,
    _SummaryStats,
    _make_chunk_fn,
)
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device


@dataclasses.dataclass
class PopulationResult:
    num_members: int
    total_steps: int  # env steps per member
    agent_states: List[AgentState]  # one per member, in member order
    env_states: list  # one per member, in member order
    # (chunks, M): the recent-return statistic of every member after each
    # chunk, the sweep's learning curves.
    return_curves: np.ndarray
    mean_returns: np.ndarray  # (M,) mean finished-episode return per member
    total_episodes: np.ndarray  # (M,) finished episodes per member
    recent_returns: np.ndarray  # (M,) last recent-return statistic per member
    reached_target: bool = False

    def member_state(self, i: int) -> AgentState:
        """Member i's AgentState (e.g. to checkpoint the best seed)."""
        return self.agent_states[i]


def _ring_position(replay):
    """The replay ring's (cursor, size), host ints or device tensors."""
    return getattr(replay, "cursor", None), getattr(replay, "size", None)


def population_learning(
    agent: PearlAgent,
    env,
    *,
    num_members: int = 4,
    num_envs: int = 16,
    max_steps: int = 100_000,
    learn_every_k_steps: int = 1,
    chunks_per_dispatch: int = 1,
    learning_starts: int = 0,
    seeds: Optional[Sequence[int]] = None,
    seed: int = 0,
    target_return: Optional[float] = None,
    target_window: int = 20,
    exploit: bool = False,
    member_state_transform: Optional[
        Callable[[torch.Tensor, List[AgentState]], List[AgentState]]
    ] = None,
    shared_ring_cursor: Optional[bool] = None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> PopulationResult:
    """Train `num_members` independent agents together on `device` (the card
    unless `device="cpu"`).

    Member m runs the `online_learning` chunk pipeline with seed `seeds[m]`
    (default `seed + m`), its own `num_envs` envs, replay ring and learner
    state; `max_steps` counts env steps per member. With `target_return`
    set, training stops once a chunk's row has EVERY member's recent-return
    statistic at the target (gated as in `online_learning`'s summary mode).

    `member_state_transform(member_indices, states)` edits the freshly
    initialized states: it receives the (M,) member indices and the list of
    M AgentStates and returns the list.

    `shared_ring_cursor` selects a layout in the reference only (the ring's
    cursor kept unbatched under its vmap; by default for BasicReplayBuffer
    and PrioritizedReplayBuffer, whose cursors advance the same in every
    member). Here every member keeps its own ring, so both values give the
    same states; with it on, the run ends by checking that every member's
    ring cursor and size are equal, as the reference's layout assumes."""
    if seeds is None:
        seeds = [seed + m for m in range(num_members)]
    if len(seeds) != num_members:
        raise ValueError(f"len(seeds)={len(seeds)} != num_members={num_members}")
    if shared_ring_cursor is None:
        shared_ring_cursor = type(agent.replay_buffer) in (
            BasicReplayBuffer,
            PrioritizedReplayBuffer,
        )
    device = resolve_device(device)
    bound = agent.for_env(env)
    venv = VectorEnv(env, num_envs, device)

    generators, agent_states, env_states = [], [], []
    for s in seeds:
        # online_learning's seeding (training/online.py): one device generator
        # resets the envs and drives the run; the weights come from the seed.
        generator = make_generator(s, device)
        member_env_states, obs = venv.reset(generator)
        generators.append(generator)
        env_states.append(member_env_states)
        agent_states.append(bound.init(s, venv.observation_dim, num_envs, obs, device=device))
    if member_state_transform is not None:
        agent_states = list(member_state_transform(torch.arange(num_members), agent_states))

    accounting = [_SummaryStats(num_envs, device) for _ in range(num_members)]

    def chunk_fns(do_learn):
        return [
            _make_chunk_fn(bound, venv, learn_every_k_steps, do_learn, exploit,
                           chunks_per_dispatch, acc, False)
            for acc in accounting
        ]

    run_chunks = chunk_fns(True)
    warm_chunks = chunk_fns(False) if learning_starts > 0 else None

    ep_rets = [torch.zeros((num_envs,), device=device) for _ in range(num_members)]
    ep_auxs = [
        tuple(torch.zeros((num_envs,), device=device) for _ in range(3))
        for _ in range(num_members)
    ]
    curves: list = []
    last_summary = np.zeros((num_members, 6))
    total = 0
    reached = False

    def consume(stats_dev, steps_done):
        """One host fetch of the (M, C, 6) rows of a dispatch."""
        nonlocal reached, last_summary
        rows = stats_dev.cpu().numpy()
        curves.extend(np.moveaxis(rows[:, :, _S_RECENT], 0, 1).tolist())
        last_summary = rows[:, -1]
        if verbose:
            rec = ", ".join(f"{v:.1f}" for v in last_summary[:, _S_RECENT])
            print(f"steps/member={steps_done} recent_returns=[{rec}]")
        if target_return is not None:
            ok = (
                (rows[:, :, _S_TOTAL_FIN] >= target_window)
                & (rows[:, :, _S_ENVS_FIN] >= min(target_window, num_envs))
                & (rows[:, :, _S_RECENT] >= target_return)
            )
            # Every member at target on the same chunk row.
            reached = reached or bool(ok.all(axis=0).any())

    pending = None
    while total < max_steps and not reached:
        learning_now = not (warm_chunks is not None and total < learning_starts)
        chunks = run_chunks if learning_now else warm_chunks
        member_stats = []
        for m in range(num_members):
            agent_states[m], env_states[m], ep_rets[m], ep_auxs[m], stats_m = chunks[m](
                agent_states[m], env_states[m], ep_rets[m], ep_auxs[m], generators[m]
            )
            member_stats.append(stats_m)
        total += learn_every_k_steps * num_envs * chunks_per_dispatch
        stats_dev = torch.stack(member_stats)
        if pending is not None:
            consume(*pending)
        pending = (stats_dev, total)
    if pending is not None:
        consume(*pending)

    if shared_ring_cursor:
        positions = [_ring_position(s.replay) for s in agent_states]
        for m, position in enumerate(positions[1:], start=1):
            if any(
                not torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                for a, b in zip(position, positions[0])
            ):
                raise ValueError(
                    f"shared_ring_cursor: member {m}'s ring (cursor, size) {position} differs "
                    f"from member 0's {positions[0]}; pass shared_ring_cursor=False for a "
                    f"{type(agent.replay_buffer).__name__}"
                )
    n_ep = last_summary[:, _S_TOTAL_FIN]
    return PopulationResult(
        num_members=num_members,
        total_steps=total,
        agent_states=agent_states,
        env_states=env_states,
        return_curves=np.asarray(curves),
        mean_returns=last_summary[:, _S_SUM_RET] / np.maximum(n_ep, 1.0),
        total_episodes=n_ep.astype(np.int64),
        recent_returns=last_summary[:, _S_RECENT],
        reached_target=reached,
    )
