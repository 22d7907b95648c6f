"""Hindsight experience replay (port of `pearl_tpu/replay_buffers/hindsight.py`;
final-goal relabeling, Andrychowicz et al. 2017).

Every push writes the raw transitions to the ring AND appends them to a
per-env (num_envs, max_episode_len) trajectory cache. When an env's episode
ends, its cached steps are written once more with the goal replaced by the
finally achieved state, and reward and terminated recomputed by `reward_fn`.

Observation layout (the sparse-reach envs'): the state ends with the
`goal_dim` goal features, and its first `goal_dim` features are the achieved
position.

The device cursor. How many rows a step flushes depends on which envs are
done, a device value. The other buffers keep their cursor and size on the
host, which here would make the host wait on the device every env step; so
this buffer keeps both as 0-dim int64 device tensors. A push is two
`index_copy_` per field into a ring with one more row, a dump row at index
`capacity`: the raw rows at start + arange(N), then all num_envs *
max_episode_len relabeled rows, where rows of envs that are not done (or
past an episode's length) target the dump row, the rows the reference drops
with `mode="drop"`. `sample_indices` draws below the device `size`. Nothing
in push or sample reads the device on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import tree_map


@dataclasses.dataclass
class HERBufferState(ReplayBufferState):
    # cursor and size are 0-dim int64 device tensors here; storage leaves
    # have capacity + 1 rows, the last the dump row.
    trajectory: Optional[TransitionBatch] = None  # (num_envs, max_episode_len, ...)
    lengths: Optional[torch.Tensor] = None  # (num_envs,) int32


def default_reach_reward_fn(achieved, goal, reward_distance: float = 4.0):
    """The sparse reach reward of `DiscreteSparseRewardEnvironment`: 0 within
    `reward_distance` of the goal (and terminated), else -1."""
    reached = torch.linalg.vector_norm(achieved - goal, dim=-1) < reward_distance
    return torch.where(reached, 0.0, -1.0), reached


@dataclasses.dataclass(frozen=True, eq=False)
class HindsightExperienceReplayBuffer(BasicReplayBuffer):
    num_envs: int = 1
    max_episode_len: int = 50
    goal_dim: int = 2
    reward_fn: Callable = default_reach_reward_fn

    @property
    def supports_deferred_push(self) -> bool:
        return False  # the per-env trajectory cache pairs rows step by step

    def init(self, example: TransitionBatch) -> HERBufferState:
        device = example.reward.device
        storage = tree_map(
            lambda x: torch.zeros(
                (self.capacity + 1,) + tuple(x.shape[1:]), dtype=self._store_dtype(x.dtype),
                device=device,
            ),
            example,
        )
        trajectory = tree_map(
            lambda x: torch.zeros(
                (self.num_envs, self.max_episode_len) + tuple(x.shape[1:]), dtype=x.dtype,
                device=device,
            ),
            example,
        )
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return HERBufferState(
            storage=storage, cursor=zero, size=zero.clone(), trajectory=trajectory,
            lengths=torch.zeros((self.num_envs,), dtype=torch.int32, device=device),
        )

    def _relabel(self, traj: TransitionBatch, new_goal: torch.Tensor) -> TransitionBatch:
        """traj leaves (B, L, ...); new_goal (B, goal_dim)."""
        g = self.goal_dim
        goal = new_goal[:, None, :].expand(traj.state.shape[:-1] + (g,))

        def swap_goal(s):
            return torch.cat([s[..., :-g], goal], dim=-1)

        reward, terminated = self.reward_fn(traj.next_state[..., :g], goal)
        return dataclasses.replace(
            traj,
            state=swap_goal(traj.state),
            next_state=swap_goal(traj.next_state),
            reward=reward,
            terminated=terminated,
            truncated=torch.zeros_like(traj.truncated),
        )

    def push(
        self,
        state: HERBufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> HERBufferState:
        B, L, cap = self.num_envs, self.max_episode_len, self.capacity
        n = batch.batch_size
        if n != B:
            raise ValueError(
                f"HindsightExperienceReplayBuffer pushes must be exactly num_envs={B} rows "
                f"(got {n}): one row per env per step"
            )
        self._warn_if_misaligned(n)
        device = batch.reward.device
        rows = torch.arange(n, device=device)

        def write(buf, v, index):
            buf.index_copy_(0, index, v.reshape((index.shape[0],) + tuple(buf.shape[1:]))
                            .to(buf.dtype))
            return buf

        # 1. The raw transitions, at the bump ring's start.
        start = torch.where(state.cursor + n <= cap, state.cursor, 0)
        tree_map(lambda buf, v: write(buf, v, start + rows), state.storage, batch)
        cursor = (start + n) % cap
        size = torch.maximum(state.size, start + n)

        # 2. Append to each env's trajectory cache (an episode longer than L
        #    keeps rewriting its last slot).
        slot = torch.clamp(state.lengths, max=L - 1).to(torch.int64)
        flat = rows * L + slot
        tree_map(
            lambda cache, v: write(cache.view((B * L,) + tuple(cache.shape[2:])), v, flat),
            state.trajectory, batch,
        )
        lengths = torch.clamp(state.lengths + 1, max=L)

        # 3. Relabel every cached step with its env's final achieved state and
        #    flush the rows of done envs below their episode's length.
        done = batch.done
        relabeled = self._relabel(state.trajectory, batch.next_state[:, : self.goal_dim])
        valid = (done[:, None] & (torch.arange(L, device=device)[None, :] < lengths[:, None]))
        valid = valid.reshape(-1)
        n_flush = valid.sum()
        order = torch.cumsum(valid, 0) - 1
        target = torch.where(valid, (cursor + order) % cap, cap)
        tree_map(lambda buf, v: write(buf, v, target), state.storage, relabeled)
        return HERBufferState(
            storage=state.storage,
            cursor=(cursor + n_flush) % cap,
            size=torch.clamp(size + n_flush, max=cap),
            trajectory=state.trajectory,
            lengths=torch.where(done, 0, lengths).to(torch.int32),
        )

    def sample_indices(
        self, state: HERBufferState, generator: torch.Generator, batch_size: int
    ) -> torch.Tensor:
        """Uniform indices below the device `size` (at least 1)."""
        n = torch.clamp(state.size, min=1)
        u = torch.rand((batch_size,), generator=generator, dtype=torch.float64,
                       device=n.device)
        return torch.minimum((u * n).to(torch.int64), n - 1)

    def clear(self, state: HERBufferState) -> HERBufferState:
        return dataclasses.replace(
            state, cursor=torch.zeros_like(state.cursor), size=torch.zeros_like(state.size)
        )
