"""SARSA replay buffer (port of `pearl_tpu/replay_buffers/sarsa.py`).

A transition is committed only once the NEXT action is known: each push holds
its batch in a per-env pending cache and commits the previous batch, with this
batch's action as `next_action`. The first push only fills the cache. The
reference gates the commit on a device bool inside its compiled step; here
the flag is a host bool, since every push is known on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch


@dataclasses.dataclass
class SARSABufferState(ReplayBufferState):
    pending: Optional[TransitionBatch] = None  # the last pushed batch, not yet committed
    pending_valid: bool = False


@dataclasses.dataclass(frozen=True)
class SARSAReplayBuffer(BasicReplayBuffer):
    num_envs: int = 1  # rows per push, the size of the pending cache

    def extra_example_fields(self, action_space, device) -> dict:
        """The storage columns `PearlAgent.init` adds for this buffer."""
        return {
            "next_action": torch.zeros((1, action_space.action_dim), device=device),
            "next_action_index": torch.zeros((1,), dtype=torch.int32, device=device),
        }

    def init(self, example: TransitionBatch) -> SARSABufferState:
        base = super().init(example)
        return SARSABufferState(storage=base.storage, cursor=base.cursor, size=base.size)

    @property
    def supports_deferred_push(self) -> bool:
        return False  # the pending cache pairs rows step by step

    def push(
        self,
        state: SARSABufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> SARSABufferState:
        base = ReplayBufferState(storage=state.storage, cursor=state.cursor, size=state.size)
        if state.pending_valid:
            committed = dataclasses.replace(
                state.pending, next_action=batch.action, next_action_index=batch.action_index
            )
            base = super().push(base, committed)
        return SARSABufferState(
            storage=base.storage, cursor=base.cursor, size=base.size,
            pending=batch, pending_valid=True,
        )
