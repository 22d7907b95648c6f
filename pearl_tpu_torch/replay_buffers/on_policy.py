"""On-policy trajectory buffer (port of `pearl_tpu/replay_buffers/on_policy.py`).

A fixed-size rollout: the driver learns exactly when `capacity =
rollout_steps * num_envs` transitions have been pushed, and the agent clears
the buffer after every learn of an on-policy learner. `trajectory_view`
exposes the storage as (T, num_envs, ...), so a learner walks the rollout
backwards over T and never stores what it derives.
"""

from __future__ import annotations

import dataclasses

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class OnPolicyReplayBuffer(BasicReplayBuffer):
    num_envs: int = 1

    @property
    def rollout_steps(self) -> int:
        return self.capacity // self.num_envs

    def trajectory_view(self, state: ReplayBufferState) -> TransitionBatch:
        """The storage as (T, num_envs, ...) views, time-ordered: after each
        clear the pushes come num_envs at a time from slot 0 (the bump ring
        restarts there). Views, not copies."""
        T, B = self.rollout_steps, self.num_envs
        return tree_map(lambda x: x[: T * B].view((T, B) + tuple(x.shape[1:])), state.storage)
