"""Transition batches (port of `pearl_tpu/replay_buffers/transition.py`).

One `TransitionBatch` dataclass serves as the per-step record (leading axis
= num_envs), the sampled batch (leading axis = batch_size) and the replay
storage (leading axis = capacity). Optional fields are `None` when unused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TransitionBatch:
    state: torch.Tensor  # (B, s)
    action: torch.Tensor  # (B, a) raw action vector as stored by the env/agent
    reward: torch.Tensor  # (B,)
    next_state: torch.Tensor  # (B, s)
    terminated: torch.Tensor  # (B,) bool
    truncated: torch.Tensor  # (B,) bool
    action_index: Optional[torch.Tensor] = None  # (B,) i32 — discrete only
    curr_available_mask: Optional[torch.Tensor] = None  # (B, A) bool
    next_available_mask: Optional[torch.Tensor] = None  # (B, A) bool
    curr_available_actions: Optional[torch.Tensor] = None  # (B, A, a)
    next_available_actions: Optional[torch.Tensor] = None  # (B, A, a)
    next_action: Optional[torch.Tensor] = None  # (B, a) — SARSA
    next_action_index: Optional[torch.Tensor] = None  # (B,) — SARSA
    weight: Optional[torch.Tensor] = None  # (B,)
    cost: Optional[torch.Tensor] = None  # (B,)
    time_diff: Optional[torch.Tensor] = None  # (B,)
    bootstrap_mask: Optional[torch.Tensor] = None  # (B, K)

    @property
    def batch_size(self) -> int:
        return int(self.reward.shape[0])

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


def single_transition(**kwargs) -> TransitionBatch:
    """A `TransitionBatch` whose batch axis has size 1, made from unbatched
    leaves (tensors, arrays or numbers). Leaves take JAX's default dtypes:
    float64 becomes float32 and int64 int32."""
    narrow = {torch.float64: torch.float32, torch.int64: torch.int32}

    def batched(x):
        t = torch.as_tensor(x)
        return t.to(narrow.get(t.dtype, t.dtype))[None]

    return TransitionBatch(**{k: None if v is None else batched(v) for k, v in kwargs.items()})
