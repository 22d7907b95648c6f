"""Packed-storage replay (port of `pearl_tpu/replay_buffers/packed.py`).

`BasicReplayBuffer` keeps one device tensor per field, so a push is one ring
write per field. This variant flattens every field to float32 and keeps the
transition as one (capacity, F) ring: a push is one `cat` and one row-block
write, a sample one row gather, split and cast back per field.

Semantics are `BasicReplayBuffer`'s (bump ring, uniform sampling with
replacement, high-water `size`). The round trips are exact: bool -> {0, 1}
-> bool, and integers through float32 while |v| < 2^24 (action indices and
bootstrap masks are small). bfloat16 storage and integer fields wider than 32
bits are refused at `init`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import tree_map


def _fields(batch: TransitionBatch) -> List[str]:
    """The names of the fields that are set, in declaration order (the
    order of the reference's tree leaves, hence of its packed columns)."""
    return [f.name for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None]


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


@dataclasses.dataclass(frozen=True)
class PackedReplayBuffer(BasicReplayBuffer):
    """Uniform FIFO replay over one packed (capacity, F) float32 ring.

    `ReplayBufferState.storage` is `{"packed": (capacity, F) float32,
    "template": TransitionBatch}`; the template is the example with a
    zero-length batch axis, which keeps each field's trailing shape and dtype
    (fields that are `None` stay `None`)."""

    def init(self, example: TransitionBatch) -> ReplayBufferState:
        if self.bf16_storage:
            raise ValueError(
                "PackedReplayBuffer stores every field through one float32 ring; "
                "bf16_storage is not supported (use BasicReplayBuffer for bfloat16 "
                "per-field storage)."
            )
        for name in _fields(example):
            dtype = getattr(example, name).dtype
            if _is_integer(dtype) and dtype.itemsize > 4:
                raise ValueError(
                    f"PackedReplayBuffer cannot store {dtype} fields ({name}) exactly "
                    "through its float32 ring; use BasicReplayBuffer."
                )
        template = tree_map(lambda x: x[:0].clone(), example)
        width = sum(math.prod(getattr(example, n).shape[1:]) for n in _fields(example))
        packed = torch.zeros(
            (self.capacity, width), dtype=torch.float32, device=example.reward.device
        )
        return ReplayBufferState(
            storage={"packed": packed, "template": template}, cursor=0, size=0
        )

    @staticmethod
    def _pack(batch: TransitionBatch) -> torch.Tensor:
        """(N, F) float32: the set fields flattened and concatenated."""
        n = batch.batch_size
        return torch.cat(
            [getattr(batch, f).reshape(n, -1).to(torch.float32) for f in _fields(batch)], dim=-1
        )

    def push(
        self,
        state: ReplayBufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> ReplayBufferState:
        n = batch.batch_size
        start = self._push_start(state, n)
        state.storage["packed"][start : start + n].copy_(self._pack(batch))
        return ReplayBufferState(
            storage=state.storage,
            cursor=(start + n) % self.capacity,
            size=max(state.size, start + n),
        )

    def device(self, state: ReplayBufferState) -> torch.device:
        return state.storage["packed"].device

    def gather(self, state: ReplayBufferState, idx: torch.Tensor) -> TransitionBatch:
        """One row gather, then each field's columns reshaped and cast back."""
        rows = state.storage["packed"][idx]
        template = state.storage["template"]
        out, offset = {}, 0
        for name in _fields(template):
            t = getattr(template, name)
            width = math.prod(t.shape[1:])
            chunk = rows[:, offset : offset + width].reshape((rows.shape[0],) + tuple(t.shape[1:]))
            offset += width
            # Each field its own contiguous tensor, as the per-field layout gives.
            out[name] = chunk != 0.0 if t.dtype == torch.bool else chunk.to(t.dtype).contiguous()
        return dataclasses.replace(template, **out)
