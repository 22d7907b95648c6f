"""Device-resident ring-buffer replay (port of
`pearl_tpu/replay_buffers/replay_buffer.py`, `BasicReplayBuffer`).

Storage is a preallocated `TransitionBatch` of (capacity, ...) tensors on the
device. `push` writes in place (the reference returns a new array; in place
saves a copy of the whole ring per step). The cursor and size are host
integers: every push has a size known on the host, so tracking them costs no
device sync.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import tree_map


@dataclasses.dataclass
class ReplayBufferState:
    storage: TransitionBatch  # every leaf has leading axis = capacity
    cursor: int  # next write slot
    size: int  # high-water mark of the written extent


@dataclasses.dataclass(frozen=True)
class BasicReplayBuffer:
    """Uniform FIFO replay, sampled uniformly with replacement."""

    capacity: int = 10_000

    def init(self, example: TransitionBatch) -> ReplayBufferState:
        """`example` is a TransitionBatch with any leading axis on the target
        device (only its shapes, dtypes and device are used)."""
        storage = tree_map(
            lambda x: torch.zeros(
                (self.capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
            ),
            example,
        )
        return ReplayBufferState(storage=storage, cursor=0, size=0)

    def push(self, state: ReplayBufferState, batch: TransitionBatch) -> ReplayBufferState:
        """Write a batch of N transitions at the cursor as one contiguous
        slice. Bump ring: if the batch would not fit before the end, the
        write restarts at slot 0 instead of wrapping mid-batch, and `size` is
        the high-water mark, so never-written tail slots are never sampled
        (the reference's semantics, replay_buffer.py:113-125)."""
        n = batch.batch_size
        if self.capacity % n != 0:
            warnings.warn(
                f"Replay capacity {self.capacity} is not a multiple of the push "
                f"batch size {n}: the last {self.capacity % n} slots are never "
                "written or sampled.",
                stacklevel=2,
            )
        start = state.cursor if state.cursor + n <= self.capacity else 0

        def _write(buf, v):
            buf[start : start + n].copy_(v)
            return buf

        tree_map(_write, state.storage, batch)
        return ReplayBufferState(
            storage=state.storage,
            cursor=(start + n) % self.capacity,
            size=max(state.size, start + n),
        )

    def sample_indices(
        self, state: ReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> torch.Tensor:
        """Uniform indices over the written extent, on the storage device."""
        device = state.storage.reward.device
        return torch.randint(
            0, max(state.size, 1), (batch_size,), generator=generator, device=device
        )

    def gather(self, state: ReplayBufferState, idx: torch.Tensor) -> TransitionBatch:
        return tree_map(lambda buf: buf[idx], state.storage)

    def sample(
        self,
        state: ReplayBufferState,
        generator: Optional[torch.Generator],
        batch_size: int,
        indices: Optional[torch.Tensor] = None,
    ) -> TransitionBatch:
        """Draw indices (or take the given ones) and gather those rows."""
        if indices is None:
            indices = self.sample_indices(state, generator, batch_size)
        return self.gather(state, indices)

    def clear(self, state: ReplayBufferState) -> ReplayBufferState:
        return dataclasses.replace(state, cursor=0, size=0)

    def __len__(self) -> int:
        return self.capacity
