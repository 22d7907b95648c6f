"""Device-resident ring-buffer replay (port of
`pearl_tpu/replay_buffers/replay_buffer.py`: `BasicReplayBuffer` and
`SingleTransitionReplayBuffer`).

Storage is a preallocated `TransitionBatch` of (capacity, ...) tensors on the
device. `push` writes in place (the reference returns a new array; in place
saves a copy of the whole ring per step). The cursor and size are host
integers: every push has a size known on the host, so tracking them costs no
device sync.

`push` takes the device generator of the step as every buffer's `push` does
(`BootstrapReplayBuffer` draws its masks from it); a buffer that draws
nothing ignores it.
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
    # Store float32 fields as bfloat16 (half the memory and the push and
    # sample traffic); `gather` casts them back to float32.
    bf16_storage: bool = False

    @property
    def supports_deferred_push(self) -> bool:
        """Whether a driver may collect a chunk's k steps x B envs of
        transitions (step-major) and write them in one push instead of k:
        true when a push is a ring write and a cursor bump, which holds the
        same rows either way when capacity % (k * B) == 0. False for buffers
        whose push pairs rows with a per-env cache (SARSA's next action) or
        with the frame path."""
        return True

    def init(self, example: TransitionBatch) -> ReplayBufferState:
        """`example` is a TransitionBatch with any leading axis on the target
        device (only its shapes, dtypes and device are used)."""
        storage = tree_map(
            lambda x: torch.zeros(
                (self.capacity,) + tuple(x.shape[1:]), dtype=self._store_dtype(x.dtype),
                device=x.device,
            ),
            example,
        )
        return ReplayBufferState(storage=storage, cursor=0, size=0)

    def _store_dtype(self, dtype: torch.dtype) -> torch.dtype:
        if self.bf16_storage and dtype == torch.float32:
            return torch.bfloat16
        return dtype

    def push(
        self,
        state: ReplayBufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> ReplayBufferState:
        """Write a batch of N transitions at the cursor as one contiguous
        slice. Bump ring: if the batch would not fit before the end, the
        write restarts at slot 0 instead of wrapping mid-batch, and `size` is
        the high-water mark, so never-written tail slots are never sampled
        (the reference's semantics, replay_buffer.py:113-125)."""
        n = batch.batch_size
        start = self._push_start(state, n)

        def _write(buf, v):
            buf[start : start + n].copy_(v)
            return buf

        tree_map(_write, state.storage, batch)
        return ReplayBufferState(
            storage=state.storage,
            cursor=(start + n) % self.capacity,
            size=max(state.size, start + n),
        )

    def _push_start(self, state: ReplayBufferState, n: int) -> int:
        """The bump ring's first row for a push of n rows."""
        self._warn_if_misaligned(n)
        return state.cursor if state.cursor + n <= self.capacity else 0

    def _warn_if_misaligned(self, n: int) -> None:
        if self.capacity % n != 0:
            warnings.warn(
                f"Replay capacity {self.capacity} is not a multiple of the push "
                f"batch size {n}: the last {self.capacity % n} slots are never "
                "written or sampled.",
                stacklevel=4,
            )

    def device(self, state: ReplayBufferState) -> torch.device:
        return state.storage.reward.device

    def sample_indices(
        self, state: ReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> torch.Tensor:
        """Uniform indices over the written extent, on the storage device."""
        return torch.randint(
            0, max(state.size, 1), (batch_size,), generator=generator,
            device=self.device(state),
        )

    def gather(self, state: ReplayBufferState, idx: torch.Tensor) -> TransitionBatch:
        """The rows `idx`, bfloat16 storage cast back to float32."""
        return tree_map(
            lambda buf: buf[idx].to(torch.float32) if buf.dtype == torch.bfloat16 else buf[idx],
            state.storage,
        )

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


@dataclasses.dataclass(frozen=True)
class SingleTransitionReplayBuffer(BasicReplayBuffer):
    """A one-row buffer, the default of the tabular and bandit learners: it
    holds the last transition of one env."""

    capacity: int = 1

    @property
    def supports_deferred_push(self) -> bool:
        return False  # a chunk of k * B rows cannot fit one row
