"""O(1) circular frame stacking for the visual pipeline (port of
`pearl_tpu/history_summarization_modules/frame_ring.py`).

The acting window of the last T observations lives in a circular (B, T, F)
frame ring written with one frame per step (all envs step in lockstep, so the
write cursor is one integer), with a (B, T) validity mask in place of zeroing
frames on reset. Consumers read the ring in ring order:
`CNNQValueNetwork` rotates its first conv kernel's input channels by the
cursor and masks invalid frames as it reads, so the time-ordered window is
never materialised on the act path. Semantics are those of a stacking
summarizer over observations only: the last T observations of the current
episode, zero-padded after a reset.

Differences from the reference, by design:
- the ring is written IN PLACE by the hand-written kernels of
  `ops/ring_write.py` (`observe` -> `ring_write`, `advance` ->
  `ring_write_where`), and the returned view shares the ring's storage with
  the view it was made from. Whoever needs a frame of the old window must
  read it before the write: `newest_frame` returns a strided view, which the
  agent copies out (`ops.layout_fence.copy_fence`) before `advance`;
- the cursor is a host integer (every step's cursor is known on the host, so
  tracking it costs no device sync); the validity mask is updated out of
  place, it is (B, T) bools.

Pairing contract (checked by `PearlAgent`): a replay buffer with frame pushes
(`VisualReplayBuffer`) and a network that consumes a `FrameRingView`
(`CNNQValueNetwork(time_major_stack=True)`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.history_summarization_modules.modules import HistorySummarizationModule
from pearl_tpu_torch.ops.ring_write import ring_write, ring_write_where


@dataclasses.dataclass
class FrameRingView:
    """Circular frame window: the per-env carry of
    `FrameRingHistorySummarization` and the subjective state that ring-aware
    networks consume.

    ring:   (B, T, F) frames in ring order; slot `(cursor - 1) % T` is newest.
    valid:  (B, T) bool, the slot belongs to the current episode (invalid
            slots read as zero frames).
    cursor: next write slot, a host integer shared by all envs.
    """

    ring: torch.Tensor
    valid: torch.Tensor
    cursor: int
    # True for views wrapped from replay-sampled windows (the learn path),
    # False for the live acting carry.
    from_replay: bool = False
    # Incremental-conv1 contribution cache (T, T, B, OC*OH*OW) in the ring's
    # dtype, laid out as `ops/conv_cache.py` says; owned by `PearlAgent` when
    # the paired CNN has `conv1_cache=True` and written IN PLACE like the
    # ring. None while the direct window conv is in use. `astype` and the
    # summarizer's methods carry it along untouched.
    cache: Optional[torch.Tensor] = None

    @property
    def shape(self):
        # The (B, stored_dim) shape the generic act paths expect.
        B, T, F = self.ring.shape
        return (B, T * F)

    @property
    def dtype(self):
        return self.ring.dtype

    def astype(self, dtype) -> "FrameRingView":
        return dataclasses.replace(self, ring=self.ring.to(dtype))

    def materialize(self) -> torch.Tensor:
        """Time-ordered, zero-masked (B, T*F) window, oldest frame first.
        O(T) frame traffic: the reference and testing path, never the act
        path."""
        B, T, F = self.ring.shape
        order = [(self.cursor + i) % T for i in range(T)]  # oldest ... newest
        frames = self.ring[:, order]
        mask = self.valid[:, order]
        return (frames * mask[..., None].to(frames.dtype)).reshape(B, T * F)


@dataclasses.dataclass(frozen=True)
class FrameRingHistorySummarization(HistorySummarizationModule):
    history_length: int = 4
    # Ring storage dtype (e.g. torch.bfloat16 halves the window's traffic and
    # the CNN act path consumes it as it is). None keeps float32.
    dtype: Optional[torch.dtype] = None

    @property
    def is_frame_ring(self) -> bool:
        return True

    def init_carry(self, num_envs, obs_dim, action_repr_dim, device):
        T = self.history_length
        return FrameRingView(
            ring=torch.zeros(
                (num_envs, T, obs_dim), dtype=self.dtype or torch.float32, device=device
            ),
            valid=torch.zeros((num_envs, T), dtype=torch.bool, device=device),
            cursor=0,
        )

    def observe(self, carry: FrameRingView, obs, action_repr) -> FrameRingView:
        """Append `obs` for every env. Writes into `carry.ring`."""
        del action_repr  # the window holds observations only
        c = carry.cursor
        ring = ring_write(carry.ring, obs.to(carry.ring.dtype), c)
        valid = carry.valid.clone()
        valid[:, c] = True
        return dataclasses.replace(
            carry, ring=ring, valid=valid, cursor=(c + 1) % self.history_length
        )

    def advance(self, carry: FrameRingView, obs, reset_obs, done) -> FrameRingView:
        """Post-step update, one frame write into `carry.ring`: envs that go
        on append `obs`; done envs restart their window with `reset_obs` as
        its only valid slot. The other T-1 slots are not touched."""
        c = carry.cursor
        dtype = carry.ring.dtype
        ring = ring_write_where(carry.ring, obs.to(dtype), reset_obs.to(dtype), done, c)
        valid = torch.where(done[:, None], False, carry.valid)
        valid[:, c] = True
        return dataclasses.replace(
            carry, ring=ring, valid=valid, cursor=(c + 1) % self.history_length
        )

    def newest_frame(self, carry: FrameRingView) -> torch.Tensor:
        """The most recently written frame, slot (cursor - 1) % T, as a
        (B, F) VIEW of the ring (row stride T*F): copy it before the next
        write if it must outlive it."""
        return carry.ring[:, (carry.cursor - 1) % self.history_length]

    def reset_envs(self, carry: FrameRingView, done_mask) -> FrameRingView:
        # Frames stay in place; invalidating the mask is the reset.
        return dataclasses.replace(
            carry, valid=torch.where(done_mask[:, None], False, carry.valid)
        )

    def stored(self, carry: FrameRingView) -> FrameRingView:
        return carry

    def forward(self, params, stored):
        if isinstance(stored, FrameRingView):
            return stored
        # Replay-sampled windows arrive as time-ordered (B, T*F) tensors with
        # zeros already in place: present them as an all-valid ring at cursor
        # 0, so networks handle one input type.
        B, T = stored.shape[0], self.history_length
        return FrameRingView(
            ring=stored.reshape(B, T, -1),
            valid=torch.ones((B, T), dtype=torch.bool, device=stored.device),
            cursor=0,
            from_replay=True,
        )

    def subjective_dim(self, obs_dim, action_repr_dim):
        return self.history_length * obs_dim

    def stored_dim(self, obs_dim, action_repr_dim):
        return self.history_length * obs_dim
