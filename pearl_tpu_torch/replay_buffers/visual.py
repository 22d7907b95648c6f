"""Frame-dedup replay for visual (frame-stacked) observations (port of
`pearl_tpu/replay_buffers/visual.py`).

A transition whose state and next state are T-frame stacks holds T+1 frames
of which T-1 repeat the previous step's. This buffer stores TWO frames per
row — the acting observation `s` (the stack's newest frame) and the
post-step observation `n` — plus a per-push sequence tag, and rebuilds both
stacks at sample time from the neighbouring rows (one row per env per step,
so env e's previous step lives exactly `num_envs` rows back).

`dedup_next=True` goes to ONE frame per row: `n` of row i repeats `s` of row
i + num_envs within an episode, so the next stack's newest frame is read from
the successor row (the newest resident push, whose successor is not written
yet, is excluded from sampling). Episode-final rows have no successor inside
the episode; truncated rows' final frames live in the side ring `frame_t`,
and terminated rows read a zero newest next-frame, which no TD target sees
(next values are multiplied by 1 - terminated).

Stack reconstruction is exactly a stacking summarizer's over observations
only: frames older than the current episode are zeros, enforced by a
done-chain mask, and the sequence tag kills frames lost to ring wrap,
overwrite or underfill.

Differences from the reference, by design: storage is written in place, and
cursor, size and push count are host integers; the push count reaches the
device's sequence tag as a fill kernel's argument, so a push never waits for
the device.
`push_frames` writes the masked `frame_t` slab on EVERY push, where the
reference skips the write under a `lax.cond` when no row is truncated: a
data-dependent branch would make the host wait on the device each step. The
two differ only in `frame_t` rows that `sample` never reads (it consults
`frame_t[i]` only when row i itself is truncated).

Constraints (checked): capacity % num_envs == 0; capacity >= stack *
num_envs; every push is exactly num_envs rows (one vectorized env step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import tree_map

_NEVER = -(10**9)  # sequence tag of a slab that was never pushed


@dataclasses.dataclass
class VisualBufferState(ReplayBufferState):
    # storage: dict with "frame_s" (capacity, F) frame ring, "frame_n" too
    # unless dedup_next and "frame_t" (the truncation side ring) with it,
    # "seq" (cap_pushes,) i32 per-push sequence tag, and "rest", a
    # TransitionBatch of (capacity, ...) rows with state/next_state = None.
    push_count: int = 0  # total pushes so far


@dataclasses.dataclass(frozen=True)
class VisualReplayBuffer(BasicReplayBuffer):
    stack: int = 4  # frames per stacked state (the summarizer's history_length)
    num_envs: int = 1  # rows per push == the env-step batch (the frame stride)
    # Storage dtype of the frame rings only (e.g. torch.bfloat16). Sampled
    # frames are promoted to at least float32. None keeps the state's dtype.
    frame_dtype: Optional[torch.dtype] = None
    dedup_next: bool = False

    @property
    def min_pushes_before_sample(self) -> int:
        """Resident pushes required before `sample` is meaningful: under
        dedup_next the newest resident push is excluded, so one more must be
        present."""
        return 2 if self.dedup_next else 1

    @property
    def supports_deferred_push(self) -> bool:
        return False  # neighbour reconstruction needs one row per env per push

    @property
    def supports_frame_push(self) -> bool:
        return True  # push_frames: the frame-ring fast-path entry

    def _frame_size(self, stored_dim: int) -> int:
        if stored_dim % self.stack != 0:
            raise ValueError(
                f"state dim {stored_dim} is not stack={self.stack} frames; pair "
                "VisualReplayBuffer with a summarizer whose window is `stack` "
                "observations (FrameRingHistorySummarization(history_length=stack))"
            )
        return stored_dim // self.stack

    @property
    def _cap_pushes(self) -> int:
        return self.capacity // self.num_envs

    def init(self, example: TransitionBatch) -> VisualBufferState:
        if self.capacity % self.num_envs != 0:
            raise ValueError(
                f"capacity {self.capacity} must be a multiple of num_envs {self.num_envs}"
            )
        if self.capacity < self.stack * self.num_envs:
            # After a wrap, sampling excludes the oldest (stack - 1) resident
            # pushes; with fewer than `stack` pushes resident nothing is left.
            raise ValueError(
                f"capacity {self.capacity} must be >= stack*num_envs = "
                f"{self.stack * self.num_envs} (the ring must hold at least "
                "`stack` pushes for neighbor reconstruction)"
            )
        F = self._frame_size(example.state.shape[-1])
        device = example.state.device
        frame_dtype = self.frame_dtype or example.state.dtype

        def frames():
            return torch.zeros((self.capacity, F), dtype=frame_dtype, device=device)

        rest = dataclasses.replace(example, state=None, next_state=None)
        storage = {
            "frame_s": frames(),
            "seq": torch.full((self._cap_pushes,), _NEVER, dtype=torch.int32, device=device),
            "rest": tree_map(
                lambda x: torch.zeros(
                    (self.capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
                ),
                rest,
            ),
        }
        storage["frame_t" if self.dedup_next else "frame_n"] = frames()
        return VisualBufferState(storage=storage, cursor=0, size=0, push_count=0)

    def push_frames(
        self,
        state: VisualBufferState,
        frame_s: torch.Tensor,
        frame_n: torch.Tensor,
        rest: TransitionBatch,
    ) -> VisualBufferState:
        """One vectorized env step as single frames: `frame_s` (B, F) is the
        acting observation (the state stack's newest frame), `frame_n` the
        post-step observation. `rest` carries every non-visual field (its
        state/next_state are ignored). Writes into the storage."""
        n = frame_s.shape[0]
        if n != self.num_envs:
            raise ValueError(
                f"VisualReplayBuffer pushes must be exactly num_envs={self.num_envs} "
                f"rows (got {n}): one row per env per step"
            )
        slot = state.push_count % self._cap_pushes
        start = slot * n
        st = state.storage

        def write_rows(buf, v):
            buf[start : start + n].copy_(v)
            return buf

        write_rows(st["frame_s"], frame_s)
        # fill_ takes the tag as a kernel argument; `seq[slot] = count` would
        # copy a host scalar from pageable memory and wait for the device.
        st["seq"][slot].fill_(state.push_count)
        tree_map(write_rows, st["rest"], dataclasses.replace(rest, state=None, next_state=None))
        if not self.dedup_next:
            write_rows(st["frame_n"], frame_n)
        else:
            if frame_n is None:
                raise ValueError(
                    "dedup_next requires the post-step frame at push time "
                    "(truncated rows' final frames go to the side ring)"
                )
            side = st["frame_t"]
            torch.where(
                rest.truncated[:, None],
                frame_n.to(side.dtype),
                side.new_zeros(()),
                out=side[start : start + n],
            )
        return VisualBufferState(
            storage=st,
            cursor=(start + n) % self.capacity,
            size=max(state.size, start + n),
            push_count=state.push_count + 1,
        )

    def push(
        self,
        state: VisualBufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> VisualBufferState:
        F = self._frame_size(batch.state.shape[-1])
        return self.push_frames(state, batch.state[:, -F:], batch.next_state[:, -F:], batch)

    def _sample_range(self, state: VisualBufferState):
        """(oldest sampled push, number of sampled rows). After the ring
        wraps, the oldest (stack - 1) resident pushes have lost their
        backward neighbours and are excluded; under dedup_next the newest
        resident push is excluded too."""
        pc, T = state.push_count, self.stack
        oldest = 0 if pc <= self._cap_pushes else pc - self._cap_pushes + (T - 1)
        newest_excl = 1 if self.dedup_next else 0
        return oldest, max(pc - newest_excl - oldest, 1) * self.num_envs

    def sample_indices(
        self, state: VisualBufferState, generator: torch.Generator, batch_size: int
    ) -> torch.Tensor:
        """Uniform draws over the sampled rows, counted from the oldest
        sampled push, on the storage device (`gather` maps them to slots)."""
        _, n_valid = self._sample_range(state)
        device = state.storage["seq"].device
        return torch.randint(0, n_valid, (batch_size,), generator=generator, device=device)

    def gather(self, state: VisualBufferState, q: torch.Tensor) -> TransitionBatch:
        """Rebuild the transitions of the draws `q` (see `sample_indices`):
        both stacks oldest frame first, (batch, stack * F)."""
        st = state.storage
        B, T, cap_pushes = self.num_envs, self.stack, self._cap_pushes
        oldest, _ = self._sample_range(state)
        slot = (oldest + q // B) % cap_pushes  # frame-ring slab
        env = q % B
        idx = slot * B + env  # flat row
        rest = tree_map(lambda buf: buf[idx], st["rest"])
        dtype = torch.promote_types(st["frame_s"].dtype, torch.float32)

        seq_i = st["seq"][slot]
        s_i = st["frame_s"][idx].to(dtype)
        done = rest.terminated | rest.truncated
        if self.dedup_next:
            # Next stack's newest frame: the successor slab (same env, next
            # push) for mid-episode rows, the side ring for truncated rows,
            # zero for terminated rows.
            slot2 = (slot + 1) % cap_pushes
            succ_ok = (st["seq"][slot2] == seq_i + 1) & ~done
            n_i = torch.where(
                succ_ok[:, None],
                st["frame_s"][slot2 * B + env].to(dtype),
                torch.where(rest.truncated[:, None], st["frame_t"][idx].to(dtype), 0.0),
            )
        else:
            n_i = st["frame_n"][idx].to(dtype)

        # Older frames: env e's step k back lives in the slab k pushes back.
        # A neighbour contributes iff its sequence tag is exactly k less and
        # no episode boundary lies in between (the done chain).
        frames = [s_i]  # state stack, newest first (reversed below)
        valid = torch.ones_like(done)
        for k in range(1, T):
            slot_k = (slot - k) % cap_pushes
            jdx = slot_k * B + env
            prev_done = st["rest"].terminated[jdx] | st["rest"].truncated[jdx]
            valid = valid & (st["seq"][slot_k] == seq_i - k) & ~prev_done
            frames.append(torch.where(valid[:, None], st["frame_s"][jdx].to(dtype), 0.0))
        # state = [oldest ... newest = s_i]; next_state drops the oldest and
        # appends n_i.
        return dataclasses.replace(
            rest,
            state=torch.cat(frames[::-1], dim=-1),
            next_state=torch.cat(frames[-2::-1] + [n_i], dim=-1),
        )

    def clear(self, state: VisualBufferState) -> VisualBufferState:
        # Invalidate the sequence tags so stale neighbours never match.
        state.storage["seq"].fill_(_NEVER)
        return dataclasses.replace(state, cursor=0, size=0, push_count=0)
