"""Prioritized experience replay (port of
`pearl_tpu/replay_buffers/prioritized.py`; Schaul et al. 2016).

Priorities are a dense (capacity,) float32 tensor on the device. A push gives
its rows the current max(max p, 1); a sample draws row i with probability
proportional to max(p_i, epsilon)^alpha over the written rows and returns
the importance weights (N P(i))^-beta, normalized by the batch's largest,
in the batch's `weight` field; `update_priorities` writes |td| + epsilon.

Sampling. The reference draws with `jax.random.categorical` over the logits
alpha log max(p, epsilon), a Gumbel max over a (batch, capacity) array. At
2M rows and a batch of 1024 that array is 8 GB, so the port draws from the
same distribution by inverse CDF: a float64 prefix sum of the unnormalized
probabilities (a float32 sum over millions of rows would lose the small
ones) and a `searchsorted` of uniform draws. Nothing in the draw, the
weights or the write-back reads the device on the host.

Write-back with repeated indices. The reference's `.at[idx].set` leaves the
order of duplicate writes to XLA. Here the rule is: where an index repeats
in a batch, its last occurrence in batch order wins. Every duplicate writes
that occurrence's value, so the scatter's order cannot change the result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch


@dataclasses.dataclass
class PrioritizedBufferState(ReplayBufferState):
    priorities: Optional[torch.Tensor] = None  # (capacity,) float32


def last_occurrence_values(indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values[j'] for each j, where j' is the last position in `indices` that
    holds indices[j]: writing the result at `indices` gives every target its
    last value in batch order, whatever order the scatter runs in."""
    n = indices.shape[0]
    sorted_idx, order = torch.sort(indices, stable=True)
    pos = torch.arange(n, device=indices.device)
    # In sorted order a group of equal indices keeps batch order (stable
    # sort), so its last member is where the next sorted index differs.
    is_end = torch.ones((n,), dtype=torch.bool, device=indices.device)
    is_end[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    end = torch.where(is_end, pos, n)
    group_end = torch.flip(torch.cummin(torch.flip(end, (0,)), 0).values, (0,))
    sorted_values = values[order][group_end]
    out = torch.empty_like(values)
    out[order] = sorted_values
    return out


@dataclasses.dataclass(frozen=True)
class PrioritizedReplayBuffer(BasicReplayBuffer):
    alpha: float = 0.6
    beta: float = 0.4
    epsilon: float = 1e-4

    def init(self, example: TransitionBatch) -> PrioritizedBufferState:
        base = super().init(example)
        return PrioritizedBufferState(
            storage=base.storage, cursor=0, size=0,
            priorities=torch.zeros((self.capacity,), device=example.reward.device),
        )

    def push(
        self,
        state: PrioritizedBufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> PrioritizedBufferState:
        n = batch.batch_size
        max_p = torch.clamp(state.priorities.max(), min=1.0)
        base = super().push(state, batch)
        start = (base.cursor - n) % self.capacity  # where the base push wrote
        state.priorities[start : start + n].copy_(max_p.expand(n))
        return PrioritizedBufferState(
            storage=base.storage, cursor=base.cursor, size=base.size,
            priorities=state.priorities,
        )

    def _weights(self, state: PrioritizedBufferState) -> torch.Tensor:
        """max(p, epsilon)^alpha over the written rows, float64: each row's
        probability up to the common factor."""
        p = state.priorities[: max(state.size, 1)].to(torch.float64)
        return torch.clamp(p, min=self.epsilon) ** self.alpha

    @staticmethod
    def _draw(cdf: torch.Tensor, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Inverse-CDF draws of `batch_size` rows under the prefix sum `cdf`."""
        u = torch.rand((batch_size,), generator=generator, dtype=torch.float64, device=cdf.device)
        idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
        return torch.clamp(idx, max=cdf.shape[0] - 1)

    def _weighted(self, state, idx, w_idx: torch.Tensor, total: torch.Tensor) -> TransitionBatch:
        """The rows `idx` with their importance weights in `weight`, from the
        rows' weights `w_idx` and the weights' sum `total`."""
        probs = torch.clamp(w_idx / total, min=1e-12)
        is_w = (max(state.size, 1) * probs) ** (-self.beta)
        is_w = is_w / torch.clamp(is_w.max(), min=1e-12)
        return dataclasses.replace(super().gather(state, idx), weight=is_w.to(torch.float32))

    def sample_indices(
        self, state: PrioritizedBufferState, generator: torch.Generator, batch_size: int
    ) -> torch.Tensor:
        """Draws by inverse CDF over the written rows."""
        return self._draw(torch.cumsum(self._weights(state), 0), generator, batch_size)

    def gather(self, state: PrioritizedBufferState, idx: torch.Tensor) -> TransitionBatch:
        """The rows `idx` with their importance weights in `weight`."""
        w = self._weights(state)
        return self._weighted(state, idx, w[idx], w.sum())

    def sample_with_indices(
        self,
        state: PrioritizedBufferState,
        generator: Optional[torch.Generator],
        batch_size: int,
        indices: Optional[torch.Tensor] = None,
    ) -> tuple[TransitionBatch, torch.Tensor]:
        """(batch, indices): the given indices, or a draw, as the reference's
        `sample_with_indices` returns them. A draw computes the
        weights over all rows once, for its prefix sum and for the importance
        weights alike (the sum of all weights is the prefix sum's last)."""
        if indices is not None:
            return self.gather(state, indices), indices
        w = self._weights(state)
        cdf = torch.cumsum(w, 0)
        idx = self._draw(cdf, generator, batch_size)
        return self._weighted(state, idx, w[idx], cdf[-1]), idx

    def sample(
        self,
        state: PrioritizedBufferState,
        generator: Optional[torch.Generator],
        batch_size: int,
        indices: Optional[torch.Tensor] = None,
    ) -> TransitionBatch:
        return self.sample_with_indices(state, generator, batch_size, indices)[0]

    def update_priorities(
        self, state: PrioritizedBufferState, indices: torch.Tensor, td_errors: torch.Tensor
    ) -> PrioritizedBufferState:
        """p[indices] = |td| + epsilon, in place; a repeated index takes its
        last occurrence's value."""
        new_p = torch.abs(td_errors).to(state.priorities.dtype) + self.epsilon
        state.priorities[indices] = last_occurrence_values(indices, new_p)
        return state
