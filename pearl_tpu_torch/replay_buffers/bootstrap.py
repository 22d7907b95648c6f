"""Bootstrap replay buffer (port of `pearl_tpu/replay_buffers/bootstrap.py`).

Each pushed transition draws a Bernoulli(p)^K inclusion mask over the K
ensemble members at push time, from the step's device generator;
`BootstrappedDQN` weights each member's loss by it (Osband et al. 2016). The
agent adds the `bootstrap_mask` column through `extra_example_fields`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch


@dataclasses.dataclass(frozen=True)
class BootstrapReplayBuffer(BasicReplayBuffer):
    p: float = 0.5
    ensemble_size: int = 10

    def extra_example_fields(self, action_space, device) -> dict:
        """The storage column `PearlAgent.init` adds for this buffer."""
        return {"bootstrap_mask": torch.zeros((1, self.ensemble_size), device=device)}

    def push(
        self,
        state: ReplayBufferState,
        batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> ReplayBufferState:
        """`mask` (N, K) float32, when given, replaces the draw (a uniform
        below p, as `jax.random.bernoulli` draws it)."""
        if mask is None:
            u = torch.rand(
                (batch.batch_size, self.ensemble_size), generator=generator,
                device=batch.reward.device,
            )
            mask = (u < self.p).to(torch.float32)
        return super().push(state, dataclasses.replace(batch, bootstrap_mask=mask))
