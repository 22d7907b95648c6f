"""History summarization modules (port of
`pearl_tpu/history_summarization_modules/modules.py`,
`IdentityHistorySummarization` only).

Protocol, batched over B envs:

    init_params(generator, obs_dim, action_repr_dim) -> params ({} if none)
    init_carry(num_envs, obs_dim, action_repr_dim, device) -> carry
    observe(carry, obs, action_repr) -> carry'
    reset_envs(carry, done_mask) -> carry'
    stored(carry) -> (B, stored_dim)      what replay stores
    forward(params, stored) -> (B, subjective_dim)
"""

from __future__ import annotations

import abc
import dataclasses

import torch


class HistorySummarizationModule(abc.ABC):
    def init_params(self, generator, obs_dim: int, action_repr_dim: int):
        return {}

    @abc.abstractmethod
    def init_carry(self, num_envs: int, obs_dim: int, action_repr_dim: int, device):
        ...

    @abc.abstractmethod
    def observe(self, carry, obs, action_repr):
        ...

    @abc.abstractmethod
    def reset_envs(self, carry, done_mask):
        ...

    @abc.abstractmethod
    def stored(self, carry) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def forward(self, params, stored: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def subjective_dim(self, obs_dim: int, action_repr_dim: int) -> int:
        ...

    def stored_dim(self, obs_dim: int, action_repr_dim: int) -> int:
        return self.subjective_dim(obs_dim, action_repr_dim)


@dataclasses.dataclass(frozen=True)
class IdentityHistorySummarization(HistorySummarizationModule):
    """Subjective state = latest observation."""

    def init_carry(self, num_envs, obs_dim, action_repr_dim, device):
        return torch.zeros((num_envs, obs_dim), device=device)

    def observe(self, carry, obs, action_repr):
        del action_repr
        return obs

    def reset_envs(self, carry, done_mask):
        return carry  # the next observe overwrites it

    def stored(self, carry):
        return carry

    def forward(self, params, stored):
        return stored

    def subjective_dim(self, obs_dim, action_repr_dim):
        return obs_dim
