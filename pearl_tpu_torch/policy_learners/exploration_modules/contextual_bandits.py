"""Contextual-bandit exploration modules (port of
`pearl_tpu/policy_learners/exploration_modules/contextual_bandits.py`).

Protocol: a bandit learner computes each arm's (mu, sigma), both (B, A), and
calls

    act_scores(state, mu, sigma, mask, generator, noise=None) -> (state', index (B,))

`noise`, when given, replaces the module's draw (Thompson sampling's N(0, 1),
SquareCB's and FastCB's Gumbel noise), so tests hand the port the JAX code's
own draws.

`VanillaUCBExploration` counts each arm's pulls as int64 on the card and the
total as a host integer (it grows by B an act, a number the host knows): the
JAX package's float32 counters stop counting at 2^24, which 131072 envs reach
after 128 acts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    ExplorationModule,
    gumbel,
    masked_argmax,
)


class BanditExplorationModule(ExplorationModule):
    def act_scores(self, state, mu, sigma, mask, generator, noise=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UCBExploration(BanditExplorationModule):
    """The argmax of mu + alpha * sigma; a NaN sigma counts as 0."""

    alpha: float = 1.0

    def scores(self, mu, sigma):
        return mu + self.alpha * torch.nan_to_num(sigma, nan=0.0)

    def act_scores(self, state, mu, sigma, mask, generator, noise=None):
        return state, masked_argmax(self.scores(mu, sigma), mask)


@dataclasses.dataclass
class VanillaUCBState:
    action_counts: torch.Tensor  # (A,) int64 on the device
    total: int  # acts taken, over all envs


@dataclasses.dataclass(frozen=True)
class VanillaUCBExploration(BanditExplorationModule):
    """Count-based UCB: the argmax of mu + sqrt(2 log t / n_a), t the acts
    taken (at least 1) and n_a arm a's count (at least 1e-3)."""

    num_actions: int = 0

    def init(self, num_envs: int, device=None) -> VanillaUCBState:
        counts = torch.zeros((self.num_actions,), dtype=torch.int64, device=device)
        return VanillaUCBState(action_counts=counts, total=0)

    def bonus(self, state: VanillaUCBState) -> torch.Tensor:
        """sqrt(2 log t / n_a) of each arm, (A,) float32."""
        counts = state.action_counts.to(torch.float32)
        return torch.sqrt(2.0 * math.log(max(state.total, 1)) / torch.clamp(counts, min=1e-3))

    def act_scores(self, state, mu, sigma, mask, generator, noise=None):
        index = masked_argmax(mu + self.bonus(state)[None, :], mask)
        pulls = torch.ones_like(index, dtype=torch.int64)
        counts = state.action_counts.index_add(0, index.long(), pulls)
        return VanillaUCBState(action_counts=counts, total=state.total + index.shape[0]), index


@dataclasses.dataclass(frozen=True)
class ThompsonSamplingExplorationLinear(BanditExplorationModule):
    """Per-arm Thompson sampling: the argmax of mu + sigma * eps, eps ~ N(0, 1)
    (B, A); `noise` is eps."""

    def act_scores(self, state, mu, sigma, mask, generator, noise=None):
        sigma = torch.nan_to_num(sigma, nan=0.0)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device)
        return state, masked_argmax(mu + sigma * noise, mask)


def _remainder_to_greedy(p, greedy):
    """Zero the greedy arms' p, give them what the others leave of 1, split
    evenly among ties, and normalise."""
    p = torch.where(greedy, 0.0, p)
    p_greedy = torch.clamp(1.0 - p.sum(-1, keepdim=True), min=0.0)
    n_greedy = greedy.sum(-1, keepdim=True)
    p = torch.where(greedy, p_greedy / torch.clamp(n_greedy, min=1), p)
    return p / p.sum(-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class SquareCBExploration(BanditExplorationModule):
    """Inverse-gap weighting: p_a = 1 / (A + gamma * (max mu - mu_a)) for the
    arms below the maximum, the remainder to the greedy arm(s); an index is
    drawn from p as a categorical over log(max(p, 1e-20)), the argmax of the
    logits plus Gumbel noise. `noise`, when given, is that noise (B, A)."""

    gamma: float = 10.0
    clamp_min: Optional[float] = None
    clamp_max: Optional[float] = None

    def _probabilities(self, mu, mask):
        if self.clamp_min is not None or self.clamp_max is not None:
            mu = torch.clamp(mu, min=self.clamp_min, max=self.clamp_max)
        masked_mu = torch.where(mask, mu, float("-inf")) if mask is not None else mu
        best = masked_mu.max(-1, keepdim=True).values
        p = 1.0 / (mu.shape[-1] + self.gamma * (best - mu))
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        return _remainder_to_greedy(p, masked_mu == best)

    def act_scores(self, state, mu, sigma, mask, generator, noise=None):
        logits = torch.log(torch.clamp(self._probabilities(mu, mask), min=1e-20))
        if noise is None:
            noise = gumbel(logits.shape, logits, generator)
        return state, torch.argmax(logits + noise, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FastCBExploration(SquareCBExploration):
    """FastCB: SquareCB with the gap relative to max(max mu, 1e-6)."""

    def _probabilities(self, mu, mask):
        masked_mu = torch.where(mask, mu, float("-inf")) if mask is not None else mu
        best = masked_mu.max(-1, keepdim=True).values
        gap = (best - mu) / torch.clamp(best, min=1e-6)
        p = 1.0 / (mu.shape[-1] + self.gamma * gap)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        return _remainder_to_greedy(p, masked_mu == best)
