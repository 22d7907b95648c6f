"""Exploration modules (port of
`pearl_tpu/policy_learners/exploration_modules/common.py`: `masked_argmax`
and the tie-breaking strategies of the greedy index, `NoExploration`,
`EGreedyExploration`, `BoltzmannExploration`, `PropensityExploration`, the
`ExplorationModuleWrapper` base and `Warmup`, and, for continuous actions,
`NormalDistributionExploration`).

Protocol, batched over B envs:

    init(num_envs) -> ExploreState
    act(state, scores, exploit_index, mask, generator) -> (state', index (B,))
    reset(state, done_mask, generator) -> state'

A continuous-action module instead has

    act_continuous(state, exploit_action, low, high, generator, noise=None)
        -> (state', action (B, d))

The ε-greedy and `Warmup` step counters are host integers (they grow by B
per act, a number the host knows), so the schedules cost no device sync and,
unlike the reference's int32 counters, never wrap.

Every random draw has a seam for the tests (`noise=`, `perm=`, `draws=`,
`random_index=`): given the draw the JAX code makes from its key, the port
picks the same index.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch


class ExplorationModule:
    def init(self, num_envs: int):
        return ()

    def act(self, state, scores, exploit_index, mask, generator):
        raise NotImplementedError

    def reset(self, state, done_mask, generator):
        return state


def masked_argmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Row-wise argmax treating unavailable actions as -inf; the first index
    wins a tie."""
    if mask is not None:
        scores = torch.where(mask, scores, float("-inf"))
    return torch.argmax(scores, dim=-1).to(torch.int32)


class TiebreakingStrategy(enum.Enum):
    """How the greedy argmax breaks ties: the first index (NO), an
    independent random choice per row (PER_ROW), or one random column
    permutation shared by the whole batch (BATCH: columns tied on several
    rows resolve to the same index on each)."""

    NO_TIEBREAKING = 0
    PER_ROW_TIEBREAKING = 1
    BATCH_TIEBREAKING = 2


def masked_argmax_random_ties(
    scores: torch.Tensor,
    mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    epsilon: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Argmax with a uniform random choice among the tied scores of each row,
    those >= max - `epsilon`: the reference's categorical over 0 at the ties
    and -inf elsewhere, a Gumbel argmax. `noise`, when given, is that Gumbel
    noise (B, A)."""
    if mask is not None:
        scores = torch.where(mask, scores, float("-inf"))
    best = scores.max(dim=-1, keepdim=True).values
    if noise is None:
        noise = gumbel(scores.shape, scores, generator)
    tied = torch.where(scores >= best - epsilon, noise, float("-inf"))
    return torch.argmax(tied, dim=-1).to(torch.int32)


def masked_argmax_random_ties_batch(
    scores: torch.Tensor,
    mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Argmax under one random column permutation shared by all rows; the
    first permuted index wins a tie. `perm`, when given, is that
    permutation (A,)."""
    A = scores.shape[-1]
    if perm is None:
        perm = torch.randperm(A, generator=generator, device=scores.device)
    perm = perm.long()
    permuted = scores[..., perm]
    pmask = mask[..., perm] if mask is not None else None
    return perm[masked_argmax(permuted, pmask).long()].to(torch.int32)


def model_action_index(
    scores: torch.Tensor,
    mask: Optional[torch.Tensor],
    strategy: TiebreakingStrategy,
    generator: Optional[torch.Generator] = None,
    epsilon: float = 1e-6,
    noise: Optional[torch.Tensor] = None,
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The greedy index under a tie-breaking strategy. PER_ROW widens a tie
    to scores within `epsilon` (the reference's 1e-6) of the row's maximum."""
    if strategy == TiebreakingStrategy.PER_ROW_TIEBREAKING:
        return masked_argmax_random_ties(scores, mask, generator, epsilon, noise)
    if strategy == TiebreakingStrategy.BATCH_TIEBREAKING:
        return masked_argmax_random_ties_batch(scores, mask, generator, perm)
    return masked_argmax(scores, mask)


def uniform_index(noise: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """A uniformly drawn available action per row from iid uniform `noise`
    (B, A): the argmax of the noise over the available actions. This is the
    reference's `categorical` over equal logits (a Gumbel argmax; the Gumbel
    transform is monotone, so the argmax of the uniforms is the same draw)."""
    if mask is not None:
        noise = torch.where(mask, noise, -1.0)
    return torch.argmax(noise, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class NoExploration(ExplorationModule):
    """Greedy with respect to the scores."""

    def act(self, state, scores, exploit_index, mask, generator):
        return state, exploit_index


@dataclasses.dataclass(frozen=True)
class EGreedyExploration(ExplorationModule):
    """ε-greedy with an optional linear schedule: ε goes from `start_epsilon`
    to `end_epsilon` over `warmup_steps` env steps."""

    epsilon: float = 0.05
    start_epsilon: Optional[float] = None
    end_epsilon: Optional[float] = None
    warmup_steps: Optional[int] = None

    def init(self, num_envs: int) -> int:
        return 0  # env steps seen

    def current_epsilon(self, step: int) -> float:
        if self.start_epsilon is None or self.end_epsilon is None or not self.warmup_steps:
            return self.epsilon
        frac = min(max(step / self.warmup_steps, 0.0), 1.0)
        return self.start_epsilon + frac * (self.end_epsilon - self.start_epsilon)

    def act(
        self,
        state: int,
        scores: torch.Tensor,
        exploit_index: torch.Tensor,
        mask: Optional[torch.Tensor],
        generator: Optional[torch.Generator],
        draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """`draws` = (explore uniforms (B,), random indices (B,)) replaces
        the generator's draws — the tests hand both packages the same ones."""
        B, A = scores.shape
        if draws is None:
            u = torch.rand((B, 1 + A), generator=generator, device=scores.device)
            draws = (u[:, 0], uniform_index(u[:, 1:], mask))
        explore_u, random_index = draws
        # A Python float compares in the tensor's float32, as the reference's
        # f32 epsilon does, and needs no host-to-device copy.
        eps = self.current_epsilon(state)
        index = torch.where(explore_u < eps, random_index.to(torch.int32), exploit_index)
        return state + B, index


def gumbel(shape, like: torch.Tensor, generator) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)) of `shape` on `like`'s device, u
    uniform on [tiny, 1) from `generator`."""
    u = torch.rand(shape, generator=generator, device=like.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


@dataclasses.dataclass(frozen=True)
class PropensityExploration(ExplorationModule):
    """Sample from the policy's own probabilities (`scores` are
    probabilities): a categorical draw over log(max(p, 1e-20)), unavailable
    actions at -inf, taken as the argmax of logits plus Gumbel noise, as
    `jax.random.categorical` draws it. `noise`, when given, is that Gumbel
    noise (B, A)."""

    def act(self, state, scores, exploit_index, mask, generator, noise=None):
        logits = torch.log(torch.clamp(scores, min=1e-20))
        if mask is not None:
            logits = torch.where(mask, logits, float("-inf"))
        if noise is None:
            noise = gumbel(scores.shape, scores, generator)
        return state, torch.argmax(logits + noise, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BoltzmannExploration(ExplorationModule):
    """Sample from softmax(scores / temperature) over the available actions,
    as a Gumbel argmax. `noise`, when given, is the Gumbel noise (B, A)."""

    temperature: float = 1.0

    def act(self, state, scores, exploit_index, mask, generator, noise=None):
        logits = scores / self.temperature
        if mask is not None:
            logits = torch.where(mask, logits, float("-inf"))
        if noise is None:
            noise = gumbel(scores.shape, scores, generator)
        return state, torch.argmax(logits + noise, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class NormalDistributionExploration(ExplorationModule):
    """Gaussian noise on continuous actions, scaled by the action range and
    clipped to the box. `noise`, when given, is the standard normal draw
    (B, d) that `generator` would have made."""

    mean: float = 0.0
    std_dev: float = 0.1

    def act_continuous(self, state, exploit_action, low, high, generator, noise=None):
        if noise is None:
            noise = torch.randn(
                exploit_action.shape, generator=generator, device=exploit_action.device
            )
        scaled = (self.mean + self.std_dev * noise) * (high - low) / 2.0
        return state, torch.clamp(exploit_action + scaled, low, high)


@dataclasses.dataclass(frozen=True)
class ExplorationModuleWrapper(ExplorationModule):
    """Delegating base for exploration wrappers."""

    base: ExplorationModule = dataclasses.field(default_factory=NoExploration)

    def init(self, num_envs: int):
        return self.base.init(num_envs)

    def act(self, state, scores, exploit_index, mask, generator, **draws):
        return self.base.act(state, scores, exploit_index, mask, generator, **draws)

    def reset(self, state, done_mask, generator):
        return self.base.reset(state, done_mask, generator)


@dataclasses.dataclass(frozen=True)
class Warmup(ExplorationModule):
    """A uniformly random available action for the first `warmup_steps` env
    steps, then `base`'s. `base` acts on every step, as in the reference, so
    its own state (an ε schedule's count) advances through the warm-up. The
    count is a host integer; past the warm-up no uniform is drawn.
    `random_index` (B,), when given, is the warm-up draw; other keywords go to
    `base.act`."""

    base: ExplorationModule = dataclasses.field(default_factory=NoExploration)
    warmup_steps: int = 0

    def init(self, num_envs: int):
        return (0, self.base.init(num_envs))

    def act(self, state, scores, exploit_index, mask, generator, random_index=None, **draws):
        count, base_state = state
        base_state, index = self.base.act(
            base_state, scores, exploit_index, mask, generator, **draws
        )
        if count < self.warmup_steps:
            if random_index is None:
                u = torch.rand(scores.shape, generator=generator, device=scores.device)
                random_index = uniform_index(u, mask)
            index = random_index.to(torch.int32)
        return (count + scores.shape[0], base_state), index

    def reset(self, state, done_mask, generator):
        count, base_state = state
        return (count, self.base.reset(base_state, done_mask, generator))
