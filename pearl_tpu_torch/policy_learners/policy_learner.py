"""Policy learner base (port of `pearl_tpu/policy_learners/policy_learner.py`).

A learner is a frozen-dataclass config owning its exploration module, action
representation module and history summarization module. Contract:

    init(generator, observation_dim, action_space, num_envs, device) -> state
    act(state, subjective_state, mask, generator, exploit) -> (state', ActionChoice)
    learn_batch(state, batch) -> (state', metrics)
    learn(state, buffer, buffer_state, generator, indices=None, batch_transform=None)
        -> (state', buffer_state', metrics)
    episode_reset(state, done_mask, generator) -> state'

`generator` in `init` is a CPU generator for the weight init; the others
live on the device. `learn` is the reference's `training_rounds x {sample ->
preprocess_batch -> learn_batch}` loop as a Python loop.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from pearl_tpu_torch.action_representation_modules import (
    ActionRepresentationModule,
    IdentityActionRepresentation,
)
from pearl_tpu_torch.history_summarization_modules import (
    HistorySummarizationModule,
    IdentityHistorySummarization,
)
from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    TiebreakingStrategy,
    masked_argmax,
    model_action_index,
)
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils import profiling


@dataclasses.dataclass
class ActionChoice:
    """The output of `act`: the raw action vector for the env/replay plus the
    action index for discrete spaces."""

    action: torch.Tensor  # (B, a)
    index: torch.Tensor  # (B,) i32


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class PolicyLearner(abc.ABC):
    training_rounds: int = 100
    batch_size: int = 1
    action_representation: ActionRepresentationModule = IdentityActionRepresentation()
    history_summarizer: HistorySummarizationModule = IdentityHistorySummarization()
    # Bound by the agent via `dataclasses.replace` (`PearlAgent.for_env`).
    action_space: Any = None
    # How the greedy argmax of `act` breaks ties (`TiebreakingStrategy`);
    # None is NO_TIEBREAKING, which draws nothing.
    tiebreaking: Any = None

    def bind(self, action_space) -> "PolicyLearner":
        return dataclasses.replace(self, action_space=action_space)

    @property
    def on_policy(self) -> bool:
        return False

    @property
    def is_distributional(self) -> bool:
        return False

    def resolved_action_representation(self, action_space) -> ActionRepresentationModule:
        if action_space is None:
            raise ValueError(
                "This policy learner is not bound to an action space. Call "
                "`agent.for_env(env)` (or `learner.bind(action_space)`) before "
                "init/act/learn — drivers like `online_learning` do this "
                "automatically."
            )
        num_actions = getattr(action_space, "n", 0)
        return self.action_representation.resolve(action_space.action_dim, num_actions)

    def dims(self, observation_dim: int, action_space) -> Tuple[int, int, int]:
        """(subjective_dim, action_repr_dim, num_actions)."""
        num_actions = getattr(action_space, "n", 0)
        rep = self.resolved_action_representation(action_space)
        rep_dim = rep.representation_dim(action_space.action_dim, num_actions)
        subj_dim = self.history_summarizer.subjective_dim(observation_dim, rep_dim)
        return subj_dim, rep_dim, num_actions

    def action_tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(elements (A, a), represented candidates (A, r)) on `device`, made
        once at init so acting never copies from the host."""
        rep = self.resolved_action_representation(self.action_space)
        elements = self.action_space.elements.to(device)
        return elements, rep.apply(elements)

    @property
    def breaks_ties(self) -> bool:
        return self.tiebreaking not in (None, TiebreakingStrategy.NO_TIEBREAKING)

    def greedy_index(self, scores, mask, generator: Optional[torch.Generator] = None):
        """The greedy action index under `tiebreaking`. The default is a
        masked argmax (the first index wins a tie) and draws nothing; the
        other strategies draw from `generator`, which the caller keeps apart
        from its exploration stream (the reference draws them from a
        `fold_in` of the act key)."""
        if not self.breaks_ties:
            return masked_argmax(scores, mask)
        return model_action_index(scores, mask, self.tiebreaking, generator)

    @abc.abstractmethod
    def init(self, generator, observation_dim: int, action_space, num_envs: int, device):
        ...

    @abc.abstractmethod
    def act(self, state, subjective_state, mask, generator, exploit: bool = False):
        ...

    @abc.abstractmethod
    def learn_batch(self, state, batch: TransitionBatch):
        ...

    def preprocess_batch(self, state, batch: TransitionBatch) -> TransitionBatch:
        """The hook each sampled batch passes through before `learn_batch`
        (in `learn`, and in `PearlAgent.learn_batch`): the identity, as in the
        reference, where no learner overrides it."""
        return batch

    def learn(
        self,
        state,
        buffer,
        buffer_state,
        generator: Optional[torch.Generator],
        indices: Optional[torch.Tensor] = None,
        batch_transform: Optional[Callable[[TransitionBatch], TransitionBatch]] = None,
    ):
        """training_rounds x (sample -> batch_transform -> preprocess_batch ->
        learn_batch). `indices` (training_rounds, batch_size) replaces the
        sampled indices. `batch_transform` is the safety module's hook (the
        reward-constrained module's reward - lambda * cost). A buffer
        with `update_priorities` (prioritized replay) gets each round's
        per-sample |TD| written back at that round's indices when the learner
        reports `per_sample_td`. Metrics are averaged over rounds and stay on
        the device."""
        prioritized = hasattr(buffer, "update_priorities")
        rounds = []
        for r in range(self.training_rounds):
            idx = None if indices is None else indices[r]
            with profiling.span("replay.sample"):
                profiling.count("replay.rows_sampled", self.batch_size)
                if prioritized:
                    batch, idx = buffer.sample_with_indices(
                        buffer_state, generator, self.batch_size, indices=idx
                    )
                else:
                    batch = buffer.sample(buffer_state, generator, self.batch_size, indices=idx)
            with profiling.span("learner.update"):
                if batch_transform is not None:
                    batch = batch_transform(batch)
                batch = self.preprocess_batch(state, batch)
                state, metrics = self.learn_batch(state, batch)
            if prioritized and "per_sample_td" in metrics:
                buffer_state = buffer.update_priorities(
                    buffer_state, idx, metrics["per_sample_td"]
                )
            rounds.append({k: v for k, v in metrics.items() if k != "per_sample_td"})
        metrics = {k: torch.stack([m[k] for m in rounds]).mean() for k in rounds[0]}
        return state, buffer_state, metrics

    def episode_reset(self, state, done_mask, generator):
        return state
