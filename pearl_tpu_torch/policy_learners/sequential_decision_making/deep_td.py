"""Deep TD-learning family: DQN, Double DQN and deep SARSA, with the CQL
flag (port of `pearl_tpu/policy_learners/sequential_decision_making/deep_td.py`).

Semantics kept from the reference:
- Bellman target r + gamma * (1 - terminated) * next_values; weighted MSE
  loss; optional CQL penalty `conservative_alpha * mean(logsumexp_a Q(s, a)
  - Q(s, a_taken))` when `is_conservative`.
- AdamW (lr 1e-3, weight decay 0.01, b1 0.9, b2 0.999, eps 1e-8 outside the
  square root): torch's AdamW is the same decoupled update as optax.adamw.
- Target network soft-updated every `target_update_freq` learn steps, counted
  on the post-increment step, with `soft_update_tau`.
- The reported "loss" is the mean |TD error|, not the optimized MSE.
- Unavailable next actions are masked to -inf before the max.

- `act_dtype` (e.g. "bfloat16"): the acting forward runs on params and inputs
  cast to that dtype and its scores return as float32; learning stays float32.

Differences by design: the online params and the target are two independent
`nn.Module`s updated in place (the reference starts with `target_params =
params`, harmless for immutable arrays, an aliasing bug for in-place torch
updates), the learn-step counter is a host integer, and the `act_dtype` cast
of the params is a copy kept in the state and recast by `_act_module` only
when the params were written since the last cast (the reference casts every
parameter on every act step; the copy holds the same values for fewer
launches). A `tiebreaking` strategy other than NO draws its ties from a
second device generator in the state, `tie_generator`, seeded at `init` after
the weights from the init generator: configuring it leaves the weights and
the exploration stream as they were (the reference draws ties from a
`fold_in` of the act key to the same end).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from pearl_tpu_torch.action_representation_modules import (
    ActionRepresentationModule,
    OneHotActionRepresentation,
)
from pearl_tpu_torch.neural_networks.common import select_index_last
from pearl_tpu_torch.neural_networks.q_value_networks import VanillaQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    EGreedyExploration,
    ExplorationModule,
    masked_argmax,
)
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice, PolicyLearner
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import soft_update, synced_cast


@dataclasses.dataclass
class DeepTDState:
    params: nn.Module
    target_params: nn.Module
    summarizer_params: Any
    optimizer: torch.optim.Optimizer
    explore_state: Any
    step: int  # learn_batch counter
    action_elements: torch.Tensor  # (A, a) on the device
    action_reps: torch.Tensor  # (A, r) represented candidates on the device
    # `params` cast to the learner's `act_dtype`; None when `act_dtype` is
    # unset (acting then reads `params`). Read it through the learner's
    # `_act_module`, which recasts it when `params` changed.
    act_params: Optional[nn.Module] = None
    # Draws of the greedy index's tie-breaking; None under NO_TIEBREAKING.
    tie_generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DeepTDLearning(PolicyLearner):
    """Shared base of the TD learners."""

    q_network: Any = VanillaQValueNetwork()
    exploration: ExplorationModule = EGreedyExploration(epsilon=0.05)
    action_representation: ActionRepresentationModule = OneHotActionRepresentation()
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    discount_factor: float = 0.99
    training_rounds: int = 10
    batch_size: int = 128
    target_update_freq: int = 10
    soft_update_tau: float = 0.75
    is_conservative: bool = False
    conservative_alpha: float = 2.0
    act_dtype: Optional[str] = None

    def optimizer(self, params: nn.Module) -> torch.optim.Optimizer:
        return torch.optim.AdamW(
            params.parameters(),
            lr=self.learning_rate,
            betas=(0.9, 0.999),
            eps=1e-8,
            weight_decay=self.weight_decay,
        )

    def init(self, generator, observation_dim: int, action_space, num_envs: int, device):
        subj_dim, rep_dim, num_actions = self.dims(observation_dim, action_space)
        params = self.q_network.init(generator, subj_dim, rep_dim, num_actions).to(device)
        target = copy.deepcopy(params).requires_grad_(False)
        act_params = None
        if self.act_dtype is not None:
            act_params = copy.deepcopy(params).requires_grad_(False).to(self._act_dtype())
        summ_params = self.history_summarizer.init_params(generator, observation_dim, rep_dim)
        elements, reps = self.action_tensors(device)
        tie_generator = None
        if self.breaks_ties:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            tie_generator = torch.Generator(device=device).manual_seed(seed)
        return DeepTDState(
            params=params,
            target_params=target,
            summarizer_params=summ_params,
            optimizer=self.optimizer(params),
            explore_state=self.exploration.init(num_envs),
            step=0,
            action_elements=elements,
            action_reps=reps,
            act_params=act_params,
            tie_generator=tie_generator,
        )

    def _act_dtype(self) -> torch.dtype:
        dtype = getattr(torch, str(self.act_dtype), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"act_dtype {self.act_dtype!r} is not a torch dtype name")
        return dtype

    @staticmethod
    def _act_module(state: DeepTDState) -> nn.Module:
        """`state.act_params`, recast from `state.params` if those were
        written since the last cast (`utils.pytree.synced_cast`)."""
        return synced_cast(state.act_params, state.params)

    @staticmethod
    def _candidates(state: DeepTDState, batch_size: int) -> torch.Tensor:
        reps = state.action_reps
        return reps[None].expand((batch_size,) + tuple(reps.shape))

    # --- acting ------------------------------------------------------------
    def _act_inputs(self, state, subjective_state):
        """(params, subjective state, candidates) of the acting forward. Under
        `act_dtype`: the cast params and inputs cast to match (a
        `FrameRingView` casts its ring). Every scoring path goes through here,
        so `act_dtype` is never silently ignored."""
        candidates = self._candidates(state, subjective_state.shape[0])
        if state.act_params is None:
            return state.params, subjective_state, candidates
        dtype = self._act_dtype()
        subjective_state = (
            subjective_state.to(dtype)
            if isinstance(subjective_state, torch.Tensor)
            else subjective_state.astype(dtype)
        )
        return self._act_module(state), subjective_state, candidates.to(dtype)

    def _scores(self, state, subjective_state, mask) -> torch.Tensor:
        """Action scores for greedy selection and exploration, float32."""
        params, subjective_state, candidates = self._act_inputs(state, subjective_state)
        q = self.q_network.q_all(params, subjective_state, candidates, mask)
        return q.to(torch.float32)

    @torch.no_grad()
    def act(self, state, subjective_state, mask, generator, exploit: bool = False):
        scores = self._scores(state, subjective_state, mask)
        exploit_index = self.greedy_index(scores, mask, state.tie_generator)
        if exploit:
            index, explore_state = exploit_index, state.explore_state
        else:
            explore_state, index = self.exploration.act(
                state.explore_state, scores, exploit_index, mask, generator
            )
        action = state.action_elements[index.long()]
        return (
            dataclasses.replace(state, explore_state=explore_state),
            ActionChoice(action=action, index=index),
        )

    # --- learning ----------------------------------------------------------
    def _next_state_values(self, params, target_params, summ_params, batch, state):
        """DQN: max over target-net Q of the next available actions."""
        next_subj = self.history_summarizer.forward(summ_params, batch.next_state)
        candidates = self._candidates(state, next_subj.shape[0])
        q_next = self.q_network.q_all(
            target_params, next_subj, candidates, batch.next_available_mask
        )
        if batch.next_available_mask is not None:
            q_next = torch.where(batch.next_available_mask, q_next, float("-inf"))
        return q_next.max(dim=-1).values

    def td_loss(self, state: DeepTDState, batch: TransitionBatch):
        """(optimized loss, aux metrics) on one batch, with grad to the online
        params."""
        subj = self.history_summarizer.forward(state.summarizer_params, batch.state)
        candidates = self._candidates(state, subj.shape[0])
        q_all = self.q_network.q_all(state.params, subj, candidates, batch.curr_available_mask)
        q_sa = select_index_last(q_all, batch.action_index)
        with torch.no_grad():
            next_v = self._next_state_values(
                state.params, state.target_params, state.summarizer_params, batch, state
            )
        not_term = 1.0 - batch.terminated.to(torch.float32)
        target = batch.reward + self.discount_factor * not_term * next_v
        td_error = q_sa - target
        w = batch.weight if batch.weight is not None else torch.ones_like(td_error)
        loss = (w * td_error**2).sum() / torch.clamp(w.sum(), min=1e-8)
        if self.is_conservative:
            masked_q = (
                torch.where(batch.curr_available_mask, q_all, float("-inf"))
                if batch.curr_available_mask is not None
                else q_all
            )
            cql = (torch.logsumexp(masked_q, dim=-1) - q_sa).mean()
            loss = loss + self.conservative_alpha * cql
        abs_td = td_error.detach().abs()
        return loss, {"loss": abs_td.mean(), "per_sample_td": abs_td}

    def learn_batch(self, state: DeepTDState, batch: TransitionBatch):
        loss, aux = self.td_loss(state, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        step = state.step + 1
        if step % self.target_update_freq == 0:
            soft_update(state.target_params, state.params, self.soft_update_tau)
        return dataclasses.replace(state, step=step), aux

    def episode_reset(self, state, done_mask, generator):
        return dataclasses.replace(
            state,
            explore_state=self.exploration.reset(state.explore_state, done_mask, generator),
        )


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DeepQLearning(DeepTDLearning):
    """Vanilla DQN."""


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DoubleDQN(DeepTDLearning):
    """Double DQN: argmax under the online net, value under the target net."""

    def _next_state_values(self, params, target_params, summ_params, batch, state):
        next_subj = self.history_summarizer.forward(summ_params, batch.next_state)
        candidates = self._candidates(state, next_subj.shape[0])
        q_online = self.q_network.q_all(params, next_subj, candidates, batch.next_available_mask)
        best = masked_argmax(q_online, batch.next_available_mask)
        q_target = self.q_network.q_all(
            target_params, next_subj, candidates, batch.next_available_mask
        )
        return select_index_last(q_target, best)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DeepSARSA(DeepTDLearning):
    """On-policy deep SARSA: the next value is the target net's Q of the
    action actually committed next, so it needs a `SARSAReplayBuffer`, which
    stores `next_action_index`."""

    @property
    def on_policy(self) -> bool:
        return True

    def _next_state_values(self, params, target_params, summ_params, batch, state):
        next_subj = self.history_summarizer.forward(summ_params, batch.next_state)
        candidates = self._candidates(state, next_subj.shape[0])
        q_next = self.q_network.q_all(
            target_params, next_subj, candidates, batch.next_available_mask
        )
        return select_index_last(q_next, batch.next_action_index)
