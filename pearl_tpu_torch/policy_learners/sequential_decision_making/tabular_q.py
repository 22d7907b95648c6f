"""Tabular Q-learning (port of
`pearl_tpu/policy_learners/sequential_decision_making/tabular_q.py`).

- `TabularQLearning`: a dense (num_states, num_actions) table on the device
  for finite state spaces; a state's index is the argmax of its observation
  (one-hot observations). Acting breaks the greedy argmax's ties at random
  per row unless `tiebreaking` says otherwise, so an all-zero table does not
  collapse onto action 0. `learn` runs one update over the whole storage,
  each row weighted by whether it was written; repeated (state, action)
  pairs in one update add up, as the reference's `.at[s, a].add` does
  (`index_put_` with `accumulate=True`).
- `DictTabularQLearning`: the host-side dict learner for arbitrary hashable
  observations, plain Python over numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    EGreedyExploration,
    masked_argmax,
    masked_argmax_random_ties,
)
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice, PolicyLearner


@dataclasses.dataclass
class TabularQState:
    q_table: torch.Tensor  # (num_states, num_actions)
    explore_state: Any
    action_elements: torch.Tensor  # (A, a) on the device
    summarizer_params: Any = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class TabularQLearning(PolicyLearner):
    """Dense-table Q-learning over one-hot observations."""

    num_states: int = 0  # 0: the observation dimension
    learning_rate: float = 0.01
    discount_factor: float = 0.9
    exploration: Any = EGreedyExploration(epsilon=0.1)
    training_rounds: int = 1
    batch_size: int = 1

    @property
    def on_policy(self) -> bool:
        # Learn from each transition once (the reference's default is a
        # one-row SingleTransitionReplayBuffer); the agent clears the buffer
        # after every learn.
        return True

    @staticmethod
    def _state_index(subjective_state: torch.Tensor) -> torch.Tensor:
        return torch.argmax(subjective_state, dim=-1)

    def init(self, generator, observation_dim: int, action_space, num_envs: int, device):
        n_states = self.num_states or observation_dim
        elements, _ = self.action_tensors(device)
        return TabularQState(
            q_table=torch.zeros((n_states, action_space.n), device=device),
            explore_state=self.exploration.init(num_envs, device),
            action_elements=elements,
        )

    @torch.no_grad()
    def act(self, state, subjective_state, mask, generator, exploit: bool = False,
            noise: Optional[torch.Tensor] = None):
        """`noise` (B, A), when given, is the Gumbel noise of the default
        random tie-break."""
        scores = state.q_table[self._state_index(subjective_state)]  # (B, A)
        if exploit:
            index, explore_state = masked_argmax(scores, mask), state.explore_state
        else:
            if self.tiebreaking is None:
                exploit_index = masked_argmax_random_ties(scores, mask, generator, noise=noise)
            else:
                exploit_index = self.greedy_index(scores, mask, generator)
            explore_state, index = self.exploration.act(
                state.explore_state, scores, exploit_index, mask, generator
            )
        action = state.action_elements[index.long()]
        return (
            dataclasses.replace(state, explore_state=explore_state),
            ActionChoice(action=action, index=index),
        )

    def learn_batch(self, state: TabularQState, batch):
        q = state.q_table
        s = self._state_index(batch.state)
        ns = self._state_index(batch.next_state)
        a = batch.action_index.long()
        not_term = 1.0 - batch.terminated.to(torch.float32)
        target = batch.reward + self.discount_factor * not_term * q[ns].max(dim=-1).values
        weight = batch.weight if batch.weight is not None else torch.ones_like(target)
        td = (target - q[s, a]) * weight
        q.index_put_((s, a), self.learning_rate * td, accumulate=True)
        return state, {"loss": td.abs().mean()}

    def learn(self, state, buffer, buffer_state, generator, indices=None, batch_transform=None):
        """One update over the whole storage, rows beyond `size` weighted 0;
        `batch_transform` (the safety module's hook) applies after the
        weighting, as in the reference."""
        batch = buffer_state.storage
        n = batch.batch_size
        valid = (torch.arange(n, device=batch.reward.device) < buffer_state.size).to(torch.float32)
        weight = batch.weight if batch.weight is not None else torch.ones_like(valid)
        batch = dataclasses.replace(batch, weight=weight * valid)
        if batch_transform is not None:
            batch = batch_transform(batch)
        state, metrics = self.learn_batch(state, batch)
        return state, buffer_state, metrics


class DictTabularQLearning:
    """The host-side dict learner: q_values[(state key, action)], one
    transition at a time, for arbitrary hashable observations. Not a device
    learner by design."""

    def __init__(
        self,
        learning_rate: float = 0.01,
        discount_factor: float = 0.9,
        exploration_rate: float = 0.01,
        seed: int = 0,
    ):
        self.learning_rate = learning_rate
        self.discount_factor = discount_factor
        self.exploration_rate = exploration_rate
        self.q_values: Dict[Tuple[Any, int], float] = {}
        self._rng = np.random.RandomState(seed)

    @staticmethod
    def _key(observation) -> Any:
        arr = np.asarray(observation)
        return arr.tobytes() if arr.ndim else arr.item()

    def act(self, observation, num_actions: int, exploit: bool = False) -> int:
        if not exploit and self._rng.rand() < self.exploration_rate:
            return int(self._rng.randint(num_actions))
        sk = self._key(observation)
        qs = np.array([self.q_values.get((sk, a), 0.0) for a in range(num_actions)])
        # Random tie-breaking: an empty table must not collapse onto action 0.
        best = np.flatnonzero(qs == qs.max())
        return int(best[0] if exploit else self._rng.choice(best))

    def learn(self, obs, action, reward, next_obs, terminated, num_actions: int):
        sk, nsk = self._key(obs), self._key(next_obs)
        next_v = 0.0
        if not terminated:
            next_v = max(self.q_values.get((nsk, a), 0.0) for a in range(num_actions))
        target = float(reward) + self.discount_factor * next_v
        old = self.q_values.get((sk, int(action)), 0.0)
        self.q_values[(sk, int(action))] = old + self.learning_rate * (target - old)
