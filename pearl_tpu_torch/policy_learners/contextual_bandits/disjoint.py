"""Disjoint bandit container (port of
`pearl_tpu/policy_learners/contextual_bandits/disjoint.py`).

One independent bandit learner per arm over STATE features. The arms' states
are ONE stack whose leading axis is the arm (`arm_learner.arms_init`), and
every arm updates on every step with the weights w * 1{action_index == arm}:
a zero-weight update leaves a closed-form arm's statistics as they were and
gives a neural arm the zero-gradient AdamW step the reference's null batch
does. So nothing is partitioned and the whole container updates in one
batched call (the Cholesky factors of a linear stack are one batched
`cholesky_ex`).

`arm_learner` is one learner (homogeneous arms, LinearBandit by default) or a
sequence of one learner per arm, grouped into runs of identical
configuration (`_groups`): each group is one stack, and the groups' columns
are put back in arm order through the inverse permutation. The groups' arm
indices and that permutation are device tensors made at `init`. 3-D per-arm
states (B, num_arms, f) give arm i the features state[:, i, :].
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from pearl_tpu_torch.policy_learners.contextual_bandits.base import (
    ContextualBanditBase,
    whole_storage_batch,
)
from pearl_tpu_torch.policy_learners.contextual_bandits.linear_bandit import LinearBandit


@dataclasses.dataclass
class DisjointBanditState:
    # The arms' stacked state; with heterogeneous arms a tuple, one stack a group.
    models: Any
    explore_state: Any
    action_elements: torch.Tensor  # (A, a) on the device
    action_reps: torch.Tensor  # (A, r) on the device
    arm_ids: torch.Tensor  # (A,) int64: 0 ... A-1 on the device
    # Heterogeneous arms only: each group's arm indices, and the position of
    # each arm in the groups' concatenated columns.
    group_arms: Optional[Tuple[torch.Tensor, ...]] = None
    inverse: Optional[torch.Tensor] = None
    summarizer_params: Any = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DisjointBanditContainer(ContextualBanditBase):
    arm_learner: Any = dataclasses.field(default_factory=LinearBandit)
    l2_reg_lambda: float = 1.0  # for default LinearBandit arms
    state_features_only: bool = True  # disjoint arms score the raw context

    def __post_init__(self):
        if isinstance(self.arm_learner, (list, tuple)):
            object.__setattr__(self, "arm_learner", tuple(self.arm_learner))
            return
        if (
            isinstance(self.arm_learner, LinearBandit)
            and self.l2_reg_lambda != 1.0
            and self.arm_learner.l2_reg_lambda == 1.0
        ):
            object.__setattr__(
                self,
                "arm_learner",
                dataclasses.replace(self.arm_learner, l2_reg_lambda=self.l2_reg_lambda),
            )

    @property
    def on_policy(self) -> bool:
        return True

    @property
    def _heterogeneous(self) -> bool:
        return isinstance(self.arm_learner, tuple)

    def _groups(self) -> List[Tuple[Any, List[int]]]:
        """The per-arm learners as runs of identical configuration:
        [(learner, [arm indices]), ...], in the order each first appears."""
        groups = []
        for i, learner in enumerate(self.arm_learner):
            key = (type(learner), repr(learner))
            for g_key, _, idxs in groups:
                if g_key == key:
                    idxs.append(i)
                    break
            else:
                groups.append((key, learner, [i]))
        return [(learner, idxs) for _, learner, idxs in groups]

    def init(self, generator, observation_dim, action_space, num_envs, device):
        f = self.feature_dim(observation_dim)
        num_arms = action_space.n
        fields = self._base_state_fields(num_envs, device)
        arm_ids = torch.arange(num_arms, device=device)
        if not self._heterogeneous:
            models = self.arm_learner.arms_init(generator, f, num_arms, device)
            return DisjointBanditState(models=models, arm_ids=arm_ids, **fields)
        if len(self.arm_learner) != num_arms:
            raise ValueError(
                f"{len(self.arm_learner)} arm learners for a {num_arms}-arm action space"
            )
        groups = self._groups()
        models = tuple(learner.arms_init(generator, f, len(idxs), device)
                       for learner, idxs in groups)
        order = [arm for _, idxs in groups for arm in idxs]
        inverse = [0] * num_arms
        for pos, arm in enumerate(order):
            inverse[arm] = pos
        return DisjointBanditState(
            models=models,
            arm_ids=arm_ids,
            group_arms=tuple(torch.tensor(idxs, device=device) for _, idxs in groups),
            inverse=torch.tensor(inverse, device=device),
            **fields,
        )

    def mu_sigma(self, state: DisjointBanditState, features):
        """features (B, A, f) -> (mu, sigma), each (B, A)."""
        per_arm = features.transpose(0, 1)  # (A, B, f)
        if not self._heterogeneous:
            mu, sigma = self.arm_learner.arms_mu_sigma(state.models, per_arm)
            return mu.T, sigma.T
        cols = [learner.arms_mu_sigma(models, per_arm[arms])
                for (learner, _), models, arms in zip(self._groups(), state.models,
                                                      state.group_arms)]
        mu = torch.cat([m for m, _ in cols])[state.inverse]
        sigma = torch.cat([s for _, s in cols])[state.inverse]
        return mu.T, sigma.T

    def learn_batch(self, state: DisjointBanditState, batch):
        """Every arm folds in the whole batch with the weights
        w * 1{action_index == arm}."""
        if batch.state.dim() == 3:
            feats = batch.state.transpose(0, 1)  # per-arm states (A, N, f)
        else:
            feats = self.batch_features(batch)  # (N, f), shared
        weight = batch.weight if batch.weight is not None else torch.ones_like(batch.reward)
        taken = batch.action_index[None, :].long() == state.arm_ids[:, None]
        arm_weight = weight[None, :] * taken.to(weight.dtype)  # (A, N)
        if not self._heterogeneous:
            models = self.arm_learner.arms_update(state.models, feats, batch.reward, arm_weight)
            return dataclasses.replace(state, models=models), {}
        models = tuple(
            learner.arms_update(group, feats[arms] if feats.dim() == 3 else feats,
                                batch.reward, arm_weight[arms])
            for (learner, _), group, arms in zip(self._groups(), state.models, state.group_arms)
        )
        return dataclasses.replace(state, models=models), {}

    def learn(self, state, buffer, buffer_state, generator, indices=None, batch_transform=None):
        """One `learn_batch` over the whole storage, unwritten slots weighted
        0 (`whole_storage_batch`)."""
        batch = whole_storage_batch(buffer_state, indices, batch_transform)
        state, metrics = self.learn_batch(state, batch)
        return state, buffer_state, metrics


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class DisjointLinearBandit(DisjointBanditContainer):
    """The reference's deprecated name for the container of LinearBandit arms."""
