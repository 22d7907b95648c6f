"""Reward-constrained safety, RCPO (port of
`pearl_tpu/safety_modules/reward_constrained.py`).

Semantics kept from the reference:
- A twin cost critic Q_c is trained on `batch.cost` toward the cost-Bellman
  target cost + gamma_c * (1 - terminated) * min(Q_c1', Q_c2') at the next
  state and the current policy's next action, by AdamW (weight decay 0.01)
  on the mean of the two members' squared errors; its target copy follows
  by a soft update with `critic_soft_update_tau`.
- The Lagrange multiplier follows lambda <- clip(lambda + lr_lambda *
  (E[max(Q_c1, Q_c2)] * (1 - gamma_c) - constraint), 0, upper bound), the
  max taken by the updated critic at the batch states and the current
  policy's actions there.
- The policy learner sees reward - lambda * cost through the agent's
  `batch_transform` hook; `learn` (online, a batch sampled from replay) and
  `learn_batch` (offline, the batch given) then update critic and lambda
  under the learner's new state.
- A continuous learner's actions come from its actor's `sample_action`; a
  discrete one feeds the critic one-hot candidates, its draw a categorical
  over log(clip(p, 1e-8, 1)).
- The cost critic is sized from `observation_dim`, as the reference sizes it,
  and fed subjective states: with a summarizer whose summary has another
  width the reference fails at the first learn, and so does the port, with
  a message that says why (ROADMAP, Queue C).

The reference keeps a key in the state; the port keeps a device
`torch.Generator`, seeded at `init` from the init generator after the
critic's weights are drawn, so an offline `learn_batch` needs no generator.
lambda is a 0-dim tensor on the device, and an update makes no host sync.
`_update_from_batch` takes pre-drawn `noise` {"next", "lambda"} for its two
policy draws (standard normal (B, d) on a continuous space, Gumbel (B, A) on
a discrete one), so tests hand both packages the same numbers.

`pmean_axis` (a `MeshAxis`, set by `online_learning(mesh=...)`): the cost
critic's gradients and the cost estimate that drives lambda are averaged over
the mesh axis, so the safety replicas stay bit-identical.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.twin_critic import TwinCritic
from pearl_tpu_torch.policy_learners.exploration_modules.common import gumbel
from pearl_tpu_torch.safety_modules.identity import SafetyModule
from pearl_tpu_torch.utils.collectives import check_pmean_axis, pmean, pmean_grads
from pearl_tpu_torch.utils.pytree import soft_update


@dataclasses.dataclass
class RCSafetyState:
    critic_params: nn.Module
    critic_target_params: nn.Module
    critic_opt: torch.optim.Optimizer
    lagrangian: torch.Tensor  # () float32 on the device
    generator: torch.Generator  # the policy draws, on the device
    observation_dim: int  # the critic's state width


@dataclasses.dataclass(frozen=True, eq=False)
class RCSafetyModuleCostCriticContinuousAction(SafetyModule):
    constraint_value: float = 0.1
    lambda_constraint_ub_value: float = 20.0
    lr_lambda: float = 1e-2
    cost_discount_factor: float = 0.5
    critic_learning_rate: float = 1e-3
    critic_soft_update_tau: float = 0.005
    critic_hidden_dims: tuple = (64, 64)
    batch_size: int = 256
    pmean_axis: Any = None  # a `MeshAxis` to average over, or None

    def __post_init__(self):
        check_pmean_axis(self.pmean_axis)

    def _critic(self) -> TwinCritic:
        return TwinCritic(hidden_dims=tuple(self.critic_hidden_dims))

    def init(self, generator, observation_dim: int, action_space, num_envs: int, device=None):
        # A discrete learner's actions reach the critic one-hot.
        a_dim = action_space.action_dim if action_space.is_continuous else action_space.n
        params = self._critic().init(generator, observation_dim, a_dim).to(device)
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        return RCSafetyState(
            critic_params=params,
            critic_target_params=copy.deepcopy(params).requires_grad_(False),
            critic_opt=torch.optim.AdamW(
                params.parameters(), lr=self.critic_learning_rate, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=0.01,
            ),
            lagrangian=torch.zeros((), device=device),
            generator=torch.Generator(device=device).manual_seed(seed),
            observation_dim=observation_dim,
        )

    def batch_transform(self, state: RCSafetyState):
        lam = state.lagrangian

        def transform(batch):
            if batch.cost is None:
                return batch
            return dataclasses.replace(batch, reward=batch.reward - lam * batch.cost)

        return transform

    def _policy_action(self, learner, learner_state, subj, generator, mask, noise=None):
        """An action of the learner's current policy at `subj`: the actor's
        draw on a continuous space; on a discrete one the one-hot candidate
        of a categorical draw over log(clip(p, 1e-8, 1)) (an argmax of the
        logits plus Gumbel noise)."""
        if learner.is_continuous:
            action, _ = learner.actor.sample_action(
                learner_state.actor_params, subj, generator,
                learner_state.low, learner_state.high, noise,
            )
            return action
        candidates = learner.represented_candidates(learner_state, subj.shape[0])
        probs = learner.actor.get_policy_distribution(
            learner_state.actor_params, subj, candidates, mask
        )
        logits = torch.log(torch.clamp(probs, 1e-8, 1.0))
        if noise is None:
            noise = gumbel(logits.shape, logits, generator)
        index = torch.argmax(logits + noise, dim=-1)
        return learner_state.action_reps[index]

    def _update_from_batch(
        self, state: RCSafetyState, batch, learner, learner_state,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """One cost-critic and lambda update from a batch."""
        if batch.cost is None:
            return state, {}
        noise = noise or {}
        critic, summ = self._critic(), learner.history_summarizer
        gen = state.generator
        with torch.no_grad():
            subj = summ.forward(learner_state.summarizer_params, batch.state)
            if subj.shape[-1] != state.observation_dim:
                raise ValueError(
                    f"the cost critic was sized for observation_dim={state.observation_dim} "
                    f"(as the reference sizes it) but the learner's summary has width "
                    f"{subj.shape[-1]}: a history summarizer that changes the width does "
                    "not work with this module (ROADMAP, Queue C)"
                )
            next_subj = summ.forward(learner_state.summarizer_params, batch.next_state)
            next_action = self._policy_action(
                learner, learner_state, next_subj, gen, batch.next_available_mask,
                noise.get("next"),
            )
            if learner.is_continuous:
                batch_action = batch.action
            else:
                batch_action = learner_state.action_reps[batch.action_index.long()]
            q1t, q2t = critic.q_both(state.critic_target_params, next_subj, next_action)
            not_done = 1.0 - batch.terminated.to(torch.float32)
            y = batch.cost + self.cost_discount_factor * not_done * torch.minimum(q1t, q2t)
        q1, q2 = critic.q_both(state.critic_params, subj, batch_action)
        loss = (torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)) / 2.0
        state.critic_opt.zero_grad(set_to_none=True)
        loss.backward()
        pmean_grads(state.critic_params.parameters(), self.pmean_axis)
        state.critic_opt.step()
        soft_update(state.critic_target_params, state.critic_params, self.critic_soft_update_tau)
        with torch.no_grad():
            a_pi = self._policy_action(
                learner, learner_state, subj, gen, batch.curr_available_mask,
                noise.get("lambda"),
            )
            q1, q2 = critic.q_both(state.critic_params, subj, a_pi)
            cost_q = torch.mean(torch.maximum(q1, q2))
            (cost_q,) = pmean([cost_q], self.pmean_axis)
            lam = torch.clamp(
                state.lagrangian
                + self.lr_lambda
                * (cost_q * (1.0 - self.cost_discount_factor) - self.constraint_value),
                0.0,
                self.lambda_constraint_ub_value,
            )
        return (
            dataclasses.replace(state, lagrangian=lam),
            {"cost_critic_loss": loss.detach(), "lambda": lam},
        )

    def learn(self, state, buffer, buffer_state, generator, learner, learner_state):
        batch = buffer.sample(buffer_state, generator, self.batch_size)
        return self._update_from_batch(state, batch, learner, learner_state)

    def learn_batch(self, state, batch, learner=None, learner_state=None):
        """Offline: critic and lambda from the given batch."""
        if learner is None or learner_state is None:
            return state, {}
        return self._update_from_batch(state, batch, learner, learner_state)
