"""Proximal Policy Optimization (port of
`pearl_tpu/policy_learners/sequential_decision_making/ppo.py`).

Semantics kept from the reference:
- GAE with trace decay lambda, and lambda-returns, over the whole rollout:
  one walk backwards over the (T, B) trajectory view.
- Advantages normalised by their mean and population standard deviation.
- The action probabilities are FROZEN before the update rounds, the ratio's
  denominator.
- Clipped-ratio surrogate loss with an entropy bonus; the critic regresses
  the lambda-return. Each round is one minibatch of `batch_size` rows drawn
  uniformly, with replacement, from the T * B rows.
- On-policy: the agent clears the buffer after every learn.

The full-rollout forwards (values over `state` and `next_state`, the frozen
log-probs) run without autograd: over T * B rows (1,048,576 at 131072 envs
and a rollout of 8) a graph kept alive through the rounds would cost more
memory than the rollout itself. `learn` takes `indices` (training_rounds,
batch_size), the rows of each round's minibatch, in place of its draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from pearl_tpu_torch.neural_networks.common import select_index_last
from pearl_tpu_torch.neural_networks.value_networks import VanillaValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
    ActorCriticState,
    _parameters,
    apply_grads,
)
from pearl_tpu_torch.replay_buffers.on_policy import OnPolicyReplayBuffer
from pearl_tpu_torch.utils.collectives import pmean


def gae_lambda_returns(rewards, values, next_values, terminated, done, discount, lam):
    """(T, B) inputs -> (advantages, lambda_returns), both (T, B).

    delta_t = r_t + gamma (1 - term_t) V(s'_t) - V(s_t)
    A_t = delta_t + gamma * lam * (1 - done_t) * A_{t+1}
    done (terminated or truncated) cuts the trace; terminated alone zeroes the
    bootstrap value. A loop over reversed T (8 steps at the bench width), in
    the reference's order of operations."""
    not_term = 1.0 - terminated.to(torch.float32)
    not_done = 1.0 - done.to(torch.float32)
    delta = rewards + discount * not_term * next_values - values
    advantages = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for t in reversed(range(delta.shape[0])):
        carry = delta[t] + discount * lam * not_done[t] * carry
        advantages[t] = carry
    return advantages, advantages + values


def log_prob_of(probs: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """log(clip(probs[i, index[i]], 1e-8, 1)), the selection a one-hot sum."""
    return torch.log(torch.clamp(select_index_last(probs, index), 1e-8, 1.0))


def on_policy_step(state: ActorCriticState, a_loss, c_loss, pmean_axis):
    """One step of actor, critic and summarizer: the actor's gradient to the
    actor, the critic's to the critic, their sum to the summarizer (which
    takes no step without parameters); the three averaged over
    `pmean_axis` first, in one all-reduce. Returns (state',
    metrics)."""
    actor_list = list(state.actor_params.parameters())
    critic_list = list(state.critic_params.parameters())
    summ_list = _parameters(state.summarizer_params)
    na, nc = len(actor_list), len(critic_list)
    a_grads = torch.autograd.grad(a_loss, actor_list + summ_list)
    c_grads = torch.autograd.grad(c_loss, critic_list + summ_list)
    summ_grads = [a + c for a, c in zip(a_grads[na:], c_grads[nc:])]
    synced = pmean([*a_grads[:na], *c_grads[:nc], *summ_grads], pmean_axis)
    apply_grads(state.actor_opt, actor_list, synced[:na])
    apply_grads(state.critic_opt, critic_list, synced[na:na + nc])
    if state.summ_opt is not None:
        apply_grads(state.summ_opt, summ_list, synced[na + nc:])
    metrics = {"actor_loss": a_loss.detach(), "critic_loss": c_loss.detach()}
    return dataclasses.replace(state, step=state.step + 1), metrics


def flat_rollout(buffer, buffer_state, batch_transform=None):
    """The rollout as (T, B) views, and its stored states, next states,
    action indices and masks flattened to T * B rows. `batch_transform` (the
    safety module's reward shaping) applies to the (T, B) trajectory, before
    any return is computed from it."""
    if not isinstance(buffer, OnPolicyReplayBuffer):
        raise TypeError(
            "on-policy learners need an OnPolicyReplayBuffer sized rollout_steps * num_envs, "
            f"got {type(buffer).__name__}"
        )
    traj = buffer.trajectory_view(buffer_state)
    if batch_transform is not None:
        traj = batch_transform(traj)
    T, B = traj.reward.shape
    mask = traj.curr_available_mask
    flat = {
        "stored": traj.state.reshape(T * B, -1),
        "next_stored": traj.next_state.reshape(T * B, -1),
        "action_index": traj.action_index.reshape(T * B),
        "mask": mask.reshape(T * B, -1) if mask is not None else None,
    }
    return traj, flat


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class ProximalPolicyOptimization(ActorCriticBase):
    critic_network: Any = VanillaValueNetwork()
    epsilon: float = 0.2  # clip range
    trace_decay_param: float = 0.95  # GAE lambda
    entropy_bonus_scaling: float = 0.01
    normalize_advantages: bool = True
    training_rounds: int = 10
    batch_size: int = 256

    @property
    def on_policy(self) -> bool:
        return True

    @property
    def use_critic_target(self) -> bool:
        return False

    def learn(
        self, state, buffer, buffer_state, generator: Optional[torch.Generator],
        indices: Optional[torch.Tensor] = None, batch_transform=None,
    ):
        traj, flat = flat_rollout(buffer, buffer_state, batch_transform)
        T, B = traj.reward.shape
        summ = self.history_summarizer
        with torch.no_grad():
            subj = summ.forward(state.summarizer_params, flat["stored"])
            next_subj = summ.forward(state.summarizer_params, flat["next_stored"])
            values = self.critic_network.value(state.critic_params, subj).reshape(T, B)
            next_values = self.critic_network.value(state.critic_params, next_subj).reshape(T, B)
            advantages, lam_returns = gae_lambda_returns(
                traj.reward, values, next_values, traj.terminated,
                traj.terminated | traj.truncated, self.discount_factor, self.trace_decay_param,
            )
            if self.normalize_advantages:
                # The population standard deviation, as jnp.std.
                advantages = (advantages - advantages.mean()) / (
                    advantages.std(correction=0) + 1e-8
                )
            # The frozen (pre-update) log-probs, the ratio's denominator.
            probs_old = self.actor.get_policy_distribution(
                state.actor_params, subj, self.represented_candidates(state, T * B), flat["mask"]
            )
            logp_old = log_prob_of(probs_old, flat["action_index"])
        data = {
            "stored": flat["stored"],
            "action_index": flat["action_index"],
            "advantage": advantages.reshape(T * B),
            "lam_return": lam_returns.reshape(T * B),
            "logp_old": logp_old,
            "mask": flat["mask"],
        }
        if indices is None:
            indices = torch.randint(
                0, T * B, (self.training_rounds, self.batch_size), generator=generator,
                device=traj.reward.device,
            )
        # Every round's rows in one gather per field.
        minibatches = {k: v[indices] if v is not None else None for k, v in data.items()}
        rounds = []
        for r in range(self.training_rounds):
            mb = {k: v[r] if v is not None else None for k, v in minibatches.items()}
            state, metrics = self._update_minibatch(state, mb)
            rounds.append(metrics)
        metrics = {k: torch.stack([m[k] for m in rounds]).mean() for k in rounds[0]}
        return state, buffer_state, metrics

    def _update_minibatch(self, state, mb):
        summ = self.history_summarizer
        candidates = self.represented_candidates(state, mb["stored"].shape[0])
        subj = summ.forward(state.summarizer_params, mb["stored"])
        probs = self.actor.get_policy_distribution(
            state.actor_params, subj, candidates, mb["mask"]
        )
        ratio = torch.exp(log_prob_of(probs, mb["action_index"]) - mb["logp_old"])
        surr1 = ratio * mb["advantage"]
        surr2 = torch.clamp(ratio, 1.0 - self.epsilon, 1.0 + self.epsilon) * mb["advantage"]
        entropy = -torch.sum(probs * torch.log(torch.clamp(probs, 1e-8, 1.0)), dim=-1)
        a_loss = -torch.mean(torch.minimum(surr1, surr2)) - self.entropy_bonus_scaling * torch.mean(
            entropy
        )
        v = self.critic_network.value(
            state.critic_params, summ.forward(state.summarizer_params, mb["stored"])
        )
        c_loss = torch.mean((v - mb["lam_return"]) ** 2)
        return on_policy_step(state, a_loss, c_loss, self.pmean_axis)

    def learn_batch(self, state, batch):
        raise NotImplementedError("PPO learns from whole rollouts via learn()")
