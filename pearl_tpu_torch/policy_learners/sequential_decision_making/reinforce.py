"""REINFORCE with a critic baseline (port of
`pearl_tpu/policy_learners/sequential_decision_making/reinforce.py`).

Semantics kept from the reference:
- Discounted returns over the whole on-policy rollout, bootstrapped from the
  critic where an episode ends by truncation and at the rollout's last step.
- Loss -log pi(a|s) * (G - V(s)), the baseline V taken at the old critic
  without gradient; the critic regresses G. One step per learn, over all
  T * B rows.

The returns and the baseline run without autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from pearl_tpu_torch.neural_networks.value_networks import VanillaValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.ppo import (
    flat_rollout,
    log_prob_of,
    on_policy_step,
)


def discounted_returns(rewards, next_values, terminated, done, discount):
    """G_t = r_t + gamma (1 - term_t) * (V(s'_t) at an episode or rollout
    boundary, else G_{t+1}); (T, B) in, (T, B) out. A loop over reversed T,
    in the reference's order of operations."""
    not_term = 1.0 - terminated.to(torch.float32)
    done_f = done.to(torch.float32)
    # The final transition of the rollout is also a boundary: bootstrap there.
    done_f[-1] = 1.0
    returns = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        d = done_f[t]
        bootstrap = d * next_values[t] + (1.0 - d) * carry
        carry = rewards[t] + discount * not_term[t] * bootstrap
        returns[t] = carry
    return returns


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class REINFORCE(ActorCriticBase):
    critic_network: Any = VanillaValueNetwork()
    training_rounds: int = 1
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
        if indices is not None:
            raise ValueError("REINFORCE learns from the whole rollout; it takes no indices")
        traj, flat = flat_rollout(buffer, buffer_state, batch_transform)
        T, B = traj.reward.shape
        summ = self.history_summarizer
        critic = self.critic_network
        with torch.no_grad():
            next_subj = summ.forward(state.summarizer_params, flat["next_stored"])
            next_values = critic.value(state.critic_params, next_subj).reshape(T, B)
            returns = discounted_returns(
                traj.reward, next_values, traj.terminated, traj.terminated | traj.truncated,
                self.discount_factor,
            ).reshape(T * B)
            subj = summ.forward(state.summarizer_params, flat["stored"])
            baseline = critic.value(state.critic_params, subj)
        probs = self.actor.get_policy_distribution(
            state.actor_params, summ.forward(state.summarizer_params, flat["stored"]),
            self.represented_candidates(state, T * B), flat["mask"],
        )
        logp = log_prob_of(probs, flat["action_index"])
        a_loss = -torch.mean(logp * (returns - baseline))
        v = critic.value(state.critic_params, summ.forward(state.summarizer_params, flat["stored"]))
        c_loss = torch.mean((v - returns) ** 2)
        state, metrics = on_policy_step(state, a_loss, c_loss, self.pmean_axis)
        return state, buffer_state, metrics

    def learn_batch(self, state, batch):
        raise NotImplementedError("REINFORCE learns from whole rollouts via learn()")
