"""Quantile-regression DQN (port of
`pearl_tpu/policy_learners/sequential_decision_making/qr_dqn.py`).

- Acting scores the actions with the risk metric of `safety` applied to the
  quantile distribution.
- The QR loss: pairwise u_ij = T theta_j(s', a*) - theta_i(s, a), an
  elementwise Huber (kappa 1) weighted by |tau_hat_i - 1{u < 0}|, summed
  over the predicted quantiles i and averaged over the target quantiles j
  and the batch.
- The greedy next action a* is taken under the risk metric on the target
  network.
- The reported "loss" and `per_sample_td` are |mean(target) - mean(theta)|.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pearl_tpu_torch.neural_networks.q_value_networks import QuantileQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules.common import masked_argmax
from pearl_tpu_torch.policy_learners.sequential_decision_making.deep_td import (
    DeepTDLearning,
    DeepTDState,
)
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.safety_modules.risk_sensitive import (
    RiskNeutralSafetyModule,
    RiskSensitiveSafetyModule,
)


def _huber(u: torch.Tensor, kappa: float = 1.0) -> torch.Tensor:
    absu = u.abs()
    return torch.where(absu <= kappa, 0.5 * u**2, kappa * (absu - 0.5 * kappa))


def _take_action(quantiles: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """quantiles[b, index[b], :]: (B, A, N), (B,) -> (B, N)."""
    idx = index.long()[:, None, None].expand(-1, 1, quantiles.shape[-1])
    return torch.gather(quantiles, 1, idx)[:, 0, :]


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class QuantileRegressionDeepQLearning(DeepTDLearning):
    q_network: Any = QuantileQValueNetwork(num_quantiles=10)
    safety: RiskSensitiveSafetyModule = RiskNeutralSafetyModule()

    @property
    def is_distributional(self) -> bool:
        return True

    def _scores(self, state, subjective_state, mask) -> torch.Tensor:
        params, subjective_state, candidates = self._act_inputs(state, subjective_state)
        quantiles = self.q_network.quantiles_all(params, subjective_state, candidates, mask)
        return self.safety.q_values_under_risk_metric(quantiles.to(torch.float32))

    def td_loss(self, state: DeepTDState, batch: TransitionBatch):
        """(QR loss, aux metrics) on one batch, with grad to the online params."""
        subj = self.history_summarizer.forward(state.summarizer_params, batch.state)
        candidates = self._candidates(state, subj.shape[0])
        quantiles = self.q_network.quantiles_all(
            state.params, subj, candidates, batch.curr_available_mask
        )
        theta = _take_action(quantiles, batch.action_index)  # (B, N) over i
        with torch.no_grad():
            next_subj = self.history_summarizer.forward(state.summarizer_params, batch.next_state)
            next_quant = self.q_network.quantiles_all(
                state.target_params, next_subj, candidates, batch.next_available_mask
            )
            next_scores = self.safety.q_values_under_risk_metric(next_quant)
            a_star = masked_argmax(next_scores, batch.next_available_mask)
            theta_next = _take_action(next_quant, a_star)
            not_done = 1.0 - batch.terminated.to(torch.float32)
            target = batch.reward[:, None] + self.discount_factor * not_done[:, None] * theta_next
        tau_hat = self.q_network.midpoints(theta.device)
        u = target[:, None, :] - theta[:, :, None]  # (B, i, j)
        weight = (tau_hat[None, :, None] - (u < 0.0).to(torch.float32)).abs()
        loss = (weight * _huber(u)).mean(dim=2).sum(dim=1).mean()
        per_sample = (target.mean(dim=-1) - theta.detach().mean(dim=-1)).abs()
        return loss, {"loss": per_sample.mean(), "per_sample_td": per_sample}
