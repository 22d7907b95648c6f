"""Risk-sensitive safety modules (port of
`pearl_tpu/safety_modules/risk_sensitive.py`).

They map a quantile-distributional Q, (B, A, N), to action scores (B, A).
`PearlAgent` injects a risk-sensitive module given to it into a
distributional learner's `safety` field, so it reaches QR-DQN's acting and
learning; the learner's own field serves the learner used on its own.
"""

from __future__ import annotations

import dataclasses

import torch

from pearl_tpu_torch.safety_modules.identity import SafetyModule


@dataclasses.dataclass(frozen=True, eq=False)
class RiskSensitiveSafetyModule(SafetyModule):
    def q_values_under_risk_metric(self, quantiles: torch.Tensor) -> torch.Tensor:
        """(B, A, N) quantile values -> (B, A) scores."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class RiskNeutralSafetyModule(RiskSensitiveSafetyModule):
    """The mean over quantiles: the default of distributional learners."""

    def q_values_under_risk_metric(self, quantiles: torch.Tensor) -> torch.Tensor:
        return quantiles.mean(dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class QuantileNetworkMeanVarianceSafetyModule(RiskSensitiveSafetyModule):
    """mean - beta * variance of the quantile distribution: risk-averse
    scores. The variance is the population one (`jnp.var`)."""

    variance_weighting_coefficient: float = 0.1

    def q_values_under_risk_metric(self, quantiles: torch.Tensor) -> torch.Tensor:
        mean = quantiles.mean(dim=-1)
        var = quantiles.var(dim=-1, correction=0)
        return mean - self.variance_weighting_coefficient * var
