from pearl_tpu_torch.safety_modules.identity import IdentitySafetyModule, SafetyModule
from pearl_tpu_torch.safety_modules.risk_sensitive import (
    QuantileNetworkMeanVarianceSafetyModule,
    RiskNeutralSafetyModule,
    RiskSensitiveSafetyModule,
)

__all__ = [
    "IdentitySafetyModule",
    "QuantileNetworkMeanVarianceSafetyModule",
    "RiskNeutralSafetyModule",
    "RiskSensitiveSafetyModule",
    "SafetyModule",
]
