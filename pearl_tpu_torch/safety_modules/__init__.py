from pearl_tpu_torch.safety_modules.identity import IdentitySafetyModule, SafetyModule

__all__ = ["IdentitySafetyModule", "SafetyModule"]
