from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace, DiscreteSpace
from pearl_tpu_torch.api.environment import Environment

__all__ = [
    "ActionResult",
    "BoxSpace",
    "DiscreteActionSpace",
    "DiscreteSpace",
    "Environment",
]
