from pearl_tpu_torch.envs.cartpole import CartPole, CartPoleState
from pearl_tpu_torch.envs.pendulum import Pendulum, PendulumState
from pearl_tpu_torch.envs.sparse_reward import (
    ContinuousSparseRewardEnvironment,
    DiscreteSparseRewardEnvironment,
    SparseRewardState,
)
from pearl_tpu_torch.envs.synthetic_visual import SyntheticAtari, SyntheticAtariState
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.envs.wrappers import (
    DynamicActionSpaceWrapper,
    EnvWrapper,
    PartialObservabilityWrapper,
    SafetyWrapper,
    SafetyWrapperState,
)

__all__ = [
    "CartPole",
    "CartPoleState",
    "ContinuousSparseRewardEnvironment",
    "DiscreteSparseRewardEnvironment",
    "DynamicActionSpaceWrapper",
    "EnvWrapper",
    "Pendulum",
    "PartialObservabilityWrapper",
    "PendulumState",
    "SafetyWrapper",
    "SafetyWrapperState",
    "SparseRewardState",
    "SyntheticAtari",
    "SyntheticAtariState",
    "VectorEnv",
]
