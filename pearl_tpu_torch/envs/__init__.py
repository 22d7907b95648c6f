from pearl_tpu_torch.envs.cartpole import CartPole, CartPoleState
from pearl_tpu_torch.envs.pendulum import Pendulum, PendulumState
from pearl_tpu_torch.envs.sparse_reward import (
    ContinuousSparseRewardEnvironment,
    DiscreteSparseRewardEnvironment,
    SparseRewardState,
)
from pearl_tpu_torch.envs.synthetic_visual import SyntheticAtari, SyntheticAtariState
from pearl_tpu_torch.envs.vector import VectorEnv

__all__ = [
    "CartPole",
    "CartPoleState",
    "ContinuousSparseRewardEnvironment",
    "DiscreteSparseRewardEnvironment",
    "Pendulum",
    "PendulumState",
    "SparseRewardState",
    "SyntheticAtari",
    "SyntheticAtariState",
    "VectorEnv",
]
