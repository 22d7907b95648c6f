from pearl_tpu_torch.envs.cartpole import CartPole, CartPoleState
from pearl_tpu_torch.envs.pendulum import Pendulum, PendulumState
from pearl_tpu_torch.envs.synthetic_visual import SyntheticAtari, SyntheticAtariState
from pearl_tpu_torch.envs.vector import VectorEnv

__all__ = [
    "CartPole",
    "CartPoleState",
    "Pendulum",
    "PendulumState",
    "SyntheticAtari",
    "SyntheticAtariState",
    "VectorEnv",
]
