from pearl_tpu_torch.neural_networks.actor_networks import (
    GaussianActorNetwork,
    VanillaContinuousActorNetwork,
)
from pearl_tpu_torch.neural_networks.common import MLP, ConvNet, select_index_last
from pearl_tpu_torch.neural_networks.q_value_networks import (
    CNNQValueNetwork,
    MultiHeadQValueNetwork,
    VanillaQValueNetwork,
)
from pearl_tpu_torch.neural_networks.twin_critic import TwinCritic

__all__ = [
    "MLP",
    "ConvNet",
    "select_index_last",
    "CNNQValueNetwork",
    "GaussianActorNetwork",
    "MultiHeadQValueNetwork",
    "TwinCritic",
    "VanillaContinuousActorNetwork",
    "VanillaQValueNetwork",
]
