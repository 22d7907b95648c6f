from pearl_tpu_torch.neural_networks.actor_networks import (
    CNNActorNetwork,
    DynamicActionActorNetwork,
    GaussianActorNetwork,
    VanillaActorNetwork,
    VanillaContinuousActorNetwork,
)
from pearl_tpu_torch.neural_networks.common import MLP, ConvNet, select_index_last
from pearl_tpu_torch.neural_networks.q_value_networks import (
    CNNQValueNetwork,
    DuelingQValueNetwork,
    MultiHeadQValueNetwork,
    QuantileQValueNetwork,
    VanillaQValueNetwork,
)
from pearl_tpu_torch.neural_networks.twin_critic import CNNTwinCritic, TwinCritic
from pearl_tpu_torch.neural_networks.value_networks import CNNValueNetwork, VanillaValueNetwork

__all__ = [
    "MLP",
    "ConvNet",
    "select_index_last",
    "CNNActorNetwork",
    "CNNQValueNetwork",
    "CNNTwinCritic",
    "CNNValueNetwork",
    "DuelingQValueNetwork",
    "DynamicActionActorNetwork",
    "GaussianActorNetwork",
    "MultiHeadQValueNetwork",
    "QuantileQValueNetwork",
    "TwinCritic",
    "VanillaActorNetwork",
    "VanillaContinuousActorNetwork",
    "VanillaQValueNetwork",
    "VanillaValueNetwork",
]
