from pearl_tpu_torch.neural_networks.actor_networks import (
    CNNActorNetwork,
    DynamicActionActorNetwork,
    GaussianActorNetwork,
    VanillaActorNetwork,
    VanillaContinuousActorNetwork,
)
from pearl_tpu_torch.neural_networks.common import (
    ACTIVATIONS,
    MLP,
    ConvNet,
    resolve_activation,
    select_index_last,
)
from pearl_tpu_torch.neural_networks.epistemic import Epinet, MLPWithPrior
from pearl_tpu_torch.neural_networks.q_value_networks import (
    CNNQValueNetwork,
    DuelingQValueNetwork,
    EnsembleQValueNetwork,
    MultiHeadQValueNetwork,
    QuantileQValueNetwork,
    TwoTowerQValueNetwork,
    VanillaQValueNetwork,
)
from pearl_tpu_torch.neural_networks.twin_critic import CNNTwinCritic, TwinCritic
from pearl_tpu_torch.neural_networks.value_networks import CNNValueNetwork, VanillaValueNetwork

__all__ = [
    "ACTIVATIONS",
    "MLP",
    "ConvNet",
    "resolve_activation",
    "select_index_last",
    "CNNActorNetwork",
    "CNNQValueNetwork",
    "CNNTwinCritic",
    "CNNValueNetwork",
    "DuelingQValueNetwork",
    "DynamicActionActorNetwork",
    "EnsembleQValueNetwork",
    "Epinet",
    "GaussianActorNetwork",
    "MLPWithPrior",
    "MultiHeadQValueNetwork",
    "QuantileQValueNetwork",
    "TwinCritic",
    "TwoTowerQValueNetwork",
    "VanillaActorNetwork",
    "VanillaContinuousActorNetwork",
    "VanillaQValueNetwork",
    "VanillaValueNetwork",
]
