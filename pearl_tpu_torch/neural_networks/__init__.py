from pearl_tpu_torch.neural_networks.common import MLP, ConvNet, select_index_last
from pearl_tpu_torch.neural_networks.q_value_networks import (
    CNNQValueNetwork,
    MultiHeadQValueNetwork,
    VanillaQValueNetwork,
)

__all__ = [
    "MLP",
    "ConvNet",
    "select_index_last",
    "CNNQValueNetwork",
    "MultiHeadQValueNetwork",
    "VanillaQValueNetwork",
]
