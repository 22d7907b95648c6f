from pearl_tpu_torch.neural_networks.common import MLP, select_index_last
from pearl_tpu_torch.neural_networks.q_value_networks import (
    MultiHeadQValueNetwork,
    VanillaQValueNetwork,
)

__all__ = ["MLP", "select_index_last", "MultiHeadQValueNetwork", "VanillaQValueNetwork"]
