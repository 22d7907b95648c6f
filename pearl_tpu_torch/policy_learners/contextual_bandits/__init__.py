from pearl_tpu_torch.policy_learners.contextual_bandits.base import ContextualBanditBase
from pearl_tpu_torch.policy_learners.contextual_bandits.disjoint import (
    DisjointBanditContainer,
    DisjointBanditState,
    DisjointLinearBandit,
)
from pearl_tpu_torch.policy_learners.contextual_bandits.linear_bandit import (
    LinearBandit,
    LinearBanditState,
)
from pearl_tpu_torch.policy_learners.contextual_bandits.neural_bandit import (
    NeuralArms,
    NeuralBandit,
    NeuralBanditState,
)
from pearl_tpu_torch.policy_learners.contextual_bandits.neural_linear_bandit import (
    NeuralLinearBandit,
    NeuralLinearBanditState,
)

__all__ = [
    "ContextualBanditBase",
    "DisjointBanditContainer",
    "DisjointBanditState",
    "DisjointLinearBandit",
    "LinearBandit",
    "LinearBanditState",
    "NeuralArms",
    "NeuralBandit",
    "NeuralBanditState",
    "NeuralLinearBandit",
    "NeuralLinearBanditState",
]
