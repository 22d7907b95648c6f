from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    BoltzmannExploration,
    EGreedyExploration,
    ExplorationModule,
    ExplorationModuleWrapper,
    NoExploration,
    NormalDistributionExploration,
    PropensityExploration,
    TiebreakingStrategy,
    Warmup,
    masked_argmax,
    masked_argmax_random_ties,
    masked_argmax_random_ties_batch,
    model_action_index,
    uniform_index,
)
from pearl_tpu_torch.policy_learners.exploration_modules.deep_exploration import (
    DeepExploration,
    DeepExplorationState,
)

__all__ = [
    "BoltzmannExploration",
    "DeepExploration",
    "DeepExplorationState",
    "EGreedyExploration",
    "ExplorationModule",
    "ExplorationModuleWrapper",
    "NoExploration",
    "NormalDistributionExploration",
    "PropensityExploration",
    "TiebreakingStrategy",
    "Warmup",
    "masked_argmax",
    "masked_argmax_random_ties",
    "masked_argmax_random_ties_batch",
    "model_action_index",
    "uniform_index",
]
