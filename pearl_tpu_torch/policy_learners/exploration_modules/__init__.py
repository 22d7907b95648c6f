from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    EGreedyExploration,
    ExplorationModule,
    NoExploration,
    NormalDistributionExploration,
    PropensityExploration,
    masked_argmax,
    uniform_index,
)

__all__ = [
    "EGreedyExploration",
    "ExplorationModule",
    "NoExploration",
    "NormalDistributionExploration",
    "PropensityExploration",
    "masked_argmax",
    "uniform_index",
]
