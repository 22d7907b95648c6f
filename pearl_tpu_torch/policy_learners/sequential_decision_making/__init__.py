from pearl_tpu_torch.policy_learners.sequential_decision_making.deep_td import (
    DeepQLearning,
    DeepTDLearning,
    DeepTDState,
    DoubleDQN,
)

__all__ = ["DeepQLearning", "DeepTDLearning", "DeepTDState", "DoubleDQN"]
