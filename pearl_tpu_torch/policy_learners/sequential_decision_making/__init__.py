from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
    ActorCriticState,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.ddpg import (
    DeepDeterministicPolicyGradient,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.deep_td import (
    DeepQLearning,
    DeepSARSA,
    DeepTDLearning,
    DeepTDState,
    DoubleDQN,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.ppo import (
    ProximalPolicyOptimization,
    gae_lambda_returns,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.qr_dqn import (
    QuantileRegressionDeepQLearning,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.reinforce import (
    REINFORCE,
    discounted_returns,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.sac import (
    SoftActorCritic,
    twin_q_all,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.sac_continuous import (
    AlphaState,
    ContinuousSoftActorCritic,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.td3 import TD3, TD3BC

__all__ = [
    "ActorCriticBase",
    "ActorCriticState",
    "AlphaState",
    "ContinuousSoftActorCritic",
    "DeepDeterministicPolicyGradient",
    "DeepQLearning",
    "DeepSARSA",
    "DeepTDLearning",
    "DeepTDState",
    "DoubleDQN",
    "ProximalPolicyOptimization",
    "QuantileRegressionDeepQLearning",
    "REINFORCE",
    "SoftActorCritic",
    "TD3",
    "TD3BC",
    "discounted_returns",
    "gae_lambda_returns",
    "twin_q_all",
]
