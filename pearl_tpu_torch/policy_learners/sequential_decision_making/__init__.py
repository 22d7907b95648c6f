from pearl_tpu_torch.policy_learners.sequential_decision_making.actor_critic_base import (
    ActorCriticBase,
    ActorCriticState,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.bootstrapped_dqn import (
    BootstrappedDQN,
    BootstrappedDQNState,
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
from pearl_tpu_torch.policy_learners.sequential_decision_making.iql import (
    ImplicitQLearning,
    IQLExtra,
    expectile_loss,
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
from pearl_tpu_torch.policy_learners.sequential_decision_making.tabular_q import (
    DictTabularQLearning,
    TabularQLearning,
    TabularQState,
)
from pearl_tpu_torch.policy_learners.sequential_decision_making.td3 import TD3, TD3BC

__all__ = [
    "ActorCriticBase",
    "ActorCriticState",
    "AlphaState",
    "BootstrappedDQN",
    "BootstrappedDQNState",
    "ContinuousSoftActorCritic",
    "DeepDeterministicPolicyGradient",
    "DeepQLearning",
    "DeepSARSA",
    "DeepTDLearning",
    "DeepTDState",
    "DictTabularQLearning",
    "DoubleDQN",
    "IQLExtra",
    "ImplicitQLearning",
    "ProximalPolicyOptimization",
    "QuantileRegressionDeepQLearning",
    "REINFORCE",
    "SoftActorCritic",
    "TD3",
    "TD3BC",
    "TabularQLearning",
    "TabularQState",
    "discounted_returns",
    "expectile_loss",
    "gae_lambda_returns",
    "twin_q_all",
]
