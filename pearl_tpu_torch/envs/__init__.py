from pearl_tpu_torch.envs.bandit import (
    CBState,
    ClassificationBanditEnvironment,
    LinearSyntheticBanditEnvironment,
    RewardIsTenTimesActionMABEnvironment,
    SLCBState,
)
from pearl_tpu_torch.envs.breakout import Breakout, BreakoutState
from pearl_tpu_torch.envs.cartpole import CartPole, CartPoleState
from pearl_tpu_torch.envs.classic import (
    Acrobot,
    AcrobotState,
    ContinuousMountainCar,
    MountainCar,
    MountainCarState,
)
from pearl_tpu_torch.envs.frozen_lake import FrozenLake, FrozenLakeState
from pearl_tpu_torch.envs.misc import (
    FixedNumberOfStepsEnvironment,
    MeanVarBanditEnvironment,
    StepCountState,
)
from pearl_tpu_torch.envs.pendulum import Pendulum, PendulumState
from pearl_tpu_torch.envs.ple import (
    Catcher,
    CatcherState,
    FlappyBird,
    FlappyBirdState,
    Pixelcopter,
    PixelcopterState,
    Pong,
    PongState,
)
from pearl_tpu_torch.envs.puckworld import PuckWorld, PuckWorldState
from pearl_tpu_torch.envs.recsys import RecommenderEnvironment, RecSysState
from pearl_tpu_torch.envs.sparse_reward import (
    ContinuousSparseRewardEnvironment,
    DiscreteSparseRewardEnvironment,
    SparseRewardState,
)
from pearl_tpu_torch.envs.synthetic_visual import SyntheticAtari, SyntheticAtariState
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.envs.wrappers import (
    DynamicActionSpaceWrapper,
    EnvWrapper,
    FlattenDictObservations,
    FlattenObservations,
    OneHotObservationsFromDiscrete,
    PartialObservabilityWrapper,
    SafetyWrapper,
    SafetyWrapperState,
    SparseRewardWrapper,
)

__all__ = [
    "Acrobot",
    "AcrobotState",
    "Breakout",
    "BreakoutState",
    "CBState",
    "CartPole",
    "CartPoleState",
    "Catcher",
    "CatcherState",
    "ClassificationBanditEnvironment",
    "ContinuousMountainCar",
    "ContinuousSparseRewardEnvironment",
    "DiscreteSparseRewardEnvironment",
    "DynamicActionSpaceWrapper",
    "EnvWrapper",
    "FixedNumberOfStepsEnvironment",
    "FlappyBird",
    "FlappyBirdState",
    "FlattenDictObservations",
    "FlattenObservations",
    "FrozenLake",
    "FrozenLakeState",
    "LinearSyntheticBanditEnvironment",
    "MeanVarBanditEnvironment",
    "MountainCar",
    "MountainCarState",
    "OneHotObservationsFromDiscrete",
    "PartialObservabilityWrapper",
    "Pendulum",
    "PendulumState",
    "Pixelcopter",
    "PixelcopterState",
    "Pong",
    "PongState",
    "PuckWorld",
    "PuckWorldState",
    "RecSysState",
    "RecommenderEnvironment",
    "RewardIsTenTimesActionMABEnvironment",
    "SLCBState",
    "SafetyWrapper",
    "SafetyWrapperState",
    "SparseRewardState",
    "SparseRewardWrapper",
    "StepCountState",
    "SyntheticAtari",
    "SyntheticAtariState",
    "VectorEnv",
]
