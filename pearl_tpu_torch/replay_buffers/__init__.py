from pearl_tpu_torch.replay_buffers.bootstrap import BootstrapReplayBuffer
from pearl_tpu_torch.replay_buffers.hindsight import (
    HERBufferState,
    HindsightExperienceReplayBuffer,
    default_reach_reward_fn,
)
from pearl_tpu_torch.replay_buffers.on_policy import OnPolicyReplayBuffer
from pearl_tpu_torch.replay_buffers.packed import PackedReplayBuffer
from pearl_tpu_torch.replay_buffers.prioritized import (
    PrioritizedBufferState,
    PrioritizedReplayBuffer,
)
from pearl_tpu_torch.replay_buffers.replay_buffer import (
    BasicReplayBuffer,
    ReplayBufferState,
    SingleTransitionReplayBuffer,
)
from pearl_tpu_torch.replay_buffers.sarsa import SARSABufferState, SARSAReplayBuffer
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.replay_buffers.visual import VisualBufferState, VisualReplayBuffer

__all__ = [
    "BasicReplayBuffer",
    "BootstrapReplayBuffer",
    "HERBufferState",
    "HindsightExperienceReplayBuffer",
    "OnPolicyReplayBuffer",
    "PackedReplayBuffer",
    "PrioritizedBufferState",
    "PrioritizedReplayBuffer",
    "ReplayBufferState",
    "SARSABufferState",
    "SARSAReplayBuffer",
    "SingleTransitionReplayBuffer",
    "TransitionBatch",
    "VisualBufferState",
    "VisualReplayBuffer",
    "default_reach_reward_fn",
]
