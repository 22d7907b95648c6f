from pearl_tpu_torch.replay_buffers.on_policy import OnPolicyReplayBuffer
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.replay_buffers.visual import VisualBufferState, VisualReplayBuffer

__all__ = [
    "BasicReplayBuffer",
    "OnPolicyReplayBuffer",
    "ReplayBufferState",
    "TransitionBatch",
    "VisualBufferState",
    "VisualReplayBuffer",
]
