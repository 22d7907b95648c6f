from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer, ReplayBufferState
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.replay_buffers.visual import VisualBufferState, VisualReplayBuffer

__all__ = [
    "BasicReplayBuffer",
    "ReplayBufferState",
    "TransitionBatch",
    "VisualBufferState",
    "VisualReplayBuffer",
]
