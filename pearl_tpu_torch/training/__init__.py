from pearl_tpu_torch.training.collect import collect_offline_data
from pearl_tpu_torch.training.offline import (
    buffer_from_batch,
    get_offline_data_in_buffer,
    offline_evaluation,
    offline_learning,
    save_offline_data,
    transitions_from_arrays,
)
from pearl_tpu_torch.training.online import OnlineResult, online_learning
from pearl_tpu_torch.training.throughput import make_compiled_runner

__all__ = [
    "OnlineResult",
    "buffer_from_batch",
    "collect_offline_data",
    "get_offline_data_in_buffer",
    "make_compiled_runner",
    "offline_evaluation",
    "offline_learning",
    "online_learning",
    "save_offline_data",
    "transitions_from_arrays",
]
