from pearl_tpu_torch.training.collect import collect_offline_data
from pearl_tpu_torch.training.offline import (
    buffer_from_batch,
    get_offline_data_in_buffer,
    offline_evaluation,
    offline_learning,
    save_offline_data,
    transitions_from_arrays,
)
from pearl_tpu_torch.training.host_loop import (
    agent_online_learning_host,
    online_learning_host,
    run_episode_host,
)
from pearl_tpu_torch.training.online import OnlineResult, online_learning
from pearl_tpu_torch.training.population import PopulationResult, population_learning
from pearl_tpu_torch.training.throughput import make_compiled_runner

__all__ = [
    "OnlineResult",
    "PopulationResult",
    "agent_online_learning_host",
    "buffer_from_batch",
    "collect_offline_data",
    "get_offline_data_in_buffer",
    "make_compiled_runner",
    "offline_evaluation",
    "offline_learning",
    "online_learning",
    "online_learning_host",
    "population_learning",
    "run_episode_host",
    "save_offline_data",
    "transitions_from_arrays",
]
