from pearl_tpu_torch.benchmarks.offline_rl import (
    OfflineRLResult,
    mix_datasets,
    run_offline_rl_benchmark,
)
from pearl_tpu_torch.training.offline import buffer_from_batch

__all__ = [
    "OfflineRLResult",
    "buffer_from_batch",
    "mix_datasets",
    "run_offline_rl_benchmark",
]
