from pearl_tpu_torch.benchmarks.configs import METHODS, Method, make_agent
from pearl_tpu_torch.benchmarks.offline_rl import (
    OfflineRLResult,
    mix_datasets,
    run_offline_rl_benchmark,
)
from pearl_tpu_torch.benchmarks.run import run_benchmark, run_single
from pearl_tpu_torch.training.offline import buffer_from_batch

__all__ = [
    "METHODS",
    "Method",
    "OfflineRLResult",
    "buffer_from_batch",
    "make_agent",
    "mix_datasets",
    "run_benchmark",
    "run_offline_rl_benchmark",
    "run_single",
]
