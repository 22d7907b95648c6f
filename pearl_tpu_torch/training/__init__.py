from pearl_tpu_torch.training.online import OnlineResult, online_learning
from pearl_tpu_torch.training.throughput import make_compiled_runner

__all__ = ["OnlineResult", "make_compiled_runner", "online_learning"]
