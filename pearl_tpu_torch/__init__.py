"""pearl_tpu_torch — the PyTorch/CUDA port of pearl_tpu for NVIDIA Hopper.

The JAX package `pearl_tpu` is the reference; this package keeps its module
layout and names so each piece has an obvious counterpart
(`pearl_tpu_torch/agent/pearl_agent.py` <-> `pearl_tpu/agent/pearl_agent.py`).

- Plain tensor code is PyTorch, eager, on an explicit `device`. Entry points
  (`make_compiled_runner`, `online_learning`, `PearlAgent.init`) run on
  `cuda` unless the caller passes `device="cpu"`; with no GPU and no
  `device="cpu"` they raise (`utils.device.resolve_device`).
- Every Pallas kernel of the reference becomes a kernel written by hand for
  Hopper (`csrc/*.cu`, built by `ops/_build.py`). A wrapper launches it for a
  CUDA tensor and runs the plain PyTorch version for a CPU tensor.
- Randomness comes from explicit `torch.Generator`s, never the global RNG.
- float32 matmuls run in full float32: TF32 is switched off on import, as the
  reference computes in float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from pearl_tpu_torch.api.types import ActionResult  # noqa: E402,F401
from pearl_tpu_torch.api.spaces import (  # noqa: E402,F401
    BoxActionSpace,
    BoxSpace,
    DiscreteActionSpace,
    DiscreteSpace,
)
