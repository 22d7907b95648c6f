"""Core typed primitives (port of `pearl_tpu/api/types.py`).

`ActionResult` is a dataclass of batched tensors: one env step of B envs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class ActionResult:
    """Result of one batched environment step.

    `available_actions_mask` is (B, A) bool, True = available (the
    complement of the original Pearl's `unavailable_actions_mask`)."""

    observation: torch.Tensor  # (B, obs_dim)
    reward: torch.Tensor  # (B,) f32
    terminated: torch.Tensor  # (B,) bool
    truncated: torch.Tensor  # (B,) bool
    cost: Optional[torch.Tensor] = None
    available_actions_mask: Optional[torch.Tensor] = None
    info: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated
