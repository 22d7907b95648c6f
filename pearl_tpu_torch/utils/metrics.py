"""Metrics logging and the normalized score (port of
`pearl_tpu/utils/metrics.py`).

`MetricsLogger` appends JSONL records (step, time, name: value);
`normalized_score` is the D4RL-style score of offline-RL evaluation."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        """One record; a metric may be a number, a numpy value or a 0-dim
        tensor (read on the host)."""
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(_host(v)) for k, v in metrics.items()})
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()


def normalized_score(score: float, random_score: float, expert_score: float) -> float:
    """0 for the random policy's score, 100 for the expert's; 0 when the two
    anchors coincide."""
    denom = expert_score - random_score
    if abs(denom) < 1e-12:
        return 0.0
    return 100.0 * (score - random_score) / denom
