"""Profiling (port of `pearl_tpu/utils/profiling.py`).

`trace(log_dir)` records a `torch.profiler` trace of a block (host and, on
the card, device activity) and writes it to `log_dir` as a Chrome trace that
Perfetto opens; `timed` measures the steady-state seconds of a call, waiting
for the device its outputs live on."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from pearl_tpu_torch.utils.pytree import walk_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("/tmp/trace"): run(...)` writes `log_dir/trace.json`; the
    profiler is yielded for callers who read its events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _wait_for(out) -> None:
    """Synchronize every accelerator that holds a tensor of `out`."""
    devices = {leaf.device for _, leaf in walk_leaves(out) if isinstance(leaf, torch.Tensor)}
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> float:
    """Steady-state seconds per call of `fn(*args)`, its outputs waited for."""
    for _ in range(warmup):
        out = fn(*args)
    if warmup:
        _wait_for(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait_for(out)
    return (time.perf_counter() - t0) / iters
