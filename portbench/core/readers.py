"""Arithmetic the metric readers share. Each returns None where the run has
nothing to read (no span, no profile, no learn), and the harness then leaves
the metric out."""

from __future__ import annotations

from typing import Optional

from portbench.core import peaks, specs
from portbench.core.spans import OP_PREFIX

# The flag of `Readings.tf32` that lets float32 work of each kind of layer run
# as TF32.
TF32_FLAG = {"conv": "cudnn", "dense": "matmul"}


def host_ms(r, span: str, per: str = "step") -> Optional[float]:
    """Host milliseconds inside `span` over the window, per vector step or
    per learn."""
    n = r.vector_steps if per == "step" else r.learns
    if span not in r.host_s or n == 0:
        return None
    return 1e3 * r.host_s[span] / n


def device_ms(r, span: str, per: str = "step") -> Optional[float]:
    """Device milliseconds of what `span` launched in the profiled
    dispatches, per vector step or per learn."""
    n = r.profiled_steps if per == "step" else r.profiled_learns
    if r.profile is None or n == 0:
        return None
    s = r.profile.device_s(span)
    return 1e3 * s / n if s > 0 else None


def roofline(r, op: str) -> Optional[float]:
    """Percent: the least time for the op's calls (the larger of its bytes at
    the HBM peak and its operations at the peak of their precision) over the
    device time launched inside its spans, in the profiled dispatches."""
    if r.profile is None or not (r.op_bytes.get(op) or r.op_flops.get(op)):
        return None
    device_s = r.profile.device_s(OP_PREFIX + op)
    if device_s <= 0:
        return None
    bound_s = max(r.op_bytes.get(op, 0) / peaks.HBM_BYTES_PER_S, r.op_flops.get(op, 0.0))
    return 100.0 * bound_s / device_s


def mfu(r) -> Optional[float]:
    """Percent of the chip's peak over the window: each act's forward at the
    act precision, each learn's operations at the fastest precision the
    run's flags allow for float32 work of their kind, summed as
    peak-seconds. The operations are those of the configuration's count
    module (`specs.count_module`)."""
    if r.window_s <= 0 or r.env_steps == 0:
        return None
    counts = specs.count_module(r.config)
    act_peak = peaks.FLOPS[r.config["precision"]["act"]]
    seconds = r.env_steps * counts.forward_flops(r.config) / act_peak
    if r.learns:
        learn = counts.learn_flops(r.config)
        seconds += r.learns * sum(
            flops / peaks.FLOPS["tf32" if r.tf32.get(TF32_FLAG[kind]) else "float32"]
            for kind, flops in learn.items())
    return 100.0 * seconds / r.window_s


def idle_share(r) -> Optional[float]:
    """Percent of the wall time of the dispatches profiled for device
    activity alone with nothing running on the device."""
    p = r.device_profile
    if p is None or p.wall_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)


def runtime_calls_per_step(r) -> Optional[float]:
    if r.profile is None or not r.profiled_steps:
        return None
    return r.profile.runtime_calls / r.profiled_steps
