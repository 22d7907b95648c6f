"""Arithmetic the metric readers share. Each returns None where the run has
nothing to read (no span, no profile, no learn), and the harness then leaves
the metric out."""

from __future__ import annotations

from typing import Optional

from portbench.core import peaks
from portbench.core.spans import OP_PREFIX
from portbench.counts import cnn


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
    """Percent: the least time for the op's bytes at the HBM peak over the
    device time launched inside its spans, in the profiled dispatches."""
    if r.profile is None or not r.op_bytes.get(op):
        return None
    device_s = r.profile.device_s(OP_PREFIX + op)
    if device_s <= 0:
        return None
    return 100.0 * (r.op_bytes[op] / peaks.HBM_BYTES_PER_S) / device_s


def mfu(r) -> Optional[float]:
    """Percent of the chip's peak over the window: each act's forward at the
    act precision, each learn's operations at the fastest precision the
    run's flags allow for float32 work, summed as peak-seconds."""
    if r.window_s <= 0 or r.env_steps == 0:
        return None
    act_peak = peaks.FLOPS[r.config["precision"]["act"]]
    seconds = r.env_steps * cnn.forward_flops(r.config) / act_peak
    if r.learns:
        learn = cnn.learn_flops(r.config)
        conv_peak = peaks.FLOPS["tf32" if r.tf32.get("cudnn") else "float32"]
        dense_peak = peaks.FLOPS["tf32" if r.tf32.get("matmul") else "float32"]
        seconds += r.learns * (learn["conv"] / conv_peak + learn["dense"] / dense_peak)
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
