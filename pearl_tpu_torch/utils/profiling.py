"""Profiling and the port's own tracing (port of `pearl_tpu/utils/profiling.py`,
which has the first two).

`trace(log_dir)` records a `torch.profiler` trace of a block (host and, on
the card, device activity) and writes it to `log_dir` as a Chrome trace that
Perfetto opens, with the program's spans beside it; `timed` measures the
steady-state seconds of a call, waiting for the device its outputs live on.

Spans and counters. The driver, the agent, the replay and the learner open a
`span(name)` around their work and bump `count(name, n)` at the same
boundaries; every name is in `SPANS`. Tracing is off by default: a span is
then one global check and a shared no-op object, a count one check.
`enable()` / `disable()` switch it (and `trace` for its block); while on, a
span records its name, start and end, its parent span's id and the id of
the dispatch it belongs to (`SpanRecord`), read back by `spans()`, with the
counters by `counters()`; `reset()` clears both.

Start and end are `time.time_ns()`, Unix-epoch nanoseconds: the clock of
`torch.profiler`'s host timestamps, read just inside the span's profiler
range (within a microsecond of the range's ends on an H100 host). The
profiler converts the card's timestamps to that clock too, but they can sit
or drift milliseconds off it in a process: compare device intervals with
spans through each operation's launch, a host timestamp.
Each span opens a RecordFunction range of its name (the fast binding that
`torch.compile` uses); the range records only while a profiler with CPU
activity runs, and costs well under a microsecond otherwise.

Host syncs. The program's own blocking reads of device values go through
`host_read`, which counts `driver.host_syncs`. While tracing is on and a
CUDA context exists, CUDA's sync debug mode is set to warn, and any other
synchronizing call made inside a span is caught and counted too;
`host_syncs_by_span()` names the innermost span of each sync. Tracing is
kept per process and assumes one thread drives the program.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Callable, Dict, List, NamedTuple

import torch

from pearl_tpu_torch.utils.pytree import walk_leaves

# Every span and counter the program emits. Spans nest as listed: the
# driver's call > dispatch > act / env / observe / learn; history and replay
# under observe, replay and learner under learn; an op's span under the
# caller that launched it.
SPANS = (
    # spans
    "driver.call",  # one `online_learning` call
    "driver.dispatch",  # one dispatch's chunks
    "driver.fetch",  # the blocking fetch of a dispatch's statistics
    "agent.act",
    "env.step",
    "agent.observe",
    "history.advance",  # the acting frame's fence and the ring's advance
    "replay.push",
    "agent.learn",
    "replay.sample",
    "learner.update",  # the batch's transform, preprocessing and update
    "op.cache_write",
    "op.copy_fence",
    "op.fused_mlp",
    "op.masked_scale_fence",
    "op.masked_scale_fence4",
    "op.ring_conv1",
    "op.ring_write",
    "op.ring_write_where",
    "op.synthetic_frames",
    # counters
    "driver.vector_steps",
    "driver.learns",
    "driver.dispatches",
    "driver.host_syncs",
    "replay.rows_pushed",
    "replay.rows_sampled",
)
_NAMES = frozenset(SPANS)
_SYNC_WARNING = "called a synchronizing CUDA operation"


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int  # Unix-epoch nanoseconds, the profiler's clock
    end_ns: int
    parent: int  # the enclosing span's id, -1 at the top
    dispatch: int  # the latest `driver.dispatch` opened, -1 before the first


_on = False
_records: List[SpanRecord] = []
_counters: Dict[str, int] = {}
_sync_sites: Dict[str, int] = {}
_open: List["_Span"] = []
_next_id = 0
_dispatch = -1
_in_read = False
_restore_warnings = None
_showwarning_before = None
_sync_mode_before = None
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The shared span of the off path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "dispatch", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id, _dispatch
        if self.name == "driver.dispatch":
            _dispatch += 1
        self.id, _next_id = _next_id, _next_id + 1
        self.parent = _open[-1].id if _open else -1
        self.dispatch = _dispatch
        _open.append(self)
        self.range = _range(self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.range.__exit__(None, None, None)
        _open.pop()
        _records.append(
            SpanRecord(self.id, self.name, self.start, end, self.parent, self.dispatch)
        )
        return False


def _check(name: str) -> None:
    if name not in _NAMES:
        raise ValueError(f"{name!r} is not in profiling.SPANS")


def span(name: str):
    """`with span("agent.act"): ...`: a recorded span while tracing is on,
    a shared no-op otherwise."""
    if not _on:
        return _OFF
    _check(name)
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while tracing is on."""
    if _on:
        _check(name)
        _counters[name] = _counters.get(name, 0) + n


def _count_sync() -> None:
    _counters["driver.host_syncs"] = _counters.get("driver.host_syncs", 0) + 1
    site = _open[-1].name if _open else "outside any span"
    _sync_sites[site] = _sync_sites.get(site, 0) + 1


def host_read(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor.cpu()`: the program's blocking device-to-host read, counted
    as one host sync while tracing is on."""
    global _in_read
    if not _on:
        return tensor.cpu()
    _count_sync()
    _in_read = True
    try:
        return tensor.cpu()
    finally:
        _in_read = False


def _show_warning(message, category, filename, lineno, file=None, line=None):
    if _SYNC_WARNING in str(message):
        if _open and not _in_read:
            _count_sync()
        return
    _showwarning_before(message, category, filename, lineno, file, line)


def enable() -> None:
    """Turn tracing on (records accumulate until `reset`)."""
    global _on, _restore_warnings, _showwarning_before, _sync_mode_before
    if _on:
        return
    _on = True
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _restore_warnings = warnings.catch_warnings()
        _restore_warnings.__enter__()
        _showwarning_before = warnings.showwarning
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        warnings.showwarning = _show_warning
        _sync_mode_before = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "a prototype feature"
            torch.cuda.set_sync_debug_mode("warn")


def disable() -> None:
    """Turn tracing off; the records stay readable."""
    global _on, _restore_warnings, _sync_mode_before
    if not _on:
        return
    _on = False
    if _restore_warnings is not None:
        torch.cuda.set_sync_debug_mode(_sync_mode_before)
        _restore_warnings.__exit__(None, None, None)
        _restore_warnings = _sync_mode_before = None


def spans() -> List[SpanRecord]:
    """The closed spans since the last `reset`, in the order they closed."""
    return list(_records)


def counters() -> Dict[str, int]:
    return dict(_counters)


def host_syncs_by_span() -> Dict[str, int]:
    """`driver.host_syncs` split by the innermost span open at each sync."""
    return dict(_sync_sites)


def reset() -> None:
    """Clear the records and counters (ids keep counting up)."""
    _records.clear()
    _counters.clear()
    _sync_sites.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("/tmp/trace"): run(...)` writes `log_dir/trace.json` and
    the program's spans and counters of the block as `log_dir/spans.json`,
    with tracing on for the block; the profiler is yielded for callers who
    read its events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on, first, before = _on, len(_records), counters()
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    block = {k: v - before.get(k, 0) for k, v in _counters.items() if v != before.get(k, 0)}
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"clock": "unix_ns", "spans": [r._asdict() for r in _records[first:]],
                   "counters": block}, f)


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
