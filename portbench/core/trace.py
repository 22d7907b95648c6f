"""The profiled dispatches, reduced in memory.

`profile(fn, names)` runs `fn` under `torch.profiler` and reads the raw
Kineto events: each device operation (kernels, copies, sets; user
annotations on the device timeline span work already counted and are left
out), each CUDA runtime call, and each host range that a span opened. A
device operation belongs to the spans whose host range holds the runtime
call that launched it (matched by correlation id). With `host=False` only
device activity is traced: the host runs at nearly its untraced pace, so the
busy and idle time are read from such a profile, and the attribution to
spans from one with host activity.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

# Runtime calls that put work on the device: launches of kernels and graphs,
# copies and sets.
_LAUNCH_WORDS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset", "LaunchCooperativeKernel")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    spans: Tuple[str, ...]  # the host spans open at the launch, outermost first


@dataclasses.dataclass
class Profile:
    wall_s: float
    ops: List[DeviceOp]
    runtime_calls: int

    @property
    def busy_s(self) -> float:
        return union_ns([(o.start_ns, o.start_ns + o.dur_ns) for o in self.ops]) / 1e9

    def device_s(self, span: str) -> float:
        """Seconds of device operations launched inside `span`."""
        return sum(o.dur_ns for o in self.ops if span in o.spans) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by_name: Dict[str, int] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0) + o.dur_ns
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds between device operations, summed by what the host was
        doing when it launched the operation that ended each gap: the
        innermost span open then, or "driver" outside every span."""
        ops = sorted(self.ops, key=lambda o: o.start_ns)
        by_label: Dict[str, int] = {}
        busy_end = None
        for o in ops:
            if busy_end is not None and o.start_ns > busy_end:
                label = o.spans[-1] if o.spans else "driver"
                by_label[label] = by_label.get(label, 0) + (o.start_ns - busy_end)
            end = o.start_ns + o.dur_ns
            busy_end = end if busy_end is None else max(busy_end, end)
        ranked = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
        return [[label, ns / 1e9] for label, ns in ranked]


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def spans_at(ranges: Sequence[Tuple[str, int, int]], times: Sequence[int]) -> List[Tuple[str, ...]]:
    """For each time in `times`, the names of the `ranges` (name, start,
    end) that hold it, outermost first: one sweep over both sorted."""
    ranges = sorted(ranges, key=lambda r: r[1])
    out: List[Tuple[str, ...]] = [()] * len(times)
    active: List[Tuple[str, int, int]] = []
    ri = 0
    for idx in sorted(range(len(times)), key=lambda i: times[i]):
        t = times[idx]
        while ri < len(ranges) and ranges[ri][1] <= t:
            active.append(ranges[ri])
            ri += 1
        active = [r for r in active if r[2] >= t]
        out[idx] = tuple(name for name, _, _ in sorted(active, key=lambda r: (r[1], -r[2])))
    return out


def reduce_events(events, span_names) -> Tuple[List[DeviceOp], int]:
    """(device operations, runtime launch calls) of raw Kineto events."""
    from torch.autograd import DeviceType

    launches: Dict[int, int] = {}
    ranges = []
    device = []
    runtime_calls = 0
    for evt in events:
        name = evt.name()
        if evt.device_type() == DeviceType.CUDA:
            if not evt.is_user_annotation():
                device.append(evt)
            continue
        if evt.is_user_annotation() or name in span_names:
            if name in span_names:
                ranges.append((name, evt.start_ns(), evt.start_ns() + evt.duration_ns()))
            continue
        if name.startswith("cu") and any(w in name for w in _LAUNCH_WORDS):
            runtime_calls += 1
            if evt.correlation_id():
                launches[evt.correlation_id()] = evt.start_ns()
    found = [launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id())
             for e in device]
    held = spans_at(ranges, [-1 if t is None else t for t in found])
    ops = [DeviceOp(name=e.name(), start_ns=e.start_ns(), dur_ns=e.duration_ns(),
                    spans=s if t is not None else ())
           for e, t, s in zip(device, found, held)]
    return ops, runtime_calls


def profile(fn, span_names, host: bool = True) -> Profile:
    """Run `fn()` under the profiler (device activity, and host activity
    with `host`) and reduce its events; `wall_s` is the host clock around
    `fn()` and the final wait for the device."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ops, runtime_calls = reduce_events(prof.profiler.kineto_results.events(), span_names)
    return Profile(wall_s=wall_s, ops=ops, runtime_calls=runtime_calls)
