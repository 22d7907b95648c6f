"""The program's own spans and counters, read in a traced phase.

`run_phase(dispatch)` runs after a traced run's two profiles, on the card:
it turns the port's tracing on (`pearl_tpu_torch.utils.profiling`), runs
four more dispatches under a profile of device activity alone, turns it off
and returns a `Phase`: the program's spans and counters, that profile, and
the phase's bounds on the profiler's clock (Unix nanoseconds, which the
program's spans share). A program without tracing of its own returns None,
and every reader here then returns None.

Idle time is put down to a layer by the host: a device-idle interval of the
phase counts toward the layer of the innermost program span open on the
host meanwhile. `agent.act`, `env.step`, `agent.observe` and `agent.learn`
are the layers act, env, observe and learn, and the spans under them (ops,
history, replay, learner) count toward them; the driver's own spans
(`driver.call`, `.dispatch`, `.fetch`) outside those are the driver; idle
time outside every program span (the harness between calls) goes to no
layer. The readers divide by the program's counters.

The device's timestamps can sit milliseconds off the host's, and drift
from them by milliseconds a second, in one process and not in the next (the
profiler converts the card's clock to the host's), while the host's ranges
and the program's spans agree to a microsecond. The device operations are
therefore moved onto the host's clock first (`device_clock`): each by the
offset at its launch, read off the lower envelope of the gaps between a
launch (a host timestamp) and the start of what it launched. Where the
clocks agree that envelope is the launch latency, a few microseconds: what
is left of the offset is at most that.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from portbench.core import trace

PHASE_DISPATCHES = 4
LAYER_OF = {"agent.act": "act", "env.step": "env", "agent.observe": "observe",
            "agent.learn": "learn", "driver.call": "driver", "driver.dispatch": "driver",
            "driver.fetch": "driver"}


@dataclasses.dataclass
class Phase:
    spans: List  # the program's records: name, start_ns, end_ns, parent, ...
    counters: Dict[str, int]
    profile: trace.Profile  # device activity alone, on the host's clock
    start_ns: int  # the phase's bounds, the profiler's clock
    end_ns: int


def run_phase(dispatch: Callable[[], object], dispatches: int = PHASE_DISPATCHES
              ) -> Optional[Phase]:
    """Run `dispatches` calls of `dispatch` with the program's tracing on,
    under a device-only profile; None where the program has no tracing."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    try:
        from pearl_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("enable", "disable", "spans", "counters")):
        return None
    bounds = []
    torch.cuda.synchronize()
    profiling.reset()
    profiling.enable()
    try:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            bounds.append(time.time_ns())
            for _ in range(dispatches):
                dispatch()
            torch.cuda.synchronize()
            bounds.append(time.time_ns())
    finally:
        profiling.disable()
    ops, runtime_calls, clock = device_ops(prof.profiler.kineto_results.events())
    wall_s = (bounds[1] - bounds[0]) / 1e9
    out = Phase(spans=profiling.spans(), counters=profiling.counters(),
                profile=trace.Profile(wall_s=wall_s, ops=ops, runtime_calls=runtime_calls),
                start_ns=bounds[0], end_ns=bounds[1])
    syncs = profiling.host_syncs_by_span()
    profiling.reset()
    idle = idle_ns(out)
    placed = sum(idle_by_layer(out).values())
    print(f"portbench: traced phase: {len(out.spans)} spans, counters {out.counters}, host "
          f"syncs by span {syncs}; device clock minus host clock "
          f"{clock_offset(clock, bounds[0])} ns at the start, {clock_offset(clock, bounds[1])} "
          f"at the end; idle {idle / 1e6:.3f} ms of {wall_s * 1e3:.3f}, placed "
          f"{100 * placed / max(idle, 1):.2f}%", file=sys.stderr, flush=True)
    return out


# ----------------------------------------------------------- the device's clock
def lower_hull(points: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The lower convex hull of (x, y) points, left to right."""
    hull: List[Tuple[int, int]] = []
    for p in sorted(points):
        while len(hull) >= 2:
            (x0, y0), (x1, y1) = hull[-2], hull[-1]
            if (x1 - x0) * (p[1] - y0) - (y1 - y0) * (p[0] - x0) > 0:
                break
            hull.pop()
        hull.append(p)
    return hull


def device_clock(lags: Sequence[Tuple[int, int]], windows: int = 64) -> List[Tuple[int, int]]:
    """The device clock's offset from the host's as it drifts: from each
    launch's (host time, device start minus launch time), the least lag of
    each of `windows` stretches of the launches' span, and the lower hull of
    those. The least lag is the launch latency plus the offset wherever a
    launch found the device idle; the hull lies under every stretch's
    least, so no operation is moved before its launch."""
    if not lags:
        return []
    t0, t1 = min(t for t, _ in lags), max(t for t, _ in lags)
    least: Dict[int, Tuple[int, int]] = {}
    for t, lag in lags:
        w = (t - t0) * windows // max(t1 - t0, 1)
        if w not in least or lag < least[w][1]:
            least[w] = (t, lag)
    return lower_hull(least.values())


def clock_offset(clock: Sequence[Tuple[int, int]], t: int) -> int:
    """The offset at host time `t`: the hull's line there (its end values
    beyond its ends)."""
    if not clock:
        return 0
    i = bisect.bisect_right([x for x, _ in clock], t)
    if i == 0:
        return clock[0][1]
    if i == len(clock):
        return clock[-1][1]
    (x0, y0), (x1, y1) = clock[i - 1], clock[i]
    return y0 + (y1 - y0) * (t - x0) // (x1 - x0)


def device_ops(events) -> Tuple[List[trace.DeviceOp], int, List[Tuple[int, int]]]:
    """(device operations on the host's clock, runtime launch calls, the
    device clock) of raw Kineto events of a device-only profile. Each
    operation moves by the offset at its launch (at its own start where the
    profile lost the launch)."""
    from torch.autograd import DeviceType

    launches: Dict[int, int] = {}
    device = []
    runtime_calls = 0
    for evt in events:
        if evt.device_type() == DeviceType.CUDA:
            if not evt.is_user_annotation():
                device.append(evt)
        elif evt.name().startswith("cu") and any(w in evt.name() for w in trace._LAUNCH_WORDS):
            runtime_calls += 1
            if evt.correlation_id():
                launches[evt.correlation_id()] = evt.start_ns()
    found = [launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id())
             for e in device]
    clock = device_clock([(t, e.start_ns() - t) for t, e in zip(found, device) if t is not None])
    ops = [trace.DeviceOp(name=e.name(), dur_ns=e.duration_ns(), spans=(),
                          start_ns=e.start_ns() - clock_offset(clock, e.start_ns() if t is None
                                                               else t))
           for t, e in zip(found, device)]
    return ops, runtime_calls, clock


# ------------------------------------------------------------ interval arithmetic
def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(p: Phase) -> List[Tuple[int, int]]:
    """The phase's stretches with no device operation running."""
    busy = _merge([(o.start_ns, o.start_ns + o.dur_ns) for o in p.profile.ops])
    out, t = [], p.start_ns
    for s, e in busy:
        if s > t:
            out.append((t, min(s, p.end_ns)))
        t = max(t, e)
        if t >= p.end_ns:
            break
    if t < p.end_ns:
        out.append((t, p.end_ns))
    return [(s, e) for s, e in out if e > s]


def idle_ns(p: Phase) -> int:
    return sum(e - s for s, e in idle_intervals(p))


def layer_segments(spans: Sequence) -> List[Tuple[int, int, str]]:
    """The host's time cut into (start, end, layer): in each stretch the
    layer of the innermost layer or driver span open. Spans nest, so the
    innermost open is the one opened last."""
    marks = []
    for s in spans:
        layer = LAYER_OF.get(s.name)
        if layer is not None and s.end_ns > s.start_ns:
            marks.append((s.start_ns, 1, s.end_ns, layer))
            marks.append((s.end_ns, 0, s.start_ns, layer))
    marks.sort(key=lambda m: (m[0], m[1]))
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, int, str]] = []  # (start, end, layer) open, in opening order
    t_prev = None
    for t, opening, other, layer in marks:
        if stack and t_prev is not None and t > t_prev:
            out.append((t_prev, t, stack[-1][2]))
        if opening:
            stack.append((t, other, layer))
        else:
            stack.remove(next(x for x in reversed(stack) if x[1] == t and x[0] == other
                              and x[2] == layer))
        t_prev = t
    return out


def idle_by_layer(p: Phase) -> Dict[str, int]:
    """Nanoseconds of the phase's idle time under each layer (layers that
    appear in the phase; time outside every span is left out)."""
    segments = layer_segments(p.spans)
    out = {layer: 0 for _, _, layer in segments}
    idle = idle_intervals(p)
    i = 0
    for s, e, layer in segments:  # both sorted and each disjoint
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            out[layer] += min(e, idle[j][1]) - max(s, idle[j][0])
            j += 1
    return out


def self_ns(spans: Sequence, names: Sequence[str]) -> int:
    """Time inside spans named `names` that no child span covers."""
    covered: Dict[int, int] = {}
    for s in spans:
        covered[s.parent] = covered.get(s.parent, 0) + (s.end_ns - s.start_ns)
    return sum((s.end_ns - s.start_ns) - covered.get(s.id, 0) for s in spans if s.name in names)


def total_ns(spans: Sequence, name: str) -> Optional[int]:
    durations = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(durations) if durations else None


# ---------------------------------------------------------------------- readers
def _phase(r) -> Optional[Phase]:
    return getattr(r, "program", None)


def _per(p: Phase, per: str) -> int:
    return p.counters.get({"step": "driver.vector_steps", "learn": "driver.learns",
                           "dispatch": "driver.dispatches"}[per], 0)


def span_ms(r, name: str, per: str) -> Optional[float]:
    """Host milliseconds inside the program's spans named `name`, per
    vector step, learn or dispatch of the phase."""
    p = _phase(r)
    if p is None or not _per(p, per):
        return None
    ns = total_ns(p.spans, name)
    return None if ns is None else 1e-6 * ns / _per(p, per)


def driver_self_ms_per_step(r) -> Optional[float]:
    """The driver's own host time (`driver.call` and `driver.dispatch`,
    their children excluded) per vector step."""
    p = _phase(r)
    if p is None or not _per(p, "step"):
        return None
    return 1e-6 * self_ns(p.spans, ("driver.call", "driver.dispatch")) / _per(p, "step")


def host_syncs_per_dispatch(r) -> Optional[float]:
    p = _phase(r)
    if p is None or not _per(p, "dispatch"):
        return None
    return p.counters.get("driver.host_syncs", 0) / _per(p, "dispatch")


def idle_ms(r, layer: str, per: str) -> Optional[float]:
    """Device-idle milliseconds of the phase put down to `layer`, per
    vector step or per learn."""
    p = _phase(r)
    if p is None or not _per(p, per):
        return None
    ns = idle_by_layer(p).get(layer)
    return None if ns is None else 1e-6 * ns / _per(p, per)
