"""The readers of the program's own spans (`core/program.py`) on made-up
spans and device operations."""

from types import SimpleNamespace

import pytest

from portbench.core import program, specs, trace
from portbench.core.cell import Readings

NEW_METRICS = ("driver.host_ms_per_step", "driver.fetch_ms_per_dispatch",
               "driver.host_syncs_per_dispatch", "history.host_ms_per_step",
               "replay.push_host_ms_per_step", "replay.sample_host_ms_per_learn",
               "driver.idle_ms_per_step", "act.idle_ms_per_step", "env.idle_ms_per_step",
               "observe.idle_ms_per_step", "learn.idle_ms_per_learn")


def _span(id, name, start, end, parent):
    return SimpleNamespace(id=id, name=name, start_ns=start, end_ns=end, parent=parent,
                           dispatch=0)


def _phase(learn=True):
    """One call [0, 980] of one dispatch [10, 900] and its fetch [920, 970]
    in a phase [0, 1000]; the last 20 ns are the harness's."""
    spans = [
        _span(0, "driver.call", 0, 980, -1),
        _span(1, "driver.dispatch", 10, 900, 0),
        _span(2, "agent.act", 20, 100, 1),
        _span(3, "op.copy_fence", 30, 50, 2),
        _span(4, "env.step", 100, 200, 1),
        _span(5, "agent.observe", 200, 400, 1),
        _span(6, "history.advance", 210, 300, 5),
        _span(7, "replay.push", 300, 350, 5),
        _span(10, "driver.fetch", 920, 970, 0),
    ]
    if learn:
        spans += [_span(8, "agent.learn", 400, 800, 1),
                  _span(9, "replay.sample", 410, 500, 8),
                  _span(11, "learner.update", 500, 790, 8)]
    ops = [trace.DeviceOp("k", s, e - s, ()) for s, e in
           ((0, 15), (60, 150), (380, 600), (950, 960))]
    counters = {"driver.vector_steps": 2, "driver.learns": 1 if learn else 0,
                "driver.dispatches": 1, "driver.host_syncs": 1}
    return program.Phase(spans=spans, counters=counters,
                         profile=trace.Profile(wall_s=1e-6, ops=ops, runtime_calls=0),
                         start_ns=0, end_ns=1000)


def _readings(phase):
    r = Readings(config={}, window_s=1.0, vector_steps=0, learns=0, env_steps=0, host_s={})
    r.program = phase
    return r


def test_self_time_leaves_out_the_children():
    spans = _phase().spans
    # call: 980 less its dispatch (890) and fetch (50); dispatch: 890 less
    # act, env, observe and learn (80 + 100 + 200 + 400).
    assert program.self_ns(spans, ("driver.call",)) == 40
    assert program.self_ns(spans, ("driver.dispatch",)) == 110
    assert program.self_ns(spans, ("agent.observe",)) == 200 - 90 - 50
    r = _readings(_phase())
    assert program.driver_self_ms_per_step(r) == pytest.approx(150e-6 / 2)


def test_idle_is_put_down_to_the_top_level_layer():
    p = _phase()
    assert program.idle_intervals(p) == [(15, 60), (150, 380), (600, 950), (960, 1000)]
    # The op under act, history and replay under observe, sample and update
    # under learn count toward their layer; the fetch and the call's own
    # time toward the driver; 980-1000 toward none.
    assert program.idle_by_layer(p) == {"driver": 5 + 150 + 20, "act": 40, "env": 50,
                                        "observe": 180, "learn": 200}
    placed = sum(program.idle_by_layer(p).values())
    assert placed + 20 == program.idle_ns(p) == 45 + 230 + 350 + 40


@pytest.mark.parametrize("learn", [True, False])
def test_layers_partition_the_placed_idle(learn):
    p = _phase(learn)
    segments = program.layer_segments(p.spans)
    for (_, e0, _), (s1, _, _) in zip(segments, segments[1:]):
        assert e0 <= s1
    assert segments[0][0] == 0 and segments[-1][1] == 980
    assert sum(e - s for s, e, _ in segments) == 980
    r = _readings(p)
    layers = {"driver": program.idle_ms(r, "driver", "step") * 2,
              "act": program.idle_ms(r, "act", "step") * 2,
              "env": program.idle_ms(r, "env", "step") * 2,
              "observe": program.idle_ms(r, "observe", "step") * 2}
    if learn:
        layers["learn"] = program.idle_ms(r, "learn", "learn")
    assert sum(layers.values()) == pytest.approx(1e-6 * (program.idle_ns(p) - 20))


def test_metric_files_read_the_phase():
    r = _readings(_phase())
    got = {name: specs.metric_reader(name)(r) for name in NEW_METRICS}
    assert got == pytest.approx({
        "driver.host_ms_per_step": 75e-6, "driver.fetch_ms_per_dispatch": 50e-6,
        "driver.host_syncs_per_dispatch": 1.0, "history.host_ms_per_step": 45e-6,
        "replay.push_host_ms_per_step": 25e-6, "replay.sample_host_ms_per_learn": 90e-6,
        "driver.idle_ms_per_step": 87.5e-6, "act.idle_ms_per_step": 20e-6,
        "env.idle_ms_per_step": 25e-6, "observe.idle_ms_per_step": 90e-6,
        "learn.idle_ms_per_learn": 200e-6})


def test_none_where_there_is_nothing_to_read():
    collect = {name: specs.metric_reader(name)(_readings(_phase(learn=False)))
               for name in NEW_METRICS}
    assert collect["replay.sample_host_ms_per_learn"] is None
    assert collect["learn.idle_ms_per_learn"] is None
    assert all(v is not None for k, v in collect.items() if "learn" not in k)
    # A program without tracing of its own: no phase, every reader None.
    bare = Readings(config={}, window_s=1.0, vector_steps=0, learns=0, env_steps=0, host_s={})
    assert all(specs.metric_reader(name)(bare) is None for name in NEW_METRICS)
    empty = _phase()
    empty.counters = {}
    assert program.span_ms(_readings(empty), "replay.push", "step") is None
    assert program.idle_ms(_readings(empty), "act", "step") is None


def test_device_clock_follows_a_drift():
    import random

    rng = random.Random(0)
    # Offset -3.5 ms drifting 3.3 ms a second, launch latency 4 us; a third
    # of the launches find the device idle, the rest wait in its queue.
    truth = lambda t: -3_500_000 + 33 * t // 10_000  # noqa: E731
    lags = []
    for i in range(5000):
        t = i * 360_000 + rng.randrange(1000)
        wait = 0 if rng.random() < 0.33 else rng.randrange(2_000_000)
        lags.append((t, truth(t) + 4_000 + wait))
    clock = program.device_clock(lags)
    assert all(program.clock_offset(clock, t) <= lag for t, lag in lags)
    for t in range(0, 1_800_000_000, 50_000_000):
        assert abs(program.clock_offset(clock, t) - (truth(t) + 4_000)) < 20_000
    assert program.clock_offset([], 5) == 0
    assert program.lower_hull([(0, 5), (1, 1), (2, 4), (3, 0), (4, 6)]) == [(0, 5), (1, 1), (3, 0),
                                                                            (4, 6)]


def test_device_ops_move_onto_the_host_clock():
    from torch.autograd import DeviceType

    def evt(name, device, start, dur, corr, linked=0):
        return SimpleNamespace(name=lambda: name, device_type=lambda: device,
                               start_ns=lambda: start, duration_ns=lambda: dur,
                               correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
                               is_user_annotation=lambda: False)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    # The device clock reads 1000 ns behind at the first launch, 900 at the
    # second: each kernel moves by the offset at its launch.
    events = [evt("cudaLaunchKernel", cpu, 10_000, 5, 1), evt("k1", cuda, 9_005, 100, 1),
              evt("cudaLaunchKernel", cpu, 20_000, 5, 2), evt("k2", cuda, 19_105, 100, 2),
              evt("cudaMemcpyAsync", cpu, 30_000, 5, 3), evt("copy", cuda, 29_500, 10, 0, 3),
              evt("other", cpu, 31_000, 5, 4)]
    ops, calls, clock = program.device_ops(events)
    assert calls == 3 and clock == [(10_000, -995), (20_000, -895), (30_000, -500)]
    assert [(o.name, o.start_ns) for o in ops] == [("k1", 10_000), ("k2", 20_000),
                                                    ("copy", 30_000)]


def test_a_cpu_run_has_no_program_phase(tiny_cell):
    """The traced phase runs on the card alone: a traced CPU run leaves
    `readings.program` None and reports none of its metrics."""
    import time

    from portbench.core import cell as cell_mod

    name = "dqn2013_atari84.train"
    per_layer = [m["name"] for m in specs.cell_metrics(specs.benchmark(), name, "per_layer")]
    assert set(NEW_METRICS) <= set(per_layer)
    out = cell_mod.run(tiny_cell(name), 2**31 + 17, 0.2, True, "cpu", time.perf_counter(),
                       {"end_to_end": [], "per_layer": per_layer})
    assert out["readings"].program is None
    assert out["metrics"] and not set(out["metrics"]) & set(NEW_METRICS)
