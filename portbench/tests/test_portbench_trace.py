"""The reduction of profiled events and the readers' arithmetic, on made-up
events and readings."""

from types import SimpleNamespace

import pytest

from portbench.core import readers, specs, trace
from portbench.core.cell import Readings


def test_union_and_spans():
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    ranges = [("act", 0, 100), ("op:copy_fence", 10, 20), ("env", 150, 200)]
    assert trace.spans_at(ranges, [15, 50, 120, 160]) == [
        ("act", "op:copy_fence"), ("act",), (), ("env",)]


def _profile():
    ops = [trace.DeviceOp("k1", 0, 100, ("act",)),
           trace.DeviceOp("k2", 150, 50, ("act", "op:copy_fence")),
           trace.DeviceOp("k1", 300, 100, ()),
           trace.DeviceOp("k3", 1000, 0, ("env",))]
    return trace.Profile(wall_s=2e-6, ops=ops, runtime_calls=8)


def test_profile_sums():
    p = _profile()
    assert p.busy_s == pytest.approx(250e-9)
    assert p.device_s("act") == pytest.approx(150e-9)
    assert p.top_ops(2) == [["k1", 200e-9], ["k2", 50e-9]]
    assert p.idle_gaps() == [["env", 600e-9], ["driver", 100e-9], ["op:copy_fence", 50e-9]]


def test_readers_on_made_up_readings():
    cfg = specs.load_cell("dqn2013_atari84.train").config
    p = _profile()
    r = Readings(config=cfg, window_s=2.0, vector_steps=100, learns=10, env_steps=409600,
                 host_s={"act": 0.1}, profile=p, device_profile=p, profiled_steps=4, profiled_learns=1,
                 op_bytes={"copy_fence": 335}, tf32={"matmul": False, "cudnn": False})
    assert readers.host_ms(r, "act") == pytest.approx(1.0)
    assert readers.host_ms(r, "env") is None
    assert readers.device_ms(r, "act") == pytest.approx(150e-9 * 1e3 / 4)
    # 335 bytes at 3.35e12 B/s is 1e-10 s, over the op's 50 ns.
    assert readers.roofline(r, "copy_fence") == pytest.approx(0.2)
    assert readers.roofline(r, "ring_write_where") is None
    assert readers.idle_share(r) == pytest.approx(100 * (1 - 250e-9 / 2e-6))
    assert readers.runtime_calls_per_step(r) == 2
    act = 409600 * 5_934_080 / 989e12
    learn = 10 * (512 * 2 * (3 * 1_638_400 + 4 * 663_552) / 67e12
                  + 512 * 2 * 4 * (2592 * 256 + 256 * 6) / 67e12)
    assert readers.mfu(r) == pytest.approx(100 * (act + learn) / 2.0)
    empty = SimpleNamespace(profile=None, device_profile=None, profiled_steps=0)
    assert readers.idle_share(empty) is None and readers.runtime_calls_per_step(empty) is None
