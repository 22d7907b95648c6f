"""The counter of the env's frame kernel (`counts/synthetic_frames.py`)
against counts made by hand at the cells' shapes, and
`synthetic_frames_roofline` read from them; a run that never calls the kernel
(a program without it, or a CPU run) reads nothing."""

import pytest
import torch

from portbench.core import specs

B, H, W, FRAMES = 16384, 84, 84, 1


def operands(dtype):
    """The call as `SyntheticAtari.step_autoreset` makes it, on shapes alone
    (the meta device holds no memory): phase, t, fresh_phase, done
    positional; H, W, frames, dtype by keyword."""
    meta = dict(device="meta")
    args = (torch.empty((B,), dtype=torch.float32, **meta),
            torch.empty((B,), dtype=torch.int32, **meta),
            torch.empty((B,), dtype=torch.float32, **meta),
            torch.empty((B,), dtype=torch.bool, **meta))
    return args, dict(H=H, W=W, frames=FRAMES, dtype=dtype)


@pytest.mark.parametrize("dtype,size", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_synthetic_frames_bytes_by_hand(dtype, size):
    args, kwargs = operands(dtype)
    outputs = 2 * B * 7056 * size  # obs and next_obs: 462 MB in bfloat16
    inputs = B * (4 + 4 + 4 + 1)  # phase, t, fresh_phase, done
    count = specs.byte_counter("synthetic_frames")
    assert count(args, kwargs) == outputs + inputs
    named = dict(zip(("phase", "t", "fresh_phase", "done"), args), **kwargs)
    assert count((), named) == outputs + inputs
    assert specs.flop_counter("synthetic_frames") is None


def test_synthetic_frames_roofline_is_the_bytes_time_over_the_device_time():
    """64 calls at 0.17 ms a call: the bytes at 3.35 TB/s (0.138 ms a call)
    over the device time in the op's spans."""
    from portbench.core import trace
    from portbench.core.cell import Readings
    from portbench.core.spans import OP_PREFIX, Spans

    args, kwargs = operands(torch.bfloat16)
    spans = Spans(specs.byte_counter, specs.flop_counter)
    wrapped = spans._wrap(OP_PREFIX + "synthetic_frames", lambda *a, **kw: None,
                          specs.byte_counter("synthetic_frames"),
                          specs.flop_counter("synthetic_frames"))
    for _ in range(64):
        wrapped(*args, **kwargs)
    nbytes = specs.byte_counter("synthetic_frames")(args, kwargs)
    assert spans.op_bytes["synthetic_frames"] == 64 * nbytes
    assert "synthetic_frames" not in spans.op_flops
    assert nbytes / 3.35e12 == pytest.approx(0.138e-3, rel=0.01)
    device_ns = 64 * 170_000
    profile = trace.Profile(wall_s=1.0, runtime_calls=0, ops=[
        trace.DeviceOp("synthetic_frames_kernel", 0, device_ns,
                       (OP_PREFIX + "synthetic_frames",))])
    r = Readings(config=specs.load_cell("dqn2013_atari84.train").config, window_s=1.0,
                 vector_steps=1, learns=0, env_steps=1, host_s={}, profile=profile,
                 op_bytes=dict(spans.op_bytes), op_flops=dict(spans.op_flops))
    got = specs.metric_reader("synthetic_frames_roofline")(r)
    assert got == pytest.approx(100.0 * (64 * nbytes / 3.35e12) / (device_ns / 1e9), rel=1e-12)


def test_synthetic_frames_roofline_reads_nothing_without_the_kernel():
    from portbench.core import trace
    from portbench.core.cell import Readings

    profile = trace.Profile(wall_s=1.0, runtime_calls=0, ops=[
        trace.DeviceOp("elementwise_kernel", 0, 1000, ("env",))])
    r = Readings(config=specs.load_cell("dqn2013_atari84.collect").config, window_s=1.0,
                 vector_steps=1, learns=0, env_steps=1, host_s={}, profile=profile,
                 op_bytes={"ring_write_where": 10}, op_flops={})
    assert specs.metric_reader("synthetic_frames_roofline")(r) is None
