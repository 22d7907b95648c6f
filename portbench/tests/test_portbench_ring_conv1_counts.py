"""The counter of kernel B5 (`counts/ring_conv1.py`) against counts made by
hand at the cells' shapes, and `ring_conv1_roofline` read from them; a run
that never calls the kernel reads nothing."""

import pytest
import torch

from portbench.core import specs

B, T, H, W, k, s = 16384, 4, 84, 84, 8, 4


def operands(OC, dtype):
    """The call as `CNNQValueNetwork` makes it, on shapes alone (the meta
    device holds no memory): ring, valid, wmat, bias positional; H, W, k, s
    by keyword."""
    meta = dict(device="meta")
    args = (torch.empty((B, T, H * W), dtype=dtype, **meta),
            torch.empty((B, T), dtype=torch.bool, **meta),
            torch.empty((T * k * k, OC), dtype=dtype, **meta),
            torch.empty((OC,), dtype=dtype, **meta))
    return args, dict(H=H, W=W, k=k, s=s)


@pytest.mark.parametrize("OC", [16, 32])  # dqn2013_atari84's conv1, nature_dqn_atari84's
@pytest.mark.parametrize("dtype,size,precision",
                         [(torch.bfloat16, 2, "bfloat16"), (torch.float32, 4, "float32")])
def test_ring_conv1_counts_by_hand(OC, dtype, size, precision):
    args, kwargs = operands(OC, dtype)
    # 84x84 frames under an 8x8 kernel at stride 4: 20x20 outputs.
    ring = B * T * 7056 * size  # 925 MB in bfloat16
    out = B * OC * 20 * 20 * size
    small = B * T + T * 64 * OC * size + OC * 4  # valid, wmat, bias in float32
    assert specs.byte_counter("ring_conv1")(args, kwargs) == ring + out + small
    n, got = specs.flop_counter("ring_conv1")(args, kwargs)
    assert n == 2 * B * 400 * OC * 256 and got == precision
    # All by keyword, as a caller may also pass them.
    named = dict(zip(("ring", "valid", "wmat", "bias"), args), **kwargs)
    assert specs.byte_counter("ring_conv1")((), named) == ring + out + small


@pytest.mark.parametrize("OC", [16, 32])
def test_ring_conv1_roofline_is_bound_by_bytes_in_bfloat16(OC):
    """64 calls: the bytes at 3.35 TB/s (0.339 ms a call at OC 16, 0.401 at
    OC 32) outweigh the operations at 989 TFLOP/s (0.054 and 0.109 ms), so
    the roofline is the bytes' time over the device time."""
    from portbench.core import trace
    from portbench.core.cell import Readings
    from portbench.core.spans import OP_PREFIX, Spans

    args, kwargs = operands(OC, torch.bfloat16)
    spans = Spans(specs.byte_counter, specs.flop_counter)
    wrapped = spans._wrap(OP_PREFIX + "ring_conv1", lambda *a, **kw: None,
                          specs.byte_counter("ring_conv1"), specs.flop_counter("ring_conv1"))
    for _ in range(64):
        wrapped(*args, **kwargs)
    nbytes = specs.byte_counter("ring_conv1")(args, kwargs)
    flops = 2 * B * 400 * OC * 256
    assert spans.op_bytes["ring_conv1"] == 64 * nbytes
    assert spans.op_flops["ring_conv1"] == pytest.approx(64 * flops / 989e12, rel=1e-12)
    assert 64 * nbytes / 3.35e12 > 3 * spans.op_flops["ring_conv1"]
    device_ns = 64 * 700_000  # 0.7 ms a call
    profile = trace.Profile(wall_s=1.0, runtime_calls=0, ops=[
        trace.DeviceOp("ring_conv1_mma_kernel", 0, device_ns, (OP_PREFIX + "ring_conv1",))])
    r = Readings(config=specs.load_cell("dqn2013_atari84.train").config, window_s=1.0,
                 vector_steps=1, learns=0, env_steps=1, host_s={}, profile=profile,
                 op_bytes=dict(spans.op_bytes), op_flops=dict(spans.op_flops))
    got = specs.metric_reader("ring_conv1_roofline")(r)
    assert got == pytest.approx(100.0 * (64 * nbytes / 3.35e12) / (device_ns / 1e9), rel=1e-12)


def test_ring_conv1_roofline_reads_nothing_without_the_kernel():
    """A program whose act path never calls the kernel (the fence path)
    gives the metric nothing to read: it is left out, and nothing raises."""
    from portbench.core import trace
    from portbench.core.cell import Readings

    profile = trace.Profile(wall_s=1.0, runtime_calls=0, ops=[
        trace.DeviceOp("masked_scale_vec_kernel", 0, 1000, ("op:masked_scale_fence4",))])
    r = Readings(config=specs.load_cell("dqn2013_atari84.collect").config, window_s=1.0,
                 vector_steps=1, learns=0, env_steps=1, host_s={}, profile=profile,
                 op_bytes={"masked_scale_fence4": 10}, op_flops={})
    assert specs.metric_reader("ring_conv1_roofline")(r) is None
