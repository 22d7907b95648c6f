"""The FLOP counters of both CNNs and the byte counters of the three kernels
against counts made by hand, and device.mfu and the three rooflines against
the formulas they had before the count modules and op operations."""

import pytest
import torch

from portbench.core import specs
from portbench.counts import cnn


def config(name):
    return specs.load_cell(f"{name}.train").config


def test_dqn2013_cnn_flops_by_hand():
    # conv1: 16 x (20 x 20) outputs over 4 x 8 x 8 inputs; conv2: 32 x (9 x 9)
    # over 16 x 4 x 4; fc 2592 -> 256; head 256 -> 6. Two operations a MAC.
    conv1, conv2 = 16 * 400 * 256, 32 * 81 * 256
    fc, head = 2592 * 256, 256 * 6
    cfg = config("dqn2013_atari84")
    assert cnn.forward_flops(cfg) == 2 * (conv1 + conv2 + fc + head) == 5_934_080
    assert cnn.forward_flops(cfg) == round(cfg["forward_mflop_per_frame"] * 1e6)
    learn = cnn.learn_flops(cfg)
    assert learn["conv"] == 512 * 2 * (3 * conv1 + 4 * conv2)
    assert learn["dense"] == 512 * 2 * 4 * (fc + head)


def test_nature_cnn_flops_by_hand():
    # 32@8x8/4 -> 20x20, 64@4x4/2 -> 9x9, 64@3x3/1 -> 7x7, fc 3136 -> 512 -> 6.
    conv = [32 * 400 * 4 * 64, 64 * 81 * 32 * 16, 64 * 49 * 64 * 9]
    dense = [3136 * 512, 512 * 6]
    cfg = config("nature_dqn_atari84")
    assert cnn.forward_flops(cfg) == 2 * (sum(conv) + sum(dense)) == 18_692_096
    assert cnn.forward_flops(cfg) == round(cfg["forward_mflop_per_frame"] * 1e6)
    learn = cnn.learn_flops(cfg)
    assert learn["conv"] == 512 * 2 * (3 * conv[0] + 4 * conv[1] + 4 * conv[2])
    assert learn["dense"] == 512 * 2 * 4 * sum(dense)


@pytest.mark.parametrize("dtype,size", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_kernel_bytes_by_hand(dtype, size):
    B, T, F = 4096, 4, 7056
    ring = torch.empty((B, T, F), dtype=dtype)
    frame = torch.empty((B, F), dtype=dtype)
    done = torch.empty((B,), dtype=torch.bool)
    valid = torch.empty((B, T), dtype=torch.bool)
    rww = specs.byte_counter("ring_write_where")
    assert rww((ring, frame, frame, done, 0), {}) == 2 * B * F * size + B
    copy = specs.byte_counter("copy_fence")
    assert copy((ring[:, 0],), {}) == 2 * B * F * size
    fence = specs.byte_counter("masked_scale_fence4")
    assert fence((ring, valid), {"H": 84, "W": 84}) == 2 * B * T * F * size + B * T


# The formula of device.mfu before configurations named their count module:
# each act's forward at bf16's peak; each learn's convolutions at the cuDNN
# flag's peak and its dense layers at the matmul flag's (TF32 495 TFLOP/s when
# on, float32 67 when off), worked out here by hand.
FORWARD = {"dqn2013_atari84": 5_934_080, "nature_dqn_atari84": 18_692_096}
LEARN = {
    "dqn2013_atari84": (512 * 2 * (3 * 16 * 400 * 256 + 4 * 32 * 81 * 256),
                        512 * 2 * 4 * (2592 * 256 + 256 * 6)),
    "nature_dqn_atari84": (512 * 2 * (3 * 32 * 400 * 4 * 64 + 4 * 64 * 81 * 32 * 16
                                      + 4 * 64 * 49 * 64 * 9),
                           512 * 2 * 4 * (3136 * 512 + 512 * 6)),
}


@pytest.mark.parametrize("cudnn,matmul", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("name", sorted(FORWARD))
def test_mfu_reads_as_the_old_formula(name, cudnn, matmul):
    from portbench.core import readers
    from portbench.core.cell import Readings

    r = Readings(config=config(name), window_s=2.0, vector_steps=100, learns=10,
                 env_steps=409600, host_s={}, tf32={"matmul": matmul, "cudnn": cudnn})
    conv, dense = LEARN[name]
    act = 409600 * FORWARD[name] / 989e12
    learn = 10 * (conv / (495e12 if cudnn else 67e12) + dense / (495e12 if matmul else 67e12))
    assert readers.mfu(r) == 100 * (act + learn) / 2.0
    assert specs.metric_reader("device.mfu")(r) == readers.mfu(r)
    collect = Readings(config=config(name), window_s=2.0, vector_steps=100, learns=0,
                       env_steps=409600, host_s={}, tf32={"matmul": matmul, "cudnn": cudnn})
    assert readers.mfu(collect) == 100 * act / 2.0


def test_byte_bound_rooflines_read_as_the_old_formula():
    """The three counters count bytes alone: each roofline is the call's
    bytes at 3.35 TB/s over the op's device time, as before."""
    from portbench.core import trace
    from portbench.core.cell import Readings
    from portbench.core.spans import OP_PREFIX, Spans

    B, T, F = 4096, 4, 7056
    ring = torch.empty((B, T, F), dtype=torch.bfloat16)
    frame = torch.empty((B, F), dtype=torch.bfloat16)
    calls = {"ring_write_where": ((ring, frame, frame, torch.empty((B,), dtype=torch.bool), 0),
                                  {}, 2 * B * F * 2 + B),
             "copy_fence": ((ring[:, 0],), {}, 2 * B * F * 2),
             "masked_scale_fence4": ((ring, torch.empty((B, T), dtype=torch.bool)),
                                     {"H": 84, "W": 84}, 2 * B * T * F * 2 + B * T)}
    spans = Spans(specs.byte_counter, specs.flop_counter)
    ops, device_ns = [], {}
    for i, (op, (args, kwargs, _)) in enumerate(calls.items()):
        assert specs.flop_counter(op) is None
        wrapped = spans._wrap(OP_PREFIX + op, lambda *a, **k: None, specs.byte_counter(op),
                              specs.flop_counter(op))
        for _ in range(64):
            wrapped(*args, **kwargs)
        device_ns[op] = 64 * (20_000 + 1_000 * i)
        ops.append(trace.DeviceOp(op, 0, device_ns[op], (OP_PREFIX + op,)))
    assert dict(spans.op_flops) == {}
    profile = trace.Profile(wall_s=1.0, ops=ops, runtime_calls=0)
    r = Readings(config=config("dqn2013_atari84"), window_s=1.0, vector_steps=1, learns=0,
                 env_steps=1, host_s={}, profile=profile, op_bytes=dict(spans.op_bytes),
                 op_flops=dict(spans.op_flops))
    for op, (_, _, nbytes) in calls.items():
        assert r.op_bytes[op] == 64 * nbytes
        old = 100.0 * (64 * nbytes / 3.35e12) / (device_ns[op] / 1e9)
        assert specs.metric_reader(f"{op}_roofline")(r) == old
