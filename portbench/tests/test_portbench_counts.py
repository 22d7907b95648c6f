"""The FLOP counters of both CNNs and the byte counters of the three kernels
against counts made by hand."""

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
