"""The act path's choice of conv1 under `CNNQValueNetwork`'s default
`ring_conv=None`: the rule (`act_takes_ring_conv`), the geometry decided at
construction, the CPU's Q unchanged; and on the card, at the benchmark's
sizes, the ring conv (kernel B5) as the default act conv1. Imports no JAX, so
that the card tests run on a machine without it (`pytest --noconftest -m
cuda` there).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import pearl_tpu_torch.neural_networks.q_value_networks as qvn
from pearl_tpu_torch.history_summarization_modules import FrameRingView
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.ops import ring_conv as trc

A = 5
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "ring_conv,fits,dtype,device_type,takes",
    [
        (None, True, BF16, "cuda", True),  # the card's bfloat16 ring: B5
        (None, True, F32, "cuda", False),  # a float32 ring keeps the fences
        (None, True, BF16, "cpu", False),  # so does every CPU ring
        (None, False, BF16, "cuda", False),  # a conv1 the kernel does not take
        (False, True, BF16, "cuda", False),  # the library's conv1, asked for
        (True, True, F32, "cpu", True),  # asked for: the plain version on the CPU
        (True, True, BF16, "cuda", True),
    ],
)
def test_act_takes_ring_conv_rule(ring_conv, fits, dtype, device_type, takes):
    assert qvn.act_takes_ring_conv(ring_conv, fits, dtype, device_type) is takes


# conv1 of the benchmark's two configurations (portbench/configs/): the 2013
# DQN's 16@8x8/4 and Nature DQN's 32@8x8/4 over 84x84 windows of 4 frames.
CELL_NETS = {
    "dqn2013": dict(out_channels=(16, 32), kernel_sizes=(8, 4), strides=(4, 2),
                    paddings=(0, 0), hidden_dims=(256,)),
    "nature": dict(out_channels=(32, 64, 64), kernel_sizes=(8, 4, 3), strides=(4, 2, 1),
                   paddings=(0, 0, 0), hidden_dims=(512,)),
}


def _cell_net(name):
    return CNNQValueNetwork(input_shape=(84, 84, 4), time_major_stack=True, **CELL_NETS[name])


@pytest.mark.parametrize(
    "kw,fits",
    [
        (CELL_NETS["dqn2013"], True),
        (CELL_NETS["nature"], True),
        (dict(paddings=(1, 0)), False),
        (dict(out_channels=(12, 32)), False),
        (dict(input_shape=(84, 84, 8), frame_channels=2), False),
        (dict(time_major_stack=False), False),
        # Fits B5's shared memory at bfloat16's 2 bytes an element and not at
        # float32's 4: the default keeps the fences, as True refuses it.
        (dict(input_shape=(8, 2000, 4), out_channels=(4, 8), kernel_sizes=(8, 1),
              strides=(4, 1)), False),
    ],
)
def test_default_decides_the_geometry_at_construction_without_a_word(kw, fits):
    args = {"input_shape": (84, 84, 4), "time_major_stack": True, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        net = CNNQValueNetwork(**args)
    assert net.ring_conv is None and net._ring_conv_fits is fits
    assert dataclasses.replace(net, hidden_dims=(8,))._ring_conv_fits is fits
    if not fits and kw.get("time_major_stack", True):
        with pytest.raises(ValueError, match="ring_conv=True"):
            CNNQValueNetwork(**{**args, "ring_conv": True})


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_default_on_a_cpu_ring_computes_the_fence_path_bit_for_bit(dtype, monkeypatch):
    calls = []
    real = trc.ring_conv1
    monkeypatch.setattr(qvn, "ring_conv1", lambda *a, **k: calls.append(1) or real(*a, **k))
    net = CNNQValueNetwork(input_shape=(20, 20, 4), hidden_dims=(24,), time_major_stack=True)
    fence_net = dataclasses.replace(net, ring_conv=False)
    assert net._ring_conv_fits
    module = net.init(torch.Generator().manual_seed(4), 0, 0, A).to(dtype)
    rng = np.random.default_rng(4)
    ring = torch.from_numpy(rng.integers(0, 256, (6, 4, 400)).astype(np.float32)).to(dtype)
    valid = torch.from_numpy(rng.random((6, 4)) < 0.7)
    with torch.no_grad():
        for cursor in range(4):
            view = FrameRingView(ring, valid, cursor)
            assert torch.equal(net.q_all(module, view, None), fence_net.q_all(module, view, None))
    assert calls == []


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELL_NETS))
def test_default_act_path_is_the_ring_conv_at_the_cells_size_on_card(name):
    """16384 envs of 4 bfloat16 84x84 frames (925 MB of ring): the default
    net's acting Q is the ring conv's bit for bit, in the tensor-core body,
    and the fence path's within the bfloat16 forward's 3e-2 (of |Q| or 1)."""
    dev = _card()
    B = 16384
    net = _cell_net(name)
    module = net.init(torch.Generator().manual_seed(5), 0, 0, 6).to(dev, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(5)
    ring = torch.randint(0, 256, (B, 4, 84 * 84), generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand((B, 4), generator=g, device=dev) < 0.7
    valid[0] = False
    valid[-1] = True
    forced, fenced = dataclasses.replace(net, ring_conv=True), dataclasses.replace(net, ring_conv=False)
    assert trc.pick_body(torch.bfloat16, 4, 84, 84, 8, 4, net.out_channels[0]) == "mma"
    with torch.no_grad():
        for cursor in range(4):
            view = FrameRingView(ring, valid, cursor)
            before = (trc.ring_conv1.launches, trc.ring_conv1.mma_launches)
            got = net.q_all(module, view, None)
            assert (trc.ring_conv1.launches, trc.ring_conv1.mma_launches) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(got, forced.q_all(module, view, None))
            plain = fenced.q_all(module, view, None)
            assert trc.ring_conv1.launches == before[0] + 2  # the fences launched none
            assert got.shape == (B, 6) and got.dtype == torch.bfloat16
            bound = 3e-2 * max(1.0, plain.float().abs().max().item())
            torch.testing.assert_close(got.float(), plain.float(), rtol=0, atol=bound)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELL_NETS))
def test_a_benchmark_shaped_dispatch_acts_through_the_ring_conv_on_card(name):
    """One `online_learning` dispatch as the benchmark's train cells run it
    (16384 envs, 8 chunks of 8 vector steps, a learn of 512 every 8 steps):
    64 ring convs, all in the tensor-core body, and the masked fence only in
    the learns (an online and a target window each)."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import SyntheticAtari
    from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
    from pearl_tpu_torch.ops.layout_fence import masked_scale_fence4
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import VisualReplayBuffer
    from pearl_tpu_torch.training.online import online_learning

    _card()
    B, k, chunks = 16384, 8, 8
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=_cell_net(name), exploration=EGreedyExploration(epsilon=0.05),
            training_rounds=1, batch_size=512, act_dtype="bfloat16",
            history_summarizer=FrameRingHistorySummarization(history_length=4,
                                                             dtype=torch.bfloat16),
        ),
        replay_buffer=VisualReplayBuffer(capacity=8 * B, stack=4, num_envs=B,
                                         frame_dtype=torch.bfloat16, dedup_next=True),
    )
    env = SyntheticAtari(height=84, width=84, frames=1, num_actions=6, episode_len=128,
                         obs_dtype=torch.bfloat16)
    state = env_states = None
    for dispatch in range(2):  # the first builds the kernels
        before = (trc.ring_conv1.launches, trc.ring_conv1.mma_launches,
                  masked_scale_fence4.launches)
        res = online_learning(
            agent, env, num_envs=B, max_steps=B * k * chunks, learn_every_k_steps=k,
            chunks_per_dispatch=chunks, seed=dispatch, agent_state=state,
            env_states=env_states, stats="summary", target_return=1e9,
        )
        state, env_states = res.agent_state, res.env_states
        torch.cuda.synchronize()
        after = (trc.ring_conv1.launches, trc.ring_conv1.mma_launches,
                 masked_scale_fence4.launches)
        assert [a - b for a, b in zip(after, before)] == [k * chunks, k * chunks, 2 * chunks]
    assert state.learner.step == 2 * chunks
    assert all(torch.isfinite(p).all() for p in state.learner.params.parameters())
