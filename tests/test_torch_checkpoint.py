"""The port's state comparison (`utils.pytree.compare`, `tree_allclose`),
checkpointing (`utils/checkpoint.py`) and profiling (`utils/profiling.py`) on
the CPU.

`compare` is held to the reference's semantics (`pearl_tpu/utils/pytree.py`,
`tests/test_compare_semantics.py`): a float leaf within the tolerance, an
integer leaf exactly. A checkpoint is one `torch.save` of the whole state:
the tests hold that a restored state equals the saved one, that its
generators go on with the same streams, that its optimizers step its own
networks, and that a restored conv1-cache agent carries a cache that equals
a refresh from its restored weights (no stale cache after a whole-state
restore).
"""

import dataclasses
import os

import pytest
import torch
from torch import nn

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole, SyntheticAtari, VectorEnv
from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    DeepQLearning,
    SoftActorCritic,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, VisualReplayBuffer
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils import compare, tree_allclose
from pearl_tpu_torch.utils.checkpoint import restore, save
from pearl_tpu_torch.utils.profiling import timed, trace
from pearl_tpu_torch.utils.pytree import named_leaves, walk_leaves

torch.set_num_threads(1)

CPU = "cpu"


@dataclasses.dataclass
class _Toy:
    net: nn.Module
    opt: torch.optim.Optimizer
    gen: torch.Generator
    step: int
    counts: torch.Tensor
    extra: tuple


def _toy(seed=0):
    torch.manual_seed(seed)
    net = nn.Linear(3, 2)
    opt = torch.optim.AdamW(net.parameters(), lr=torch.tensor(1e-3))
    net(torch.randn(4, 3)).square().sum().backward()
    opt.step()
    return _Toy(net=net, opt=opt, gen=torch.Generator().manual_seed(seed), step=3,
                counts=torch.tensor([5, 7]), extra=(1.5, None, {"a": torch.ones(2)}))


def test_compare_names_a_changed_float_leaf_and_an_integer_leaf_off_by_one():
    a, b = _toy(), _toy()
    assert compare(a, b) == "" and tree_allclose(a, b)
    with torch.no_grad():
        b.net.weight[0, 0] += 1e-3
    assert compare(a, b).startswith(".net.weight: max abs diff 1.000e-03")
    assert not tree_allclose(a, b)
    # Within the tolerance a float leaf agrees; an integer never does.
    c = _toy()
    with torch.no_grad():
        c.net.bias[0] += 1e-9
    c.counts[1] += 1
    assert compare(a, c) == ".counts: integer/bool leaves differ"
    assert compare(a, dataclasses.replace(_toy(), step=4)) == ".step: 3 vs 4"


def test_compare_reports_generators_optimizer_state_and_structure():
    a, b = _toy(), _toy()
    torch.rand(1, generator=b.gen)
    assert compare(a, b) == ".gen: integer/bool leaves differ"
    b = _toy()
    b.opt.param_groups[0]["lr"].fill_(2e-3)
    assert compare(a, b).startswith(".opt.param_groups[0].lr: max abs diff")
    b = _toy()
    b.opt.state[b.net.weight]["step"] += 1
    assert compare(a, b).startswith(".opt.state[0].step: max abs diff")
    diff = compare(a, dataclasses.replace(_toy(), extra=(1.5, None)))
    assert diff.startswith("structures differ") and "['a']" in diff
    assert compare(a, dataclasses.replace(_toy(), extra=(1.5, torch.ones(1), {"a": torch.ones(2)})))
    names = [n for n, _ in named_leaves(a)]
    assert names[:2] == [".net.weight", ".net.bias"] and ".opt.param_groups[0].lr" in names
    with pytest.raises(TypeError, match="cannot flatten a object"):
        list(walk_leaves({"x": object()}))


def test_checkpoint_keeps_streams_optimizer_binding_and_values(tmp_path):
    """A CPU generator and an AdamW with a tensor lr beside its module
    round-trip: the restored generator continues the stream, the restored
    optimizer steps the restored module."""
    state = _toy()
    path = str(tmp_path / "sub" / "toy.pt")
    save(path, state)
    assert os.path.exists(path)
    back = restore(path, _toy(1))
    assert compare(state, back, rtol=0, atol=0) == ""
    assert back.opt.param_groups[0]["params"][0] is back.net.weight
    assert torch.equal(torch.rand(5, generator=back.gen), torch.rand(5, generator=state.gen))
    for s in (state, back):
        s.opt.zero_grad(set_to_none=True)  # a gradient is not part of a checkpoint
        s.net(torch.ones(4, 3)).sum().backward()
        s.opt.step()
    assert compare(state, back, rtol=0, atol=0) == ""
    with pytest.raises(ValueError, match="another structure"):
        restore(path, dataclasses.replace(_toy(), extra=()))


def test_checkpoint_of_an_agent_state_continues_its_generators(tmp_path):
    """Discrete SAC's state holds a device generator: after a restore it
    draws what the saved state draws, and learning goes on identically."""
    agent = PearlAgent(policy_learner=SoftActorCritic(training_rounds=1, batch_size=16),
                       replay_buffer=BasicReplayBuffer(capacity=256))
    res = online_learning(agent, CartPole(), num_envs=4, max_steps=256, learn_every_k_steps=8,
                          learning_starts=64, seed=0, device=CPU)
    save(str(tmp_path / "sac"), res.agent_state)
    back = restore(str(tmp_path / "sac"), res.agent_state)
    assert compare(res.agent_state, back, rtol=0, atol=0) == ""
    gens = [g for _, g in walk_leaves(res.agent_state) if isinstance(g, torch.Generator)]
    back_gens = [g for _, g in walk_leaves(back) if isinstance(g, torch.Generator)]
    assert gens and len(gens) == len(back_gens)
    for a, b in zip(gens, back_gens):
        assert a is not b
        assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))
    bound = agent.for_env(CartPole())
    gen_a, gen_b = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    after_a, _ = bound.learn(res.agent_state, gen_a)
    after_b, _ = bound.learn(back, gen_b)
    assert compare(after_a, after_b, rtol=0, atol=0) == ""


def test_whole_state_restore_leaves_no_stale_conv1_cache(tmp_path):
    """A conv1-cache visual agent, restored whole: its cache equals
    `refresh_cache` of the restored weights over the restored ring."""
    T, B = 4, 8
    net = CNNQValueNetwork(input_shape=(12, 12, T), kernel_sizes=(4, 2), strides=(2, 1),
                           hidden_dims=(32,), time_major_stack=True, conv1_cache=True)
    agent = PearlAgent(
        policy_learner=DeepQLearning(q_network=net, training_rounds=1, batch_size=16,
                                     history_summarizer=FrameRingHistorySummarization(T)),
        replay_buffer=VisualReplayBuffer(capacity=8 * B, stack=T, num_envs=B, dedup_next=True),
    )
    env = SyntheticAtari(height=12, width=12, frames=1, episode_len=5)
    res = online_learning(agent, env, num_envs=B, max_steps=16 * B, learn_every_k_steps=4,
                          learning_starts=2 * B, seed=0, device=CPU)
    assert res.agent_state.learner.step == 3
    # Two more steps, whose cache writes follow the last learn's refresh.
    bound, venv = agent.for_env(env), VectorEnv(env, B, torch.device(CPU))
    astate, env_states, gen = res.agent_state, res.env_states, torch.Generator().manual_seed(0)
    for _ in range(2):
        astate, choice = bound.act(astate, gen)
        env_states, result, next_obs = venv.step(env_states, choice.action, gen)
        astate = bound.observe(astate, result, next_obs, gen)
    save(str(tmp_path / "visual"), astate)
    back = restore(str(tmp_path / "visual"), astate)
    assert compare(astate, back, rtol=0, atol=0) == ""
    carry = back.history_carry
    fresh = net.refresh_cache(back.learner.params, dataclasses.replace(carry, cache=None))
    assert fresh is not carry.cache
    torch.testing.assert_close(carry.cache, fresh, rtol=0, atol=0)


def test_timed_and_trace(tmp_path):
    x = torch.randn(64, 64)
    seconds = timed(torch.mm, x, x, warmup=1, iters=3)
    assert seconds > 0.0
    with trace(str(tmp_path / "trace")) as prof:
        torch.mm(x, x)
    assert prof is not None
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
