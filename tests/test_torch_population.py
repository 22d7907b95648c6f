"""The port's population training (`training/population.py`) on the CPU, at
the settings of the reference's own tests (`tests/test_population.py`,
`tests/test_checkpoint_population_dp.py`).

JAX's random streams and the port's never agree, so the packages cannot be
held to the same numbers; each test holds the port to the property the
reference's test asserts, at the same settings. Within the port a member is
held to the solo `online_learning` run at its seed exactly (tolerance 0 on
every leaf of the state: the same chunk function on the same state with the
same generator is the same computation on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.envs import CartPole as JaxCartPole
from pearl_tpu.policy_learners.exploration_modules import EGreedyExploration as JaxEGreedy
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.training import population_learning as jax_population_learning
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    DeepQLearning,
    SoftActorCritic,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import online_learning, population_learning
from pearl_tpu_torch.utils import compare
from pearl_tpu_torch.utils.checkpoint import restore, save
from pearl_tpu_torch.utils.pytree import named_leaves

torch.set_num_threads(1)

CPU = "cpu"


def _dqn_agent():
    """tests/test_population.py:16-27's agent."""
    return PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=1,
            batch_size=64,
            exploration=EGreedyExploration(start_epsilon=0.5, end_epsilon=0.05, warmup_steps=4_000),
        ),
        replay_buffer=BasicReplayBuffer(capacity=8_192),
    )


def _jax_dqn_agent():
    return JaxAgent(
        policy_learner=JaxDQN(
            training_rounds=1,
            batch_size=64,
            exploration=JaxEGreedy(start_epsilon=0.5, end_epsilon=0.05, warmup_steps=4_000),
        ),
        replay_buffer=JaxBuffer(capacity=8_192),
    )


SMALL = dict(num_envs=8, max_steps=2_048, learn_every_k_steps=8, learning_starts=256)


def test_population_member_is_the_solo_run_at_its_seed():
    """Member m is the solo `online_learning(stats="summary")` run at seed
    m: every leaf of its state, and its curve, equal bit for bit."""
    pop = population_learning(_dqn_agent(), CartPole(), num_members=2, seeds=[7, 11],
                              device=CPU, **SMALL)
    assert pop.num_members == 2 and pop.return_curves.shape == (2_048 // (8 * 8), 2)
    for i, s in enumerate([7, 11]):
        solo = online_learning(_dqn_agent(), CartPole(), seed=s, stats="summary", device=CPU,
                               **SMALL)
        assert compare(pop.member_state(i), solo.agent_state, rtol=0, atol=0) == ""
        np.testing.assert_array_equal(pop.return_curves[:, i], solo.return_curve)
        assert pop.total_episodes[i] == solo.total_episodes
        assert pop.mean_returns[i] == solo.mean_return
    assert compare(pop.member_state(0), pop.member_state(1)) != ""


def test_population_members_diverge_and_learn():
    """tests/test_population.py:53-75 at its settings (4 members, 16 envs,
    40000 steps each), with the JAX package's population at the same
    settings printed beside the port's."""
    kw = dict(num_members=4, num_envs=16, max_steps=40_000, learn_every_k_steps=4,
              learning_starts=1_000, seed=3)
    pop = population_learning(_dqn_agent(), CartPole(), device=CPU, **kw)
    ref = jax_population_learning(_jax_dqn_agent(), JaxCartPole(), **kw)
    for name, p in (("jax", ref), ("port", pop)):
        early = p.return_curves[: max(len(p.return_curves) // 10, 1)].mean(axis=0)
        print(f"{name}: early {np.round(early, 2).tolist()}, recent "
              f"{np.round(p.recent_returns, 2).tolist()}")
    assert pop.return_curves.shape == ref.return_curves.shape == (625, 4)
    assert (pop.total_episodes > 0).all()
    p0 = next(pop.member_state(0).learner.params.parameters())
    p1 = next(pop.member_state(1).learner.params.parameters())
    assert not torch.allclose(p0, p1)
    early = pop.return_curves[: max(len(pop.return_curves) // 10, 1)].mean(axis=0)
    assert (pop.recent_returns > early).all(), (early, pop.recent_returns)
    assert pop.recent_returns.mean() > 2.0 * early.mean()


def test_population_shared_ring_cursor_gives_the_same_states():
    """tests/test_population.py:78-103: the argument selects a layout in JAX
    only; both values give the same states here, cursors included."""
    kw = dict(num_members=2, seeds=[3, 9], device=CPU, **SMALL)
    fast = population_learning(_dqn_agent(), CartPole(), shared_ring_cursor=True, **kw)
    slow = population_learning(_dqn_agent(), CartPole(), shared_ring_cursor=False, **kw)
    assert compare(fast.agent_states, slow.agent_states, rtol=0, atol=0) == ""
    assert [s.replay.cursor for s in fast.agent_states] == [
        s.replay.cursor for s in slow.agent_states
    ]


def test_population_shared_ring_cursor_checks_the_cursors_agree():
    """With shared_ring_cursor on, members whose rings stand at different
    cursors are an error (the reference's layout would silently give them
    one cursor)."""

    def skew(indices, states):
        states[1] = dataclasses.replace(
            states[1], replay=dataclasses.replace(states[1].replay, cursor=8)
        )
        return states

    with pytest.raises(ValueError, match="member 1's ring"):
        population_learning(_dqn_agent(), CartPole(), num_members=2, seeds=[3, 9],
                            shared_ring_cursor=True, member_state_transform=skew, device=CPU,
                            **SMALL)


def test_population_target_stops_when_all_members_reach():
    """tests/test_population.py:106-125: the stop fires only on a chunk row
    where every member is at the target."""
    pop = population_learning(_dqn_agent(), CartPole(), num_members=2, num_envs=16,
                              max_steps=60_000, learn_every_k_steps=4, learning_starts=1_000,
                              seed=0, target_return=15.0, device=CPU)
    assert pop.reached_target
    assert pop.total_steps < 60_000
    assert (pop.return_curves.max(axis=0) >= 15.0).all()


def test_population_state_resident_learning_rate_sweep():
    """tests/test_population.py:128-170: discrete SAC's actor learning rate
    (a tensor in the actor optimizer's param group) set per member at one
    seed; the members stay distinct and finite."""
    agent = PearlAgent(
        policy_learner=SoftActorCritic(training_rounds=1, batch_size=32),
        replay_buffer=BasicReplayBuffer(capacity=2_048),
    )
    lrs = torch.tensor([1e-4, 1e-3, 1e-2])

    def set_lrs(member_indices, states):
        assert member_indices.tolist() == [0, 1, 2]
        for m, state in zip(member_indices.tolist(), states):
            state.learner.actor_opt.param_groups[0]["lr"].fill_(lrs[m])
        return states

    pop = population_learning(agent, CartPole(), num_members=3, seeds=[5, 5, 5],
                              member_state_transform=set_lrs, device=CPU, **SMALL)
    a = [next(pop.member_state(i).learner.actor_params.parameters()) for i in range(3)]
    assert not torch.allclose(a[0], a[1])
    assert not torch.allclose(a[1], a[2])
    # Decayed in place per finished episode, from each member's own rate.
    got = [float(s.learner.actor_opt.param_groups[0]["lr"]) for s in pop.agent_states]
    assert got[0] < got[1] < got[2] and got[2] < 1e-2
    for state in pop.agent_states:
        for _, leaf in named_leaves(state.learner):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                assert torch.isfinite(leaf).all()


def test_population_checkpoint_roundtrip_and_solo_resume(tmp_path):
    """tests/test_checkpoint_population_dp.py:34-62: the population's states
    round-trip exactly; the best member round-trips and continues solo
    through `online_learning(agent_state=...)`, its learner's step counter
    advancing."""
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=16),
        replay_buffer=BasicReplayBuffer(capacity=256),
    )
    res = population_learning(agent, CartPole(), num_members=3, num_envs=4, max_steps=512,
                              learn_every_k_steps=4, seed=0, device=CPU)
    save(str(tmp_path / "pop"), res.agent_states)
    loaded = restore(str(tmp_path / "pop"), res.agent_states)
    assert compare(res.agent_states, loaded, rtol=0, atol=0) == ""

    best = int(np.argmax(res.recent_returns))
    member = res.member_state(best)
    save(str(tmp_path / "best"), member)
    member_loaded = restore(str(tmp_path / "best"), member)
    assert compare(member, member_loaded, rtol=0, atol=0) == ""
    # The restored optimizer steps the restored network.
    opt_params = member_loaded.learner.optimizer.param_groups[0]["params"]
    assert all(a is b for a, b in zip(opt_params, member_loaded.learner.params.parameters()))
    before = [p.clone() for p in member_loaded.learner.params.parameters()]
    cont = online_learning(agent, CartPole(), num_envs=4, max_steps=256, learn_every_k_steps=4,
                           seed=9, agent_state=member_loaded, device=CPU)
    assert cont.total_steps == 256
    assert cont.agent_state.learner.step > res.agent_states[best].learner.step
    after = list(cont.agent_state.learner.params.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
