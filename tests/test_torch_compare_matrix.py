"""`compare` over every registry row's state and each module family's, on
the port (`tests/test_compare_semantics.py` on the JAX package): a state
equals a twin, and one changed leaf is found and named, alone, wherever it
is: in the learner (each of its fields), the replay, the history carry, the
safety module, the last action, the availability mask. Integer, bool and
generator leaves compare exactly, float leaves within the tolerance.

A port state holds modules, optimizers and generators updated in place, so
a changed copy shares every leaf but the changed one (`_perturb_first`):
a module or an optimizer on that path is copied whole, a generator drawn
from once."""

import copy
import dataclasses
import re

import pytest
import torch
from torch import nn

from pearl_tpu_torch.benchmarks.configs import METHODS
from pearl_tpu_torch.benchmarks.guarantees import env_for_method
from pearl_tpu_torch.envs import VectorEnv
from pearl_tpu_torch.utils import compare, tree_allclose
from pearl_tpu_torch.utils.pytree import walk_leaves

torch.set_num_threads(1)

CPU = torch.device("cpu")
_AGENT_GROUPS = ("safety", "replay", "history_carry", "last_action", "available_mask")


def _init_state(method, num_envs=2):
    agent = method.make_agent(num_envs)
    env = env_for_method(method, agent)
    bound = agent.for_env(env)
    venv = VectorEnv(env, num_envs, CPU)
    _, obs = venv.reset(torch.Generator().manual_seed(0))
    return bound.init(1, venv.observation_dim, num_envs, obs, device=CPU)


def _changed(leaf, floats_only):
    """The leaf changed (float +1, integer +1, bool flipped, a generator
    one draw ahead), or None where it is not to be changed."""
    if isinstance(leaf, torch.Tensor):
        if leaf.is_floating_point():
            return leaf + 1.0
        if floats_only:
            return None
        return ~leaf if leaf.dtype == torch.bool else leaf + 1
    if isinstance(leaf, torch.Generator):
        if floats_only:
            return None
        ahead = copy.deepcopy(leaf)
        torch.rand(1, generator=ahead, device=ahead.device)
        return ahead
    if isinstance(leaf, float) or (isinstance(leaf, (bool, int)) and not floats_only):
        return (not leaf) if isinstance(leaf, bool) else leaf + 1
    return None


@torch.no_grad()
def _perturb_first(tree, prefix="", floats_only=False):
    """(a copy of `tree` with its first leaf in `walk_leaves` order changed,
    that leaf's name), or None if no leaf can change; the other leaves are
    shared with `tree`."""
    if isinstance(tree, (nn.Module, torch.optim.Optimizer)):
        tree = copy.deepcopy(tree)
        for name, leaf in walk_leaves(tree, prefix):
            new = _changed(leaf, floats_only)
            if new is None:
                continue
            if isinstance(leaf, torch.Tensor):  # a state_dict tensor is the module's own
                leaf.copy_(new)
            else:  # an optimizer's hyperparameter
                group, key = re.fullmatch(r".*\.param_groups\[(\d+)\]\.(\w+)", name).groups()
                tree.param_groups[int(group)][key] = new
            return tree, name
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out = _perturb_first(getattr(tree, f.name), f"{prefix}.{f.name}", floats_only)
            if out is not None:
                new = copy.copy(tree)
                object.__setattr__(new, f.name, out[0])
                return new, out[1]
        return None
    if isinstance(tree, dict):
        for k, v in tree.items():
            out = _perturb_first(v, f"{prefix}[{k!r}]", floats_only)
            if out is not None:
                return {**tree, k: out[0]}, out[1]
        return None
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out = _perturb_first(v, f"{prefix}[{i}]", floats_only)
            if out is not None:
                items = list(tree)
                items[i] = out[0]
                return type(tree)(items), out[1]
        return None
    new = _changed(tree, floats_only)
    return None if new is None else (new, prefix)


def _groups(state):
    """(label, subtree, rebuild) for each learner field and agent group."""
    out = []
    for f in dataclasses.fields(state.learner):
        def rebuild(sub, name=f.name):
            learner = copy.copy(state.learner)
            object.__setattr__(learner, name, sub)
            return dataclasses.replace(state, learner=learner)

        out.append((f".learner.{f.name}", getattr(state.learner, f.name), rebuild))
    for name in _AGENT_GROUPS:
        out.append((f".{name}", getattr(state, name),
                    lambda sub, name=name: dataclasses.replace(state, **{name: sub})))
    return out


def check_single_divergent_leaf(name, method):
    """A fresh state (2 envs) equals its twin; its learner's first float
    leaf changed is found, named and alone."""
    state = _init_state(method)
    twin = copy.deepcopy(state)
    assert compare(state, twin) == "", name
    assert tree_allclose(state, twin), name
    learner, leaf = _perturb_first(state.learner, ".learner", floats_only=True)
    changed = dataclasses.replace(state, learner=learner)
    diff = compare(state, changed)
    assert diff.startswith(leaf + ":") and ";" not in diff, (name, leaf, diff)
    assert not tree_allclose(state, changed), name


def check_every_state_group(name, method):
    """Each learner field and each agent group the row has, changed one at a
    time: exactly the changed leaf is reported. Every row has at least its
    trainable params, their optimizer, the replay, the history carry and
    the last action; a row with a cost (a safety state) or an ε schedule
    has those too."""
    state = _init_state(method)
    exercised = []
    for label, sub, rebuild in _groups(state):
        out = _perturb_first(sub, label)
        if out is None:
            continue  # an empty group for this row (e.g. no safety state)
        changed, leaf = out
        diff = compare(state, rebuild(changed))
        assert diff.startswith(leaf + ":") and ";" not in diff, (name, label, leaf, diff)
        exercised.append(label)
    for label in (".replay", ".history_carry", ".last_action"):
        assert label in exercised, (name, exercised)
    assert any(g.endswith(("_opt", "optimizer")) for g in exercised), (name, exercised)
    assert any(g.endswith("params") for g in exercised), (name, exercised)
    if method.make_agent(2).store_cost:
        assert ".safety" in exercised, (name, exercised)
    if isinstance(getattr(state.learner, "explore_state", None), int):  # an ε schedule's count
        assert ".learner.explore_state" in exercised, (name, exercised)


@pytest.mark.parametrize("name", sorted(METHODS.keys()))
def test_agent_state_compare_detects_single_divergent_leaf(name):
    check_single_divergent_leaf(name, METHODS[name])


@pytest.mark.parametrize("name", sorted(METHODS.keys()))
def test_compare_matrix_every_state_group(name):
    check_every_state_group(name, METHODS[name])


def test_replay_state_compare_detects_push():
    """A push writes the ring in place: the state before it (a copy) and
    after it differ in the rewards and in the cursor and size."""
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch

    def batch(reward):
        return TransitionBatch(
            state=torch.zeros((4, 3)), action=torch.zeros((4, 1)),
            reward=torch.full((4,), reward), next_state=torch.zeros((4, 3)),
            terminated=torch.zeros((4,), dtype=torch.bool),
            truncated=torch.zeros((4,), dtype=torch.bool),
            action_index=torch.zeros((4,), dtype=torch.int32),
        )

    buf = BasicReplayBuffer(capacity=16)
    s0 = buf.init(batch(0.0))
    before = copy.deepcopy(s0)
    s1 = buf.push(s0, batch(1.0), torch.Generator().manual_seed(0))
    assert compare(before, before) == ""
    diff = compare(before, s1)
    assert ".storage.reward:" in diff and ".cursor:" in diff and ".size:" in diff, diff


def test_rc_safety_state_compare_detects_lambda():
    """The reward-constrained module's multiplier lambda, and the first
    float leaf of its state (its cost critic)."""
    from pearl_tpu_torch.api.spaces import BoxActionSpace
    from pearl_tpu_torch.safety_modules.reward_constrained import (
        RCSafetyModuleCostCriticContinuousAction,
    )

    mod = RCSafetyModuleCostCriticContinuousAction(constraint_value=0.1)
    space = BoxActionSpace.create(-torch.ones(1), torch.ones(1))
    st = mod.init(torch.Generator().manual_seed(0), 3, space, 2, CPU)
    assert compare(st, copy.deepcopy(st)) == ""
    bumped = dataclasses.replace(st, lagrangian=st.lagrangian + 1e-3)
    assert compare(st, bumped).startswith(".lagrangian: max abs diff 1.000e-03"), compare(st, bumped)
    changed, leaf = _perturb_first(st)
    diff = compare(st, changed)
    assert diff.startswith(leaf + ":") and ";" not in diff, (leaf, diff)


def test_linear_bandit_state_compare_detects_sufficient_stats():
    """A LinearBandit's float64 A and b: a change in either is named."""
    from pearl_tpu_torch.api.spaces import DiscreteActionSpace
    from pearl_tpu_torch.policy_learners.contextual_bandits import LinearBandit

    space = DiscreteActionSpace.create(torch.eye(2))
    lb = LinearBandit().bind(space)
    st = lb.init(torch.Generator().manual_seed(0), 2, space, 1, CPU)
    changed, leaf = _perturb_first(st, floats_only=True)
    assert leaf == ".model.A", leaf
    assert compare(st, changed).startswith(".model.A:"), compare(st, changed)
    model = dataclasses.replace(st.model, b=st.model.b + 1e-3)
    diff = compare(st, dataclasses.replace(st, model=model))
    assert diff.startswith(".model.b:") and ";" not in diff, diff


def test_history_carry_compare_detects_window_content():
    """LSTM summarizer windows: the same window compares clean, one observed
    step diverges them, and resetting every env restores the zero window."""
    from pearl_tpu_torch.history_summarization_modules import LSTMHistorySummarization

    summ = LSTMHistorySummarization(history_length=4, hidden_dim=8)
    c0 = summ.init_carry(2, 3, 2, CPU)
    c1 = summ.observe(c0, torch.ones((2, 3)), torch.ones((2, 2)))
    assert compare(c0, c0.clone()) == ""
    assert compare(c0, c1) != ""
    c2 = summ.reset_envs(c1, torch.tensor([True, True]))
    assert compare(c0, c2) == ""


def test_epsilon_schedule_state_compare():
    """The DQN row's ε schedule counts env steps in its exploration state
    and the learner counts its learn steps: both are host integers, compared
    exactly, and a step's difference is named."""
    state = _init_state(METHODS["DQN"])
    learner = state.learner
    for field in ("explore_state", "step"):
        value = getattr(learner, field)
        assert type(value) is int, (field, value)
        stepped = dataclasses.replace(state, learner=dataclasses.replace(
            learner, **{field: value + 1}))
        assert compare(state, stepped) == f".learner.{field}: {value!r} vs {value + 1!r}"


def test_integers_and_bools_compare_exactly_floats_within_the_tolerance():
    """An int32 leaf of 2**30 off by one and a flipped bool are reported (a
    relative tolerance would swallow the first); a float leaf moved by less
    than rtol 1e-5 / atol 1e-7 is not, and one moved by more is."""
    state = _init_state(METHODS["DQN"])
    storage = state.replay.storage

    def with_storage(**fields):
        replay = dataclasses.replace(state.replay,
                                     storage=dataclasses.replace(storage, **fields))
        return dataclasses.replace(state, replay=replay)

    big = torch.full_like(storage.action_index, 2**30)
    bumped = big.clone()
    bumped[0] += 1
    assert compare(with_storage(action_index=big), with_storage(action_index=bumped)) == (
        ".replay.storage.action_index: integer/bool leaves differ")
    flipped = storage.terminated.clone()
    flipped[-1] = ~flipped[-1]
    assert compare(state, with_storage(terminated=flipped)) == (
        ".replay.storage.terminated: integer/bool leaves differ")
    reward = torch.full_like(storage.reward, 100.0)
    assert compare(with_storage(reward=reward), with_storage(reward=reward * (1 + 1e-6))) == ""
    diff = compare(with_storage(reward=reward), with_storage(reward=reward * (1 + 1e-4)))
    assert diff.startswith(".replay.storage.reward: max abs diff"), diff
